"""Compares the machine code (SASS) of the port's kernels built from this
checkout with the same kernels built from another checkout, on a machine
with the CUDA toolkit.

    python3 mpc_via_diffusion_model_tpu_torch/scripts/sass_diff.py --root build/parent [NAME ...]

Run as a file, from the repository root. Builds ``ops/csrc/<NAME>.cu`` (the
five cluster kernels by default) in this checkout and in the one at
``--root`` (for example a parent commit unpacked by ``git archive``), each
with its own ``ops/_build.py`` in a process of its own, both at once; dumps
each library with ``cuobjdump -sass``; and prints one JSON line per kernel
of this checkout: its instruction count, the other checkout's kernel of the
same mangled name or, where it has none, of the same base name
(``cfg_chain_kernel`` for every instantiation of the template), its count,
whether the two are identical (addresses stripped) and how many
instructions differ position by position. It shows whether a
change to a shared source left a kernel's compiled code as it was.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
CLUSTER_KERNELS = ("cfg_chain", "fused_unet", "cfg_episode", "ddim_chain", "ddim_episode")


def build(tree: Path, names) -> Dict[str, str]:
    """Builds ``names`` with the port of the checkout at ``tree``; returns name -> library path."""
    code = ("import json, sys; sys.path.insert(0, %r); "
            "from mpc_via_diffusion_model_tpu_torch.ops import _build; "
            "print(json.dumps({k: str(v.path) for k, v in _build.build_all(%r).items()}))"
            % (str(tree), tuple(names)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tree,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"build in {tree} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def parse_sass(text: str) -> Dict[str, List[str]]:
    """``cuobjdump -sass`` output -> kernel name -> its instructions, addresses
    and encodings stripped."""
    kernels, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = kernels.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if current is not None and m:
            current.append(m.group(1))
    return kernels


def base_name(mangled: str) -> str:
    """The kernel's name without its template arguments and parameter types:
    ``_Z16cfg_chain_kernelIfEv...`` -> ``cfg_chain_kernel``."""
    m = re.match(r"_Z(\d+)(\w+)", mangled)
    return m.group(2)[:int(m.group(1))] if m else mangled


def compare(ours: Dict[str, List[str]], theirs: Dict[str, List[str]]) -> List[dict]:
    """One row per kernel of ``ours`` against ``theirs``' kernel of the same
    mangled name (each instantiation of a template against its own), else
    of the same base name."""
    by_base = {base_name(k): v for k, v in theirs.items()}
    rows = []
    for name, code in ours.items():
        other = theirs.get(name, by_base.get(base_name(name)))
        row = {"kernel": name, "instructions": len(code)}
        if other is not None:
            row.update(other_instructions=len(other), identical=code == other,
                       differ_in_place=sum(a != b for a, b in zip(code, other)))
        rows.append(row)
    return rows


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True, help="the other checkout's root")
    p.add_argument("names", nargs="*", default=list(CLUSTER_KERNELS))
    args = p.parse_args(argv)
    trees = (ROOT, Path(args.root).resolve())
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ours, theirs = pool.map(lambda t: build(t, args.names), trees)
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    dump = lambda path: parse_sass(subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                                                  text=True, timeout=300, check=True).stdout)
    rows = []
    for name in args.names:
        for row in compare(dump(ours[name]), dump(theirs[name])):
            rows.append({"source": name, **row})
            print(json.dumps(rows[-1]), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return rows


if __name__ == "__main__":
    main()
