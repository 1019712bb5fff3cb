"""Times the CFG episode kernel's cut of the conv work inside a CTA against
alternatives, on the card.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.episode_recut [--replans 80] [--reps 3]

``csrc/unet_body_cluster.cuh`` gives each CTA of the cluster 256 outputs of
every conv of the flagship (rows x its eighth of the channels) for 512
threads. A work item is ``CL_RPT`` rows of one channel, and its reduction
over k * C_in inputs is split over up to ``CL_SPLIT`` lanes (as many as the
512 threads allow), summed with shuffles. Each other cut here is a copy of
``csrc/`` under ``build/episode_recut/<cut>/`` with other values of the two,
made by text substitution of the committed header (the script raises when a
``#define`` it edits is not found as written), built with the port's flags,
one nvcc each, all at once; the first cut is the kernel the port runs. Each
runs the flagship's K = 1 episode from x0 = [0, 0, 3.0, 0, theta*(3.0)] with
``bench.py``'s synthetic limits on one draw of staged noise: its tracks
against the port's kernel's (atol = rtol = 1e-3, chip_smoke.py's TRACK_TOL;
the cuts sum in other orders), then ms per replan by CUDA events, the cuts
in turns and back. Prints one JSON line per cut, then nvidia-smi's name and
power limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..core import make_schedule
from ..data import NormalizerStats
from ..dynamics import cartpole_virtual_cost, cartpole_virtual_swingup, theta_to_red_theta
from ..models import load_flagship
from ..ops import _build
from ..ops.fused_episode import make_fused_cfg_episode
from ..utils.device import resolve_device
from .episode_profile import _sub, build_copy, launch_copy

ARTIFACTS = Path(__file__).resolve().parents[2] / "artifacts" / "flagship"
TRACK_TOL = 1e-3
DEFAULTS = {"CL_RPT": 8, "CL_SPLIT": 32}  # as unet_body_cluster.cuh defines them
# name -> the settings its copy changes; the first is the port's own kernel
CUTS = {
    "rows8_split": {},
    "rows4_split": {"CL_RPT": 4},
    "rows16_split": {"CL_RPT": 16},
    "rows1_split": {"CL_RPT": 1},
    "rows8_one_lane": {"CL_SPLIT": 1},
}


def recut(csrc: Path, out: Path, settings: Dict[str, int]) -> None:
    """Copies ``csrc`` to ``out`` with ``settings`` (name -> value) in place
    of ``DEFAULTS``' values in ``unet_body_cluster.cuh``."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    h = (out / "unet_body_cluster.cuh").read_text()
    for name, value in settings.items():
        h = _sub(h, f"#define {name} {DEFAULTS[name]}  //", f"#define {name} {value}  //")
    (out / "unet_body_cluster.cuh").write_text(h)


def _ms_per_replan(fn, n_steps: int, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps / n_steps


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--replans", type=int, default=80)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    dev = resolve_device(None)  # raises without a card: the cuts are timed on it
    own, *others = CUTS
    for name in others:
        recut(_build.CSRC, _build.BUILD_DIR.parent / "episode_recut" / name, CUTS[name])
    with concurrent.futures.ThreadPoolExecutor(len(CUTS)) as pool:  # one nvcc per cut at once
        port = pool.submit(_build.build, "cfg_episode")
        copies = dict(zip(others, pool.map(
            lambda n: build_copy(_build.BUILD_DIR.parent / "episode_recut" / n), others)))
        reports = {own: port.result().report, **{n: r for n, (_, r) in copies.items()}}
    ins = NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0))
    cs = NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0))
    ep = make_fused_cfg_episode(load_flagship(ARTIFACTS / "ema_params.pkl", device=dev),
                                make_schedule("exponential", 25), ins, cs,
                                cartpole_virtual_swingup(), cartpole_virtual_cost(),
                                n_steps=args.replans, w=0.01, n_diffusion_steps_without_noise=5,
                                device=dev)
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    noise = torch.randn(ep.noise_shape, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    noise_tab = ep._noise_tab(noise[None])
    run = {own: lambda: ep.kernel(x0, noise),
           **{n: (lambda lib=lib: tuple(o[0] for o in launch_copy(ep, lib, x0[None], noise_tab)))
              for n, (lib, _) in copies.items()}}
    ref = run[own]()
    rows = {}
    for name in CUTS:
        got = run[name]()
        torch.cuda.synchronize()
        err = max((g.double() - r.double()).abs().max().item() for g, r in zip(got[:3], ref[:3]))
        for g, r in zip(got[:3], ref[:3]):
            torch.testing.assert_close(g, r, atol=TRACK_TOL, rtol=TRACK_TOL, msg=name)
        regs = [line.strip() for line in reports[name].splitlines() if "registers" in line]
        rows[name] = {"cut": name, "settings": {**DEFAULTS, **CUTS[name]},
                      "max_abs_err_vs_default": err, "ptxas": regs, "ms_per_replan": []}
    for order in (list(CUTS), list(CUTS)[::-1]):  # in turns and back
        for name in order:
            rows[name]["ms_per_replan"].append(_ms_per_replan(run[name], args.replans, args.reps))
    for row in rows.values():
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return list(rows.values())


if __name__ == "__main__":
    main()
