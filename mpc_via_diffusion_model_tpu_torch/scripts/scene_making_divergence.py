"""How far the port's making half and toy ``onpolicy_scene`` may part from the
JAX package's on the CPU (``data/scene_making_yardstick.py``,
``data/onpolicy_scene_yardstick.py``), measured with the port on the CPU
before any run on the card:

    python -m mpc_via_diffusion_model_tpu_torch.scripts.scene_making_divergence \\
        [--seeds 0 1 2 3 4] [--threads 2] [--dir build/scene_making_divergence] \\
        [--out PATH.json] [--merge A.json B.json ...]

For each torch seed s the port runs ``scene_conditioned_quadrotor --make
--quick --no-teacher-rows --seed s`` on the CPU (the plain versions of the
kernels), then ``onpolicy_scene`` at the yardstick's toy size
(``TOY_ARGS``) with ``--seed s`` on that run's output directory. The port
draws every number from torch generators, so its rows, draws and noise
differ from JAX's in any case; the seeds give the spread. It prints each
run's numbers and their gaps from the yardsticks, then ``bounds``: twice
the largest gap of each number over all runs, a fraction's at least 2 of its
count (the collected pairs' at least 2). ``--merge`` computes the bounds
from the ``--out`` files of runs made apart (one process per seed). A seed
takes ~6 minutes at one thread.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

import torch

from ..data import onpolicy_scene_yardstick as oys
from ..data import scene_making_yardstick as mys
from . import onpolicy_scene, scene_conditioned_quadrotor as scq

__all__ = ["run", "bounds", "main"]

ROOT = Path(__file__).resolve().parents[2]
MAKING_KEYS = ("n_kept", "keep_fraction", "kept_clearance_mean", "first_losses", "final_loss")
# a fraction's bound is at least 2 of its count
COUNTS = {"keep_fraction": scq.QUICK["n_sample_chunks"] * scq.QUICK["chunk_rows"],
          "scene_conditioned_student": scq.QUICK["eval_scenes"] * scq.QUICK["eval_starts"],
          "scene_conditioned_student_k4": scq.QUICK["eval_scenes"] * scq.QUICK["eval_starts"],
          "canonical_scene_student": scq.QUICK["eval_starts"]}


def run(seed: int, work: Path) -> dict:
    """One seed's numbers: the making half's (``making``), the made
    student's rows (``rows``) and the toy's collected pairs and rows
    (``toy``)."""
    d = work / f"seed{seed}"
    rep = scq.main(["--make", "--quick", "--no-teacher-rows", "--cpu", "--seed", str(seed),
                    "--out", str(d / "report.json")])
    making = {"n_kept": rep["n_kept"], "final_loss": rep["final_loss"],
              **{m: rep["making"][m] for m in ("keep_fraction", "kept_clearance_mean",
                                               "first_losses")}}
    rows = dict(rep["held_out"], canonical_scene_student=rep["canonical_scene_student"])
    toy = onpolicy_scene.main(["--cpu", "--seed", str(seed), "--scene-dir", str(d), "--out",
                               str(d / "toy"), *oys.TOY_ARGS])
    return {"seed": seed, "making": making,
            "rows": {r: {m: rows[r][m] for m in oys.METRICS_KEYS} for r in mys.ROWS},
            "toy": {"pairs": toy["iterations"][0]["pairs"],
                    "rows": {f"{r['student']}_k{r['K']}": {m: r[m] for m in oys.METRICS_KEYS}
                             for r in toy["rows"]}}}


def _frac_floor(metric: str, count: int) -> float:
    return 2 / count if "fraction" in metric else 0.0


def bounds(records: List[dict]) -> dict:
    """The largest gaps of the records from the yardsticks' literals, and
    the bounds: twice those, a fraction's at least 2 of its count."""
    worst: Dict[str, Dict[str, float]] = {"making": {}}
    for rec in records:
        for m in ("keep_fraction", "kept_clearance_mean", "first_losses", "final_loss"):
            got, want = rec["making"][m], mys.MAKING[m]
            g = (max(abs(a - b) for a, b in zip(got, want)) if m == "first_losses"
                 else abs(got - want))
            worst["making"][m] = max(worst["making"].get(m, 0.0), g)
        for row in mys.ROWS:
            w = worst.setdefault(row, {})
            for m in oys.METRICS_KEYS:
                w[m] = max(w.get(m, 0.0), abs(rec["rows"][row][m] - mys.METRICS[row][m]))
    making_bounds = {part: {m: max(2 * g, _frac_floor(m, COUNTS.get(m, COUNTS.get(part, 1))))
                            for m, g in w.items()} for part, w in worst.items()}
    t_worst: Dict[str, Dict[str, float]] = {"pairs": {"pairs": 0.0}}
    n_pairs = int(oys.TOY_ARGS[oys.TOY_ARGS.index("--eval-scenes") + 1]) * int(
        oys.TOY_ARGS[oys.TOY_ARGS.index("--eval-starts") + 1])
    for rec in records:
        t_worst["pairs"]["pairs"] = max(t_worst["pairs"]["pairs"],
                                        abs(rec["toy"]["pairs"] - oys.PAIRS))
        for row in oys.ROWS:
            w = t_worst.setdefault(row, {})
            for m in oys.METRICS_KEYS:
                w[m] = max(w.get(m, 0.0), abs(rec["toy"]["rows"][row][m] - oys.METRICS[row][m]))
    toy_bounds = {part: {m: max(2 * g, 2.0 if m == "pairs" else _frac_floor(m, n_pairs))
                         for m, g in w.items()} for part, w in t_worst.items()}
    return {"making": {"worst_gaps": worst, "bounds": making_bounds},
            "onpolicy": {"worst_gaps": t_worst, "bounds": toy_bounds}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--dir", default=str(ROOT / "build" / "scene_making_divergence"))
    p.add_argument("--out", default=None)
    p.add_argument("--merge", nargs="+", default=None,
                   help="no runs: the bounds over these --out files' records")
    args = p.parse_args(argv)
    if args.merge:
        records = [r for path in args.merge for r in json.loads(Path(path).read_text())["runs"]]
    else:
        torch.set_num_threads(args.threads)
        records = []
        for seed in args.seeds:
            records.append(run(seed, Path(args.dir)))
            print(json.dumps(records[-1]), flush=True)
    result = {"runs": records}
    if mys.MAKING and oys.METRICS:
        result["bounds"] = bounds(records)
        print(json.dumps(result["bounds"], indent=1), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
