"""The port's ``scripts/bench_highdim.py`` on the CPU at a tiny depth: every
row of the JAX script's panda and quadrotor protocol runs through the plain
versions (one replan, one episode per rate, one repetition) and prints its
line with the JAX script's keys; the report stays out of ``artifacts/``."""
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu_torch.scripts import bench_highdim

torch.set_num_threads(1)

ROWS = ["panda_rbd_closed_loop_hz_xla", "panda_rbd_sustained_hz_xla",
        "panda_rbd_fused_chain_hz_fp32", "panda_rbd_fused_chain_hz_bf16",
        "panda_rbd_whole_episode_kernel_hz", "quadrotor_closed_loop_hz_unguided",
        "quadrotor_closed_loop_hz_guided", "quadrotor_sustained_hz_guided"]


def test_bench_highdim_rows_on_cpu(tmp_path):
    out = bench_highdim.main(["--device", "cpu", "--steps", "1", "--sustained-steps", "1",
                              "--rate-episodes", "1", "--rate-batches", "1",
                              "--sustained-reps", "1", "--out", str(tmp_path / "bench.json")])
    rows = {r["metric"]: r for r in out["rows"]}
    assert list(rows) == ROWS and out["card"] == "cpu"
    assert all(r["value"] > 0 and r["unit"] == "Hz" and r["card"] == "cpu" for r in rows.values())
    for name, entry in (("panda_rbd_fused_chain_hz_fp32", "cfg_chain_turns"),
                        ("panda_rbd_fused_chain_hz_bf16", "cfg_chain_turns_bf16"),
                        ("panda_rbd_whole_episode_kernel_hz", "cfg_episode_panda_draw")):
        r = rows[name]
        assert (r["entry"], r["plan"]) == (entry, "turns") and len(r["costs"]) == 10
        assert np.isfinite(r["cost_mean10"]) and r["within_yardstick"] is None  # not 80 replans
    assert rows["panda_rbd_whole_episode_kernel_hz"]["pipelined"] > 0
    assert (tmp_path / "bench.json").exists()


def test_bench_highdim_reports_outside_artifacts():
    root = Path(bench_highdim.__file__).resolve().parents[2]
    with pytest.raises(SystemExit, match="not artifacts/"):
        bench_highdim.main(["--out", str(root / "artifacts" / "flagship_panda_rbd" / "b.json"),
                            "--device", "cpu"])
