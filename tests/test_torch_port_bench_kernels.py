"""The port's ``bench_kernels`` (scripts/bench_kernels.py) and its timing
harness (eval/timing.py) on the CPU: ``--device cpu --quick`` at a cut conv
shape list and a 2-replan episode runs every plain twin and prints rows with
the JAX script's keys, ``kernel_us`` and ``max_abs_err`` null."""
import json

import pytest
import torch

from mpc_via_diffusion_model_tpu_torch.eval import Timer, pipelined_time_fn, time_fn
from mpc_via_diffusion_model_tpu_torch.scripts import bench_kernels

# Tiny tensors: torch's intra-op threads cost more than they save, and the
# suite runs several test processes at once.
torch.set_num_threads(1)

ROUND2 = ["unet_forward", "cfg_chain_30step", "ddim_chain_3eval", "cfg_episode_80step"]
PANDA = ["unet_forward", "cfg_chain_30step", "ddim_chain_3eval"]


@pytest.mark.parametrize("skip_conv", [False, True])
def test_bench_kernels_cpu_quick_rows(monkeypatch, capsys, skip_conv):
    monkeypatch.setattr(bench_kernels, "CONV_SHAPES", [(2, 8, 1, 8), (2, 8, 4, 12)])
    monkeypatch.setattr(bench_kernels, "PRE_BIAS_SHAPE", (2, 8, 4, 8))
    monkeypatch.setattr(bench_kernels, "N_STEPS", 2)
    argv = ["--device", "cpu", "--quick"] + (["--skip-conv"] if skip_conv else [])
    rows = bench_kernels.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu"
    assert [json.loads(line) for line in lines[1:]] == rows
    conv_rows = [] if skip_conv else rows[:3]
    assert [r["kernel"] for r in rows] == ["conv1d_gn_mish"] * len(conv_rows) + ROUND2 + PANDA
    rows, panda = rows[:-len(PANDA)], rows[-len(PANDA):]
    # the panda rows: the CFG chain on the teacher in turns at horizon 128, the others on the
    # student's one-row-set plan
    assert all(r["config"] == "panda_h128_7ch_ctx20" and r["rows"] == 256 for r in panda)
    assert (panda[1]["plan"], panda[1]["smem_bytes"], panda[1]["model"]) == (
        "turns", 158_348, "flagship_panda_rbd")
    for r in panda:
        assert r["plain_us"] > 0 and r["kernel_us"] is None and r["max_abs_err"] is None
    for r in (panda[0], panda[2]):
        assert r["smem_bytes"] == 154_764
    for r in conv_rows:
        assert {"shape", "groups", "pre_bias", "torch_seq_us", "torch_seq_max_abs_err"} <= set(r)
        assert r["torch_seq_max_abs_err"] <= r["tol"] and r["torch_seq_us"] > 0
    assert [r["groups"] for r in conv_rows] == ([8, 1, 8] if conv_rows else [])
    assert [r["pre_bias"] for r in conv_rows] == ([False, False, True] if conv_rows else [])
    for r in rows:
        assert r["device"] == "cpu" and r["kernel_us"] is None and r["max_abs_err"] is None
        assert r["plain_us"] > 0 and r["launches"] == 0 and r["reps"][1] == 1
    for r in rows[len(conv_rows):]:
        assert r["config"] == "flagship_h32_1ch_ctx5" and r["rows"] == 64
    assert rows[-1]["plain_reps"] == 1 and rows[-1]["n_steps"] == 2


def test_bench_kernels_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_kernels.main(["--quick"])


def test_timing_harness_counts_its_calls():
    calls = []
    fn = lambda a: calls.append(a)
    assert pipelined_time_fn(fn, [(1,), (2,)], n_batches=3) >= 0
    assert calls == [1] + [1, 2] * 3  # one warmup, then each batch
    calls.clear()
    stats = time_fn(fn, 7, n_warmup=2, n_repeat=4)
    assert calls == [7] * 6 and stats["n"] == 4
    assert 0 <= stats["min_s"] <= stats["median_s"] and stats["min_s"] <= stats["mean_s"]
    with Timer() as t:
        pass
    assert t.elapsed >= 0
