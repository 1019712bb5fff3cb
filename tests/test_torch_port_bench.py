"""The port's bench (``mpc_via_diffusion_model_tpu_torch/bench.py``) on the
CPU at a cut size: 2 replans per episode and one episode per measure, every
mode of ``bench.py`` with and without bf16 weights. On the CPU each wrapper
runs its plain version, which the bench counts; the card's launch counts and
rates come only from a run there (``chip_smoke.py``). The JSON keys are read
from ``bench.py``'s own ``json.dumps`` calls."""
import ast
import json
import math
from pathlib import Path

import pytest
import torch

from mpc_via_diffusion_model_tpu_torch import bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CUT = dict(n_steps=2, n_rep=1, n_chain=1, n_best=1)


def _bench_py_keys():
    """The keys of the two JSON objects ``bench.py`` prints: the episode
    mode's and the other modes'."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    found = [[k.value for k in node.args[0].keys] for node in ast.walk(tree)
             if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
             and node.args and isinstance(node.args[0], ast.Dict)]
    assert len(found) == 2, found
    episode, other = sorted(found, key=lambda keys: "protocol" not in keys)
    return {"episode": episode, "other": other}


@pytest.mark.parametrize("mode,bf16,wrapper,calls", [
    ("episode", False, "FusedCfgEpisode", 3),
    ("episode", True, "FusedCfgEpisode", 3),
    ("chain", False, "FusedCfgChain", 4),
    ("chain", True, "FusedCfgChain", 4),
    ("1", False, "FusedUnet", 120),
    ("apply", False, None, 0),
])
def test_bench_runs_every_mode_at_a_cut_size_on_cpu(mode, bf16, wrapper, calls):
    """``run`` on the CPU: bench.py's keys for the mode, finite positive
    numbers, and the wrapper's plain version called once per warm-up and
    timed episode (episode), per replan (chain) or per chain step (``1``),
    with no launch."""
    res = bench.run(mode, bf16, "cpu", **CUT)
    keys = _bench_py_keys()["episode" if mode == "episode" else "other"]
    assert list(res.line) == keys
    assert res.line["metric"] == "closed_loop_control_hz" and res.line["unit"] == "Hz"
    for key in ("value", "vs_baseline") + (("pipelined_hz",) if mode == "episode" else ()):
        assert math.isfinite(res.line[key]) and res.line[key] > 0, key
    if mode == "episode":
        assert res.line["protocol"] == "sustained_800step_dependent_chain"
    # both rounded from one rate: value to 0.1 Hz, vs_baseline (value / 100 Hz) to 0.01
    assert abs(res.line["vs_baseline"] - res.line["value"] / bench.BASELINE_CONTROL_HZ) <= 0.0051
    assert (res.wrapper, res.launches, res.plain_calls) == (wrapper, 0, calls)
    assert calls == bench.expected_calls(mode, **CUT)
    assert res.bf16 == (bf16 and mode in ("episode", "chain")) and res.device == "cpu"
    assert all(s > 0 for s in res.seconds)


def test_expected_calls_are_bench_py_counts():
    """At bench.py's counts: 61 episodes (1 warm-up, 3 x 10 pipelined, 3 x
    10 sustained), 880 chains (11 episodes of 80 replans) and 26,400 U-Net
    passes (30 per replan)."""
    assert [bench.expected_calls(m) for m in ("episode", "chain", "1", "apply")] == \
        [61, 880, 26400, 0]


@pytest.mark.parametrize("env,want", [
    ({}, ("episode", False)),
    ({"BENCH_BF16": "1"}, ("episode", True)),
    ({"BENCH_BF16": "true"}, ("episode", False)),
    ({"BENCH_FUSED": "chain", "BENCH_BF16": "1"}, ("chain", True)),
    ({"BENCH_FUSED": "1", "BENCH_BF16": "0"}, ("1", False)),
    ({"BENCH_FUSED": "apply"}, ("apply", False)),
])
def test_main_reads_the_environment_as_bench_py_does(monkeypatch, capsys, env, want):
    """``main`` takes the mode from ``BENCH_FUSED`` (default ``episode``) and
    bf16 from ``BENCH_BF16 == "1"``, as bench.py does, and prints the JSON
    line last, after the line that names the mode and the card."""
    for name in ("BENCH_FUSED", "BENCH_BF16"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    seen = []
    line = {"metric": "closed_loop_control_hz", "value": 1.0, "unit": "Hz", "vs_baseline": 0.01}

    def fake_run(mode, bf16):
        seen.append((mode, bf16))
        return bench.BenchResult(line, bf16, "card", None, 0, 0, [1.0])

    monkeypatch.setattr(bench, "run", fake_run)
    monkeypatch.setattr(bench, "nvidia_smi", lambda: "NVIDIA H100, 700.00 W")
    bench.main()
    assert seen == [want]
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == line
    assert out[-2].startswith(f"bench: BENCH_FUSED={want[0]} ") and "700.00 W" in out[-2]


def test_bench_refuses_to_run_without_a_card_unless_asked():
    """The entry point runs on the card: without one it raises rather than
    timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run("episode", False)


def test_main_cuts_the_best_of_with_bench_n_best(monkeypatch, capsys):
    """``BENCH_SMOKE=1`` (chip_smoke.py's cut of the protocol) reaches
    ``run`` as ``SMOKE_CUT``: one chain of 2 dependent episodes and 2
    pipelined ones; without it ``run`` gets bench.py's own counts."""
    seen = []
    line = {"metric": "closed_loop_control_hz", "value": 1.0, "unit": "Hz", "vs_baseline": 0.01}

    def fake_run(mode, bf16, **cut):
        seen.append(cut)
        return bench.BenchResult(line, bf16, "card", None, 0, 0, [1.0])

    monkeypatch.setattr(bench, "run", fake_run)
    monkeypatch.setattr(bench, "nvidia_smi", lambda: "NVIDIA H100, 700.00 W")
    for name in ("BENCH_FUSED", "BENCH_BF16", "BENCH_SMOKE"):
        monkeypatch.delenv(name, raising=False)
    bench.main()
    monkeypatch.setenv("BENCH_SMOKE", "1")
    bench.main()
    assert seen == [{}, {"n_best": 1, "n_rep": 2, "n_chain": 2}]
    assert bench.expected_calls("episode", n_best=1) == 21
    assert bench.expected_calls("episode", **bench.SMOKE_CUT) == 5
