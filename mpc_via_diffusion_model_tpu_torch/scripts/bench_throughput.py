"""Secondary benchmarks of the port on the card: the port of the JAX
package's ``scripts/bench_throughput.py``, its seven rows by their metric
names and keys, plus ``--device``.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.bench_throughput \\
        [--candidates 4096] [--device cuda] [--out PATH] [--smoke-cut]

Rows, one JSON line each, in the JAX script's order:

- ``ddim_closed_loop_hz``: the flagship-shaped ``TemporalUnet`` (horizon 32,
  context 5, no context bit) of random weights through ``make_closed_loop``
  with ``sampler='ddim'``, 80 replans from the flagship's x0, ``bench.py``'s
  synthetic limits (controls +-30, states +-10);
- ``candidates{N}_closed_loop_hz`` with ``trajectories_per_sec``: the same
  model through the CFG DDPM loop at K = ``--candidates`` (4,096);
- ``pendulum_pointunet_closed_loop_hz``: a random ``PointUnet(8, 32,
  context 2, 'default')`` on the pendulum (dt 0.05): per replan one CFG DDPM
  chain of shape (1, 1, 8) (the 8-step horizon packed as one point), the
  first control applied;
- ``distilled_3eval_fused_episode_hz`` with ``real_weights`` and
  ``cost_ratio_vs_expert``: the committed 3-eval student
  (``artifacts/distilled/student_3eval.pkl``, horizon 64, the times of the
  report's last round) through kernel 5, 80 replans from x0 scored by the
  collection cost, 8 episodes issued back to back;
- ``serving_64loops_control_steps_per_sec``: 64 such episodes as ONE fleet
  launch (kernel 5's grid axis, the JAX script's ``jax.vmap``), the starts x0
  with the cart moved by ``RandomState(5).uniform(-0.5, 0.5)``, best of 3;
  the row also carries ``first_episode_vs_single_max_abs_err``, the fleet's
  first episode against the same episode launched alone;
- ``production_cfg30_flagship_bf16_hz`` with ``cost_ratio_vs_expert``: the
  horizon-64 teacher (``artifacts/flagship_modality/ema_params.pkl``) through
  kernel 3's bf16 entry, T = 25 + 5, w = 0.01, best of 3 batches of 8;
- ``distilled_3eval_sustained_hz``: one 800-replan episode per launch, best
  of 3.

The students' statistics are ``data/teacher_stats.py``'s (the JAX script
reads the teacher's git-ignored ``dataset.npz``); the expert's cost is the
report's. The random models are ``models.init_like_flax`` from
``RandomState(0)`` and ``(2)`` (flax's ``PRNGKey`` draws cannot be
reproduced; those rows measure rates only). Noise is staged from
``torch.Generator(device)`` seeds where the JAX script splits keys, and is
drawn inside the timed call where the JAX loop draws it (the per-replan
loops), before it where the JAX episode stages it (the episodes). Timing is
the JAX script's: one warm-up, then the calls issued back to back and one
synchronise. ``--smoke-cut`` is a cut, not the protocol: ``SMOKE_CUT``'s
replans, candidates and repetitions, for ``chip_smoke.py`` and the CPU
tests. The report goes to ``--out`` (``chiprun_out/bench_throughput.json``
by default), never under ``artifacts/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..control.runtime import make_closed_loop
from ..core.schedules import make_schedule
from ..data.normalization import NormalizerStats, normalize, unnormalize
from ..data.teacher_stats import teacher_stats
from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..dynamics import (cartpole_virtual_collect_cost, cartpole_virtual_cost,
                        cartpole_virtual_swingup, pendulum, pendulum_cost, theta_to_red_theta)
from ..models import FLAGSHIP_CONFIG, TEACHER_CONFIG, PointUnet, TemporalUnet, init_like_flax
from ..models.weights import load_teacher
from ..ops.fused_episode import make_fused_cfg_episode, make_fused_ddim_episode
from ..utils.device import resolve_device

__all__ = ["main", "run", "SMOKE_CUT"]

ROOT = Path(__file__).resolve().parents[2]
DISTILLED = ROOT / "artifacts" / "distilled"
TEACHER = ROOT / "artifacts" / "flagship_modality" / "ema_params.pkl"
N_STEPS, N_FLEET, N_SUSTAINED, N_REP = 80, 64, 800, 8
# the cut chip_smoke.py and the CPU tests run: replans per loop and episode, candidates,
# sustained replans, calls per timed batch and batches; the fleet keeps its 64 episodes
SMOKE_CUT = dict(n_steps=2, candidates=4, n_sustained=4, n_rep=1, n_best=1)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_calls(fn, args_list, dev, n_best: int = 1) -> float:
    """Seconds per call: one warm-up call, then ``args_list`` issued back to back with one
    synchronise, the best of ``n_best`` such batches (the JAX script's ``_time_loop`` at 1)."""
    fn(*args_list[0])
    _sync(dev)
    best = float("inf")
    for _ in range(n_best):
        t0 = time.perf_counter()
        for a in args_list:
            fn(*a)
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / len(args_list))
    return best


def run(device=None, candidates: int = 4096, cut: bool = False, emit=print) -> dict:
    """Every row on ``device`` (``cuda`` unless given), each passed to ``emit`` as a JSON line
    when it is measured; returns them by metric. ``cut`` runs ``SMOKE_CUT``."""
    dev = resolve_device(device)
    c = SMOKE_CUT if cut else dict(n_steps=N_STEPS, candidates=candidates,
                                   n_sustained=N_SUSTAINED, n_rep=N_REP, n_best=3)
    n_steps, n_rep, n_best = c["n_steps"], c["n_rep"], c["n_best"]
    rows = {}

    def row(metric, value, unit, **extra):
        rows[metric] = {"metric": metric, "value": value, "unit": unit, **extra}
        emit(json.dumps(rows[metric]))

    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    ins = NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)).to(dev)
    cond = NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)).to(dev)
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    schedule = make_schedule("exponential", 25)
    diffusion = GaussianDiffusion(schedule)
    model = init_like_flax(TemporalUnet(**FLAGSHIP_CONFIG).to(dev), np.random.RandomState(0))
    model.eval()

    # the DDIM fast mode
    loop = make_closed_loop(diffusion, model, ins, cond, plant, cost, horizon=32,
                            n_steps=n_steps, sampler="ddim", device=dev)
    g = gen(1)
    dt = _time_calls(lambda: loop(x0, generator=g).x_track, [()] * n_rep, dev)
    row("ddim_closed_loop_hz", n_steps / dt, "Hz")

    # the candidate sweep
    k = c["candidates"]
    loop_c = make_closed_loop(diffusion, model, ins, cond, plant, cost, horizon=32,
                              n_steps=n_steps, n_candidates=k, device=dev)
    dt = _time_calls(lambda: loop_c(x0, generator=g).x_track, [()] * n_rep, dev)
    row(f"candidates{k}_closed_loop_hz", n_steps / dt, "Hz",
        trajectories_per_sec=n_steps * k / dt)

    # the pendulum and a PointUnet, the 8-step horizon packed as one point
    pmodel = init_like_flax(PointUnet(state_dim=8, dim=32, context_dim=2,
                                      conditioning_type="default").to(dev),
                            np.random.RandomState(2)).eval()
    pplant, pcost = pendulum(dt=0.05), pendulum_cost().to(dev)
    pin = NormalizerStats("limits", torch.full((8,), -10.0), torch.full((8,), 10.0)).to(dev)
    pc = NormalizerStats("limits", torch.full((2,), -8.0), torch.full((2,), 8.0)).to(dev)

    @torch.no_grad()
    def ploop(xp, generator):
        xs, us, stages = [xp], [], []
        for _ in range(n_steps):
            u_norm = diffusion.ddpm_cfg_sample(pmodel, (1, 1, 8), normalize(pc, xs[-1])[None],
                                               w=0.01, n_diffusion_steps_without_noise=5,
                                               generator=generator)
            u = unnormalize(pin, u_norm)[0, 0]
            stages.append(pcost.stage(xs[-1], u[:1]))
            xs.append(pplant.step(xs[-1], u[:1]))
            us.append(u[:1])
        return torch.stack(xs), torch.stack(us), torch.stack(stages)

    xp0 = torch.tensor([np.pi, 0.0], dtype=torch.float32, device=dev)
    dt = _time_calls(lambda: ploop(xp0, g)[0], [()] * n_rep, dev)
    row("pendulum_pointunet_closed_loop_hz", n_steps / dt, "Hz")

    # the distilled 3-eval student through kernel 5
    report = {}
    if (DISTILLED / "report.json").exists():
        report = json.loads((DISTILLED / "report.json").read_text())
    times = report.get("rounds", [{}])[-1].get("times", [23, 15, 7])
    pkl = DISTILLED / f"student_{len(times)}eval.pkl"
    real_weights = pkl.exists()
    if real_weights:  # the teacher's architecture: horizon 64, the context-present bit
        dmodel = load_teacher(pkl, device=dev)
        d_in, d_cond = (st.to(dev) for st in teacher_stats())
    else:
        dmodel = init_like_flax(TemporalUnet(**TEACHER_CONFIG, cfg_indicator=True).to(dev),
                                np.random.RandomState(3)).eval()
        d_in, d_cond = ins, cond
    dcost = cartpole_virtual_collect_cost()
    episode = make_fused_ddim_episode(dmodel, schedule, times, d_in, d_cond, plant, dcost,
                                      n_steps=n_steps, device=dev)
    noise = [torch.randn(episode.noise_shape, generator=gen(100 + i), device=dev)
             for i in range(n_rep)]
    dt = _time_calls(lambda nz: episode(x0, nz), [(nz,) for nz in noise], dev)
    extra = {"real_weights": real_weights}
    if real_weights and "expert_cost" in report:
        costs = episode(x0, torch.randn(episode.noise_shape, generator=gen(1), device=dev))[2]
        extra["cost_ratio_vs_expert"] = float(costs.double().sum()) / report["expert_cost"]
    row(f"distilled_{len(times)}eval_fused_episode_hz", n_steps / dt, "Hz", **extra)

    # serving: a fleet of 64 independent episodes as one launch of kernel 5
    x0f = x0[None].repeat(N_FLEET, 1)
    x0f[:, 0] += torch.from_numpy(np.random.RandomState(5).uniform(-0.5, 0.5, N_FLEET)
                                  .astype(np.float32)).to(dev)
    fleet_noise = lambda seed: torch.stack([
        torch.randn(episode.noise_shape, generator=g_, device=dev)
        for g_ in [gen(seed)] for _ in range(N_FLEET)])
    warm = fleet_noise(17)
    first = episode.fleet(x0f, warm)
    single = episode(x0f[0], warm[0])
    gap = max(float((f[0].double() - s.double()).abs().max()) for f, s in zip(first, single))
    reps = [fleet_noise(r) for r in range(n_best)]
    dt = min(_time_calls(lambda nz: episode.fleet(x0f, nz), [(nz,)], dev) for nz in reps)
    row(f"serving_{N_FLEET}loops_control_steps_per_sec", N_FLEET * n_steps / dt, "steps/s",
        first_episode_vs_single_max_abs_err=gap)

    # the production CFG teacher through kernel 3's bf16 entry
    if real_weights and "expert_cost" in report and TEACHER.exists():
        cfg_ep = make_fused_cfg_episode(load_teacher(TEACHER, device=dev), schedule, d_in,
                                        d_cond, plant, dcost, n_steps=n_steps, w=0.01,
                                        n_diffusion_steps_without_noise=5,
                                        weights_dtype=torch.bfloat16, device=dev)
        batches = [[(torch.randn(cfg_ep.noise_shape, generator=gen(1000 + 50 * b + i),
                                 device=dev),) for i in range(n_rep)] for b in range(n_best)]
        dt = min(_time_calls(lambda nz: cfg_ep(x0, nz), batch, dev) for batch in batches)
        costs = cfg_ep(x0, torch.randn(cfg_ep.noise_shape, generator=gen(1), device=dev))[2]
        row("production_cfg30_flagship_bf16_hz", n_steps / dt, "Hz",
            cost_ratio_vs_expert=float(costs.double().sum()) / report["expert_cost"])

    # sustained: one long receding-horizon episode per launch
    n_long = c["n_sustained"]
    ep_long = make_fused_ddim_episode(dmodel, schedule, times, d_in, d_cond, plant, dcost,
                                      n_steps=n_long, device=dev)
    long_noise = [torch.randn(ep_long.noise_shape, generator=gen(900 + r), device=dev)
                  for r in range(n_best)]
    dt = min(_time_calls(lambda nz: ep_long(x0, nz), [(nz,)], dev) for nz in long_noise)
    row(f"distilled_{len(times)}eval_sustained_hz", n_long / dt, "Hz")
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--candidates", type=int, default=4096)
    p.add_argument("--device", default=None, help="cuda unless given")
    p.add_argument("--smoke-cut", action="store_true",
                   help="a cut, not the protocol: SMOKE_CUT's replans, candidates and repetitions")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "bench_throughput.json"))
    args = p.parse_args(argv)
    out_path = Path(args.out).resolve()
    if (ROOT / "artifacts") in out_path.parents:
        raise SystemExit(f"--out {args.out}: the report goes under chiprun_out/, not artifacts/")
    dev = resolve_device(args.device)
    rows = run(dev, args.candidates, args.smoke_cut, emit=lambda line: print(line, flush=True))
    out = {"rows": rows, "device": str(dev), "smoke_cut": args.smoke_cut,
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
