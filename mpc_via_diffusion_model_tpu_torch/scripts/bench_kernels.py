"""Per-kernel microbenchmarks of the port: every CUDA kernel against its plain
PyTorch twin, on the card. Port of ``scripts/bench_kernels.py``.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.bench_kernels [--quick] [--skip-conv] \
        [--skip-panda] [--device cpu]

Rows, one JSON line each, with the JAX script's keys (``pallas_us`` becomes
``kernel_us``, ``xla_us`` becomes ``plain_us``) and the device's name:

- ``conv1d_gn_mish`` (``ops/fused_conv.py``) at the JAX script's six shapes
  (B, H, Cin, Cout) with its inputs (x normal, w x 0.1, b 0, gamma 1, beta
  0, 8 groups where Cout allows, else 1), and one row with a FiLM
  ``pre_bias``. Each row also times ``torch_seq_us``: ``F.conv1d`` ->
  ``F.group_norm`` -> ``F.mish`` (the pre-bias added first) on the same data,
  cuDNN and ATen calls that the port never uses, the yardstick of a later
  speed-up.
- At the flagship's shape (``flagship_h32_1ch_ctx5``): ``unet_forward``
  (``ops/fused_unet.py``, batch 2), ``cfg_chain_30step`` (25 + 5 steps, w =
  0.01), ``ddim_chain_3eval`` (times [23, 15, 7]) and ``cfg_episode_80step``
  (80 replans, K = 1, bench.py's synthetic limits +-30 and +-10). The JAX
  script builds them on ``model.init`` draws, which cannot be reproduced
  without JAX; these rows load ``artifacts/flagship/ema_params.pkl``, the
  same architecture, so the same work. Every row checks the kernel against
  its twin on the same inputs and noise and raises past ``tol``. The plain
  episode takes seconds, so it runs ``plain_reps`` times, each synchronised,
  and its best time is kept; every other time is pipelined (``eval.timing``).

- At the panda arm's shape (``panda_h128_7ch_ctx20``: horizon 128, 7
  channels, context 20): ``unet_forward`` (batch 2) and
  ``ddim_chain_3eval``, on the committed on-policy student
  (``artifacts/onpolicy_panda/student_1eval.pkl``), the architecture of the
  JAX script's panda rows, so the same work, both on the kernels'
  one-row-set plan; ``cfg_chain_30step`` (25 + 5 steps, w = 0.01, B = 1)
  on the CFG teacher (``artifacts/flagship_panda_rbd/ema_params.pkl``, the
  same architecture), on the chain's plan in turns: its two-row-set plan
  does not fit one block at horizon 128. The JAX script skips the panda
  ``cfg_episode_80step``, and so does this one.

``--quick`` runs one batch of the fewest repetitions. ``--device cpu`` runs
the plain twins only, with ``kernel_us`` and ``max_abs_err`` null; without
it the script runs on ``cuda`` or raises.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from ..core import make_schedule
from ..data import NormalizerStats
from ..dynamics import cartpole_virtual_cost, cartpole_virtual_swingup, theta_to_red_theta
from ..eval.timing import Timer, pipelined_time_fn
from ..models import load_flagship, load_panda_student, load_panda_teacher
from ..ops import fused_conv1d_gn_mish
from ..ops.fused_denoise import make_fused_cfg_chain, make_fused_ddim_chain
from ..ops.fused_episode import make_fused_cfg_episode
from ..ops.fused_unet import make_fused_unet
from ..utils.device import resolve_device

FLAGSHIP = Path(__file__).resolve().parents[2] / "artifacts" / "flagship" / "ema_params.pkl"
PANDA_STUDENT = (Path(__file__).resolve().parents[2] / "artifacts" / "onpolicy_panda"
                 / "student_1eval.pkl")
PANDA_TEACHER = (Path(__file__).resolve().parents[2] / "artifacts" / "flagship_panda_rbd"
                 / "ema_params.pkl")
CONV_SHAPES = [(2, 32, 1, 32), (2, 32, 32, 32), (2, 16, 32, 64), (2, 8, 64, 128),
               (64, 32, 32, 32), (64, 8, 64, 128)]
PRE_BIAS_SHAPE = (2, 32, 32, 32)  # the flagship's level-0 FiLM-biased block at the CFG pair
# Kernel vs plain: fp32 sums in other orders, and GroupNorm's variance as E[y^2] - mean^2
# against two passes, ~1e-6 at these scales; 1e-4 is the JAX suite's kernel tolerance.
# Closed-loop states: per-replan differences of ~1e-6 in u_norm pass through 80 plant steps.
KERNEL_TOL, TRACK_TOL = 1e-4, 1e-3
HORIZON, T, N_TAIL, W, N_STEPS = 32, 25, 5, 0.01, 80
GRID3 = [23, 15, 7]


def _reps(quick: bool, full: int):
    """(calls per batch, batches)."""
    return (min(full, 3), 1) if quick else (full, 3)


def _us(fn: Callable, args_list: list, n_batches: int) -> float:
    return pipelined_time_fn(fn, args_list, n_batches) * 1e6


def _maxerr(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


def _check(row: dict) -> dict:
    """Prints the row; raises when the kernel's error is past its tolerance."""
    print(json.dumps(row), flush=True)
    err, tol = row["max_abs_err"], row["tol"]
    if err is not None and not err <= tol:  # NaN fails too
        raise RuntimeError(f"{row['kernel']}: kernel vs plain {err} > {tol}")
    return row


def bench_conv_blocks(dev: torch.device, quick: bool) -> List[dict]:
    on_card = dev.type == "cuda"
    n, nb = _reps(quick, 30)
    rows = []
    for shape, with_pb in [(s, False) for s in CONV_SHAPES] + [(PRE_BIAS_SHAPE, True)]:
        bsz, h, cin, cout = shape
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((bsz, h, cin), generator=gen, device=dev)
        w = torch.randn((5, cin, cout), generator=gen, device=dev) * 0.1
        b, beta = torch.zeros(cout, device=dev), torch.zeros(cout, device=dev)
        gamma = torch.ones(cout, device=dev)
        pb = torch.randn((bsz, cin), generator=gen, device=dev) if with_pb else None
        groups = 8 if cout % 8 == 0 else 1
        args = (x, w, b, gamma, beta, groups, pb)
        launches0 = fused_conv1d_gn_mish.launches
        want = fused_conv1d_gn_mish.plain(*args)
        plain_us = _us(fused_conv1d_gn_mish.plain, [args] * n, nb)
        kernel_us = err = None
        if on_card:
            err = _maxerr(fused_conv1d_gn_mish.kernel(*args), want)
            kernel_us = _us(fused_conv1d_gn_mish.kernel, [args] * n, nb)
        # the yardstick: cuDNN's conv, ATen's group norm and mish, in torch's (B, C, H) layout
        xt, wt = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        pbt = None if pb is None else pb[:, :, None].contiguous()

        def torch_seq(xt_):
            if pbt is not None:
                xt_ = xt_ + pbt
            return F.mish(F.group_norm(F.conv1d(xt_, wt, b, padding=2), groups, gamma, beta, 1e-5))

        seq_err = _maxerr(torch_seq(xt).transpose(1, 2), want)
        if not seq_err <= KERNEL_TOL:
            raise RuntimeError(f"torch_seq at {shape}: {seq_err} from the plain version")
        rows.append(_check({
            "kernel": "conv1d_gn_mish", "shape": list(shape), "groups": groups,
            "pre_bias": with_pb, "device": _device_name(dev), "plain_us": plain_us,
            "kernel_us": kernel_us, "torch_seq_us": _us(torch_seq, [(xt,)] * n, nb),
            "max_abs_err": err, "tol": KERNEL_TOL, "torch_seq_max_abs_err": seq_err,
            "launches": fused_conv1d_gn_mish.launches - launches0, "reps": [n, nb]}))
    return rows


def bench_round2(dev: torch.device, quick: bool) -> List[dict]:
    on_card = dev.type == "cuda"
    tag = "flagship_h32_1ch_ctx5"
    model = load_flagship(FLAGSHIP, device=dev)
    schedule = make_schedule("exponential", T)
    chain = make_fused_cfg_chain(model, schedule, n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    packed = chain.packed
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []

    def finish(name, wrapper, args_list, n_batches, tol, err, plain_us, extra=None):
        kernel_us = _us(wrapper.kernel, args_list, n_batches) if on_card else None
        rows.append(_check({
            "kernel": name, "config": tag, "rows": 2 * HORIZON, "device": _device_name(dev),
            "plain_us": plain_us, "kernel_us": kernel_us, "max_abs_err": err, "tol": tol,
            "launches": wrapper.launches, "reps": [len(args_list), n_batches], **(extra or {})}))

    def twin(name, wrapper, args_list, n_batches, extra=None):
        """The kernel against its plain twin on args_list[0], then both timed."""
        want = wrapper.plain(*args_list[0])
        err = _maxerr(wrapper.kernel(*args_list[0]), want) if on_card else None
        finish(name, wrapper, args_list, n_batches, KERNEL_TOL, err,
               _us(wrapper.plain, args_list, n_batches), extra)

    # one U-Net forward at batch 2, the CFG pair
    n, nb = _reps(quick, 30)
    unet = make_fused_unet(packed, batch_size=2, device=dev)
    x = torch.randn((2, HORIZON, 1), generator=gen, device=dev) * 0.3
    t = torch.tensor([5, 5], device=dev)
    ctx = torch.randn((2, 5), generator=gen, device=dev) * 0.3
    mask = torch.tensor([[0.0], [1.0]], device=dev)
    twin("unet_forward", unet, [(x, t, ctx, mask)] * n, nb)

    # the whole CFG DDPM chain of one replan, 25 + 5 steps, two U-Net rows per step
    n, nb = _reps(quick, 20)
    cond = ctx[:1].contiguous()
    noises = [torch.randn((chain.n_total + 1, 1, HORIZON, 1), generator=gen, device=dev)
              for _ in range(n)]
    twin("cfg_chain_30step", chain, [(cond, nz) for nz in noises], nb)

    # the distilled 3-eval DDIM chain
    ddim = make_fused_ddim_chain(packed, schedule, GRID3, n_samples=1, device=dev)
    x_inits = [torch.randn(ddim.noise_shape, generator=gen, device=dev) for _ in range(n)]
    twin("ddim_chain_3eval", ddim, [(cond, xi) for xi in x_inits], nb, {"times": GRID3})

    # the whole CFG episode, 80 replans: the plain twin takes seconds per call
    n, nb = _reps(quick, 8)
    plain_reps = 1 if quick else 2
    in_stats = NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0))
    c_stats = NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0))
    ep = make_fused_cfg_episode(packed, schedule, in_stats, c_stats, cartpole_virtual_swingup(),
                                cartpole_virtual_cost(), n_steps=N_STEPS, w=W,
                                n_diffusion_steps_without_noise=N_TAIL, device=dev)
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    args_list = [(x0, torch.randn(ep.noise_shape, generator=gen, device=dev)) for _ in range(n)]
    times = []
    for _ in range(plain_reps):
        with Timer() as tm:
            want = ep.plain(*args_list[0])[0]
            _sync(dev)
        times.append(tm.elapsed)
    err = _maxerr(ep.kernel(*args_list[0])[0], want) if on_card else None
    finish("cfg_episode_80step", ep, args_list, nb, TRACK_TOL, err, min(times) * 1e6,
           {"plain_reps": plain_reps, "n_steps": N_STEPS, "compared": "x_track"})
    return rows


def bench_panda(dev: torch.device, quick: bool) -> List[dict]:
    """The JAX script's panda rows: the U-Net pass at batch 2 and the 3-eval
    DDIM chain on the committed student, and the CFG chain on the teacher in
    turns, against their plain twins."""
    on_card = dev.type == "cuda"
    tag, horizon, channels, ctx_dim = "panda_h128_7ch_ctx20", 128, 7, 20
    model = load_panda_student(PANDA_STUDENT, device=dev)
    schedule = make_schedule("exponential", T)
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []

    def twin(name, wrapper, args_list, n_batches, extra=None):
        want = wrapper.plain(*args_list[0])
        err = _maxerr(wrapper.kernel(*args_list[0]), want) if on_card else None
        kernel_us = _us(wrapper.kernel, args_list, n_batches) if on_card else None
        rows.append(_check({
            "kernel": name, "config": tag, "rows": 2 * horizon, "device": _device_name(dev),
            "plain_us": _us(wrapper.plain, args_list, n_batches), "kernel_us": kernel_us,
            "max_abs_err": err, "tol": KERNEL_TOL, "launches": wrapper.launches,
            "smem_bytes": wrapper.smem_bytes, "reps": [len(args_list), n_batches],
            **(extra or {})}))

    n, nb = _reps(quick, 30)
    unet = make_fused_unet(model, batch_size=2, device=dev)
    x = torch.randn((2, horizon, channels), generator=gen, device=dev) * 0.3
    t = torch.tensor([5, 5], device=dev)
    ctx = torch.randn((2, ctx_dim), generator=gen, device=dev) * 0.3
    mask = torch.tensor([[0.0], [1.0]], device=dev)
    twin("unet_forward", unet, [(x, t, ctx, mask)] * n, nb)

    n, nb = _reps(quick, 20)
    cond = ctx[:1].contiguous()
    chain = make_fused_cfg_chain(load_panda_teacher(PANDA_TEACHER, device=dev), schedule,
                                 n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    noises = [torch.randn((chain.n_total + 1, 1, horizon, channels), generator=gen, device=dev)
              for _ in range(n)]
    twin("cfg_chain_30step", chain, [(cond, nz) for nz in noises], nb,
         {"model": "flagship_panda_rbd", "plan": chain.plan, "entry": chain.entry})
    ddim = make_fused_ddim_chain(unet.packed, schedule, GRID3, n_samples=1, device=dev)
    x_inits = [torch.randn(ddim.noise_shape, generator=gen, device=dev) for _ in range(n)]
    twin("ddim_chain_3eval", ddim, [(cond, xi) for xi in x_inits], nb, {"times": GRID3})
    return rows


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu: the plain twins only")
    p.add_argument("--quick", action="store_true", help="one batch, the fewest repetitions")
    p.add_argument("--skip-conv", action="store_true")
    p.add_argument("--skip-panda", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {_device_name(dev)}", flush=True)
    rows = [] if args.skip_conv else bench_conv_blocks(dev, args.quick)
    rows += bench_round2(dev, args.quick)
    return rows if args.skip_panda else rows + bench_panda(dev, args.quick)


if __name__ == "__main__":
    main()
