"""The port's headline benchmark: the closed-loop control rate of diffusion
MPC on the cart-pole, by ``bench.py``'s protocol, on the PyTorch/CUDA port.

    python3 -m mpc_via_diffusion_model_tpu_torch.bench
    BENCH_FUSED=chain BENCH_BF16=1 python3 -m mpc_via_diffusion_model_tpu_torch.bench

The workload is ``bench.py``'s: the flagship U-Net (horizon 32,
``unet_input_dim`` 32, ``dim_mults`` (1, 2, 4), context 5, the
context-present bit), the exponential schedule with T = 25 plus 5 noise-free
tail steps, CFG at w = 0.01, 80 replans from x0 = [0, 0, 3, 0, theta*(3)] on
the cart-pole swing-up with ``cartpole_virtual_cost``, and the synthetic
limits of ``bench.py`` (controls +-30, conditions +-10). ``bench.py`` draws
its weights from a flax init at ``PRNGKey(0)``, which no torch code can
reproduce; this bench loads the trained flagship
(``artifacts/flagship/ema_params.pkl``). The rate does not depend on the
weights' values: every kernel runs the same work on any of them. The noise
comes from a ``torch.Generator`` on the device seeded with 42, drawn inside
the timed windows, as ``bench.py``'s jitted calls draw theirs.

``BENCH_FUSED`` picks the path, as in ``bench.py``:

- ``episode`` (the default): the CFG episode kernel, one launch per
  80-replan episode; ``BENCH_BF16=1`` runs its bf16 entry. One warm-up
  episode, then the pipelined rate (3 batches of 10 independent episodes,
  one synchronise each; 80 over the best batch's seconds per episode) and
  the headline, the sustained rate (3 runs of 10 dependent episodes, each x0
  the last episode's final state, one synchronise each; 800 over the best
  run's seconds).
- ``chain``: ``make_closed_loop`` with the CFG chain kernel as its
  ``sample_override`` (``BENCH_BF16=1``: its bf16 entry); one warm-up
  episode, then 10 episodes back to back and one synchronise; 80 over the
  mean seconds per episode.
- ``1``: the same loop with the U-Net pass kernel at batch 2 as the
  denoiser (``BENCH_BF16`` is ignored, as ``bench.py`` ignores it there).
- anything else: the same loop with the model's own forward.

The last line printed is one JSON object with exactly ``bench.py``'s keys
for the mode; the line before it names the mode, the card and its power
limit. After the timed runs the bench checks the wrapper's counters: on the
card every call launched its kernel (61 episode launches, 880 chain
launches, 26,400 U-Net launches), on the CPU every call ran the plain
version; any other count raises. ``run`` holds the protocol with its counts
as arguments, for the tests at a cut size; ``main`` runs it with
``bench.py``'s.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional

import torch

from .control import make_closed_loop
from .core import make_schedule
from .data import NormalizerStats
from .diffusion import GaussianDiffusion
from .dynamics import cartpole_virtual_cost, cartpole_virtual_swingup, theta_to_red_theta
from .models import load_flagship
from .ops import _build
from .ops.fused_denoise import make_fused_cfg_chain
from .ops.fused_episode import make_fused_cfg_episode
from .ops.fused_unet import make_fused_unet
from .utils.device import resolve_device

__all__ = ["BenchResult", "run", "main", "expected_calls", "BASELINE_CONTROL_HZ"]

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts" / "flagship" / "ema_params.pkl"
# bench.py's constants: its 100 Hz estimate of the reference's IPOPT loop, the workload, and
# the protocol's repetitions
BASELINE_CONTROL_HZ = 100.0
N_STEPS, HORIZON, N_DIFFUSION_STEPS, N_TAIL, CFG_W = 80, 32, 25, 5, 0.01
N_REP, N_CHAIN, N_BEST, SEED = 10, 10, 3, 42
PROTOCOL = "sustained_800step_dependent_chain"


@dataclasses.dataclass(frozen=True)
class BenchResult:
    line: dict                # bench.py's JSON object for the mode
    bf16: bool                # bf16 weights ran (episode and chain only)
    device: str               # the card's name, or "cpu"
    wrapper: Optional[str]    # the kernel the mode runs, None for the model's own forward
    launches: int             # its kernel launches over the whole run, warm-up included
    plain_calls: int          # its plain version's calls over the whole run
    seconds: List[float]      # each timed window, host clock


def expected_calls(mode: str, n_steps: int = N_STEPS, n_rep: int = N_REP,
                   n_chain: int = N_CHAIN, n_best: int = N_BEST,
                   n_total: int = N_DIFFUSION_STEPS + N_TAIL) -> int:
    """Calls of the mode's wrapper in one ``run``: the warm-up and every
    timed episode (``episode``); one chain per replan (``chain``); one U-Net
    pass per step of each replan's chain (``1``); 0 for the model's own
    forward."""
    episodes = 1 + n_rep
    if mode == "episode":
        return 1 + n_best * (n_rep + n_chain)
    if mode == "chain":
        return episodes * n_steps
    if mode == "1":
        return episodes * n_steps * n_total
    return 0


def _stats():
    """bench.py's synthetic limits: controls +-30, conditions +-10."""
    return (NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)),
            NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)))


def run(mode: str = "episode", bf16: bool = False, device=None, n_steps: int = N_STEPS,
        n_rep: int = N_REP, n_chain: int = N_CHAIN, n_best: int = N_BEST) -> BenchResult:
    """``bench.py``'s protocol for ``mode`` (its ``BENCH_FUSED``) on
    ``device`` (``cuda`` unless given), with bf16 weights where ``bf16`` and
    the mode takes them: episodes of ``n_steps`` replans, ``n_best`` batches
    of ``n_rep`` independent episodes and ``n_best`` runs of ``n_chain``
    dependent ones (``episode``), or ``n_rep`` episodes (the other modes),
    after one warm-up episode. Raises when the wrapper's counters are not
    ``expected_calls``' (launches on the card, plain calls on the CPU) or an
    episode's final state is not finite."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        _build.build_all()  # every kernel, one nvcc each at once, before the warm-up
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model = load_flagship(FLAGSHIP, device=dev)
    schedule = make_schedule("exponential", N_DIFFUSION_STEPS)
    inputs_stats, cond_stats = _stats()
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    bf16 = bf16 and mode in ("episode", "chain")
    weights_dtype = torch.bfloat16 if bf16 else torch.float32
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    seconds, finals = [], []

    if mode == "episode":
        wrapper = make_fused_cfg_episode(model, schedule, inputs_stats, cond_stats, plant, cost,
                                         n_steps=n_steps, w=CFG_W,
                                         n_diffusion_steps_without_noise=N_TAIL,
                                         weights_dtype=weights_dtype, device=dev)
        draw = lambda: torch.randn(wrapper.noise_shape, generator=gen, device=dev)
        wrapper(x0, draw())
        sync()
        for _ in range(n_best):  # pipelined: independent episodes, one sync per batch
            t0 = time.perf_counter()
            outs = [wrapper(x0, draw()) for _ in range(n_rep)]
            sync()
            seconds.append(time.perf_counter() - t0)
            finals += [x_track[-1] for x_track, _, _ in outs]
        pipelined = seconds[:]
        for _ in range(n_best):  # sustained: each episode starts where the last one ended
            x_cur = x0
            t0 = time.perf_counter()
            for _ in range(n_chain):
                x_track, _, _ = wrapper(x_cur, draw())
                x_cur = x_track[-1]
            sync()
            seconds.append(time.perf_counter() - t0)
            finals.append(x_cur)
        control_hz = n_chain * n_steps / min(seconds[n_best:])
        line = {"metric": "closed_loop_control_hz", "value": round(control_hz, 1), "unit": "Hz",
                "vs_baseline": round(control_hz / BASELINE_CONTROL_HZ, 2),
                "pipelined_hz": round(n_steps * n_rep / min(pipelined), 1), "protocol": PROTOCOL}
    else:
        wrapper, denoise, sample_override = None, model, None
        if mode == "chain":
            wrapper = sample_override = make_fused_cfg_chain(
                model, schedule, n_samples=1, w=CFG_W, n_tail=N_TAIL,
                weights_dtype=weights_dtype, device=dev)
        elif mode == "1":
            wrapper = denoise = make_fused_unet(model, batch_size=2, device=dev)
        loop = make_closed_loop(GaussianDiffusion(schedule), denoise, inputs_stats, cond_stats,
                                plant, cost, horizon=HORIZON, n_steps=n_steps, w=CFG_W,
                                n_diffusion_steps_without_noise=N_TAIL,
                                sample_override=sample_override, device=dev)
        loop(x0, generator=gen)
        sync()
        t0 = time.perf_counter()
        results = [loop(x0, generator=gen) for _ in range(n_rep)]
        sync()
        seconds.append(time.perf_counter() - t0)
        finals += [r.x_track[-1] for r in results]
        control_hz = n_steps * n_rep / seconds[0]
        line = {"metric": "closed_loop_control_hz", "value": round(control_hz, 1), "unit": "Hz",
                "vs_baseline": round(control_hz / BASELINE_CONTROL_HZ, 2)}

    if not torch.isfinite(torch.stack(finals)).all():
        raise RuntimeError(f"bench {mode}: non-finite final states")
    launches, plain_calls = (wrapper.launches, wrapper.plain_calls) if wrapper else (0, 0)
    n = expected_calls(mode, n_steps, n_rep, n_chain, n_best)
    if (launches, plain_calls) != ((n, 0) if cuda else (0, n)):
        raise RuntimeError(f"bench {mode}: {launches} kernel launches and {plain_calls} plain "
                           f"calls on {dev.type}; expected {n} "
                           f"{'launches' if cuda else 'plain calls'} and nothing else")
    name = type(wrapper).__name__ if wrapper else None
    return BenchResult(line, bf16, torch.cuda.get_device_name(dev) if cuda else "cpu", name,
                       launches, plain_calls, seconds)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def main() -> BenchResult:
    """Runs the protocol on the card with ``bench.py``'s counts, the mode
    from ``BENCH_FUSED`` (default ``episode``) and bf16 weights where
    ``BENCH_BF16`` is ``1``; prints the mode and the card, then the JSON
    line last."""
    mode = os.environ.get("BENCH_FUSED", "episode")
    bf16 = os.environ.get("BENCH_BF16", "0") == "1"
    res = run(mode, bf16)
    print(f"bench: BENCH_FUSED={mode} weights={'bf16' if res.bf16 else 'fp32'} kernel="
          f"{res.wrapper} launches={res.launches} on {res.device}; nvidia-smi: {nvidia_smi()}",
          flush=True)
    print(json.dumps(res.line), flush=True)
    return res


if __name__ == "__main__":
    main()
