"""Times the kernels that run one row-set (rows 2, 4 and 5 of PERF.md's
kernel table: the U-Net pass, the DDIM chain, the DDIM episode) on the card,
for comparing two checkouts in turns, e.g. one whose kernels launch with the
one-row-set plan of shared memory against one whose kernels launch with the
two-row-set plan:

- ``fused_unet``: one pass of the flagship at batch 2, the launch alone
  (``FusedUnet._launch`` on prepared tensors) by CUDA events around 200 calls;
- ``ddim_chain``: the cart-pole student's chain on [23] at B = 1, the launch
  alone (``FusedDdimChain._launch``), 200 calls;
- ``ddim_episode``: the student's 80-replan episode at K = 1 on staged noise,
  the whole call, 10 calls;
- ``ddim_episode_quadrotor``: the quadrotor student's 60-replan episode at
  K = 1, the whole call, 10 calls.

Each row carries the shared memory per CTA its wrapper launches with. It
uses only what both kinds of checkout have, and imports and builds the port
of ``--root`` (its ``build/``), so run it as a file from the repository
root, one process per checkout::

    python3 mpc_via_diffusion_model_tpu_torch/scripts/plan_timing.py [--root DIR] [--label NAME]

It prints one JSON line: the label, the card, nvidia-smi's name and power
limit, and the rows. It needs a card and the artifacts of this repository.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
N_CALL, N_EPISODE = 200, 10


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` by CUDA events around ``n`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _smem(wrapper) -> int:
    """The shared memory per CTA the wrapper launches with (a chain's or the
    pass's plan was ``packed.smem_bytes`` before the plans per row-set)."""
    return int(getattr(wrapper, "smem_bytes", None) or wrapper.packed.smem_bytes)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose package and kernels are timed (default: this one)")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("plan_timing: no CUDA device; it times the kernels on an NVIDIA GPU")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import mpc_via_diffusion_model_tpu_torch as pkg
    from mpc_via_diffusion_model_tpu_torch.core import make_schedule
    from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
    from mpc_via_diffusion_model_tpu_torch.data.quadrotor_stats import quadrotor_stats
    from mpc_via_diffusion_model_tpu_torch.data.teacher_stats import teacher_stats
    from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_collect_cost,
                                                            cartpole_virtual_swingup, quadrotor,
                                                            quadrotor_cost, theta_to_red_theta)
    from mpc_via_diffusion_model_tpu_torch.models import (load_flagship, load_quadrotor_student,
                                                          load_student)
    from mpc_via_diffusion_model_tpu_torch.ops import _build
    from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import make_fused_ddim_chain
    from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import make_fused_ddim_episode
    from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import make_fused_unet
    if Path(pkg.__file__).resolve().parents[1] != root:
        raise SystemExit(f"plan_timing: imported {pkg.__file__}, not the package under {root}")
    _build.build_all(("fused_unet", "ddim_chain", "ddim_episode", "ddim_episode_quadrotor"))
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    art = REPO / "artifacts"
    gen = torch.Generator(device=dev).manual_seed(0)
    schedule = make_schedule("exponential", 25)
    rows = []

    # the U-Net pass: the flagship at batch 2
    unet = make_fused_unet(load_flagship(art / "flagship" / "ema_params.pkl", device=dev), 2,
                           device=dev)
    x = torch.randn((2, 32, 1), generator=gen, device=dev)
    t = torch.tensor([5, 5], device=dev)
    ctx = torch.randn((2, 5), generator=gen, device=dev)
    mask = torch.tensor([[0.0], [1.0]], device=dev)
    unet.kernel(x, t, ctx, mask)
    films = unet.films(unet.model.conditioning(t, ctx, mask)).contiguous()
    y = torch.empty((2, 32, unet.model.unet_input_dim), device=dev)
    rows.append({"kernel": "fused_unet", "shape": "flagship H=32, batch 2",
                 "smem_bytes": _smem(unet),
                 "launch_ms": cuda_ms(lambda: unet._launch(unet.cluster.weights, films, x, y),
                                      N_CALL)})

    # the DDIM chain: the cart-pole student on [23] at B = 1
    student = load_student(art / "onpolicy_cartpole" / "student_1eval.pkl", device=dev)
    chain = make_fused_ddim_chain(student, schedule, [23], n_samples=1, device=dev)
    sctx = torch.rand((1, 5), generator=gen, device=dev) * 2 - 1
    x_init = torch.randn(chain.noise_shape, generator=gen, device=dev)
    chain.kernel(sctx, x_init)
    out = torch.empty(chain.noise_shape, device=dev)
    cfilms = chain.films(sctx).contiguous()
    rows.append({"kernel": "ddim_chain", "shape": "cart-pole student H=32, [23], B=1",
                 "smem_bytes": _smem(chain),
                 "launch_ms": cuda_ms(lambda: chain._launch(chain.cluster.weights, cfilms, x_init,
                                                            out), N_CALL)})

    # the DDIM episode: the cart-pole student, 80 replans at K = 1
    ins, cond = (s.to(dev) for s in teacher_stats())
    ep = make_fused_ddim_episode(student, schedule, [23], ins, cond, cartpole_virtual_swingup(),
                                 cartpole_virtual_collect_cost(), n_steps=80, device=dev)
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    noise = torch.randn(ep.noise_shape, generator=gen, device=dev)
    rows.append({"kernel": "ddim_episode", "shape": "cart-pole student H=32, 80 replans, K=1",
                 "smem_bytes": ep.smem_bytes,
                 "call_ms": cuda_ms(lambda: ep.kernel(x0, noise), N_EPISODE, warmup=1)})

    # the quadrotor entry: its student, 60 replans at K = 1
    qins, qcond = (s.to(dev) for s in quadrotor_stats())
    qstudent = load_quadrotor_student(art / "onpolicy_quadrotor" / "student_1eval.pkl", device=dev)
    qep = make_fused_ddim_episode(qstudent, schedule, [23], qins, qcond, quadrotor(),
                                  quadrotor_cost(), n_steps=60, device=dev)
    qx0 = torch.tensor([0.0, 0.0, 1.0] + [0.0] * 9, device=dev)
    qnoise = torch.randn(qep.noise_shape, generator=gen, device=dev)
    rows.append({"kernel": "ddim_episode_quadrotor",
                 "shape": "quadrotor student H=48, 60 replans, K=1", "smem_bytes": qep.smem_bytes,
                 "call_ms": cuda_ms(lambda: qep.kernel(qx0, qnoise), N_EPISODE, warmup=1)})
    result = {"label": args.label, "root": str(root), "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "rows": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
