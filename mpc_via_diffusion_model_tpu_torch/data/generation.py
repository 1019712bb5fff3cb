"""Expert datasets of the LQR-solvable plants: port of the LMPC part of
``mpc_via_diffusion_model_tpu/data/generation.py`` (``collect_lmpc_dataset``).

The open-loop LQR expert over a grid of initial states and, optionally,
Gaussian noisy replicas of every grid state, solved in one batched pass.
The closed-loop (iLQR) collection waits for the port of the nonlinear
solvers (ROADMAP.md A6).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..solvers.lqr import lqr_solve_batched
from .normalization import NormalizerStats, canonical_kind, fit_normalizer

__all__ = ["LmpcDataset", "collect_lmpc_dataset"]


@dataclasses.dataclass(frozen=True)
class LmpcDataset:
    inputs: torch.Tensor             # (N, H, m) the expert's control sequences
    condition: torch.Tensor          # (N, n) the states they were solved from
    inputs_stats: NormalizerStats    # fitted on the CPU
    condition_stats: NormalizerStats


def collect_lmpc_dataset(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                         p: torch.Tensor, x0_grid, horizon: int, noise_std: float = 0.0,
                         n_noisy: int = 0, noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         normalizer: str = "LimitsNormalizer") -> LmpcDataset:
    """The LQR expert's horizons from every state of ``x0_grid`` (N, n) and,
    with ``n_noisy`` > 0, from ``n_noisy`` replicas of the grid, each state
    plus ``noise_std`` times a standard normal draw: ``noise`` (n_noisy, N,
    n) when given (e.g. the JAX package's draws), else drawn from
    ``generator``. The replicas follow the grid, replica by replica, as in
    the JAX package. Runs on the device of ``a``; the statistics are
    ``fit_normalizer``'s of the ``normalizer`` kind."""
    dev = a.device
    x0s = torch.as_tensor(np.asarray(x0_grid, np.float32), device=dev)
    if n_noisy > 0:
        shape = (n_noisy, *x0s.shape)
        if noise is None:
            noise = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise must be {shape}, got {tuple(noise.shape)}")
        noisy = x0s[None] + noise.to(dev, torch.float32) * noise_std
        x0s = torch.cat([x0s, noisy.reshape(-1, x0s.shape[-1])])
    us = lqr_solve_batched(a, b, q, r, p, x0s, horizon).us
    kind = canonical_kind(normalizer)
    return LmpcDataset(us, x0s, fit_normalizer(us.cpu().numpy(), kind),
                       fit_normalizer(x0s.cpu().numpy(), kind))
