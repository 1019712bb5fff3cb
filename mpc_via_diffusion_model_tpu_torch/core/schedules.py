"""Diffusion variance schedules and DDPM coefficient tables.

Port of ``mpc_via_diffusion_model_tpu/core/schedules.py``. The math runs in
float64 numpy and is cast to float32 torch tensors at the end, as there.
Kept quirks: the exponential schedule's ``linspace(0, n, n)`` grid (its last
beta equals ``beta_end``) and the ``_ALPHAS_CUMPROD_FLOOR`` that keeps
``1/sqrt(alphas_cumprod)`` finite.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["DiffusionSchedule", "BETA_SCHEDULES", "make_schedule"]

_ALPHAS_CUMPROD_FLOOR = 1e-12


def linear_beta_schedule(n_steps: int, beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, n_steps, dtype=np.float64)


def quadratic_beta_schedule(n_steps: int, beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5, n_steps, dtype=np.float64) ** 2


def sigmoid_beta_schedule(n_steps: int, beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    x = np.linspace(-6.0, 6.0, n_steps, dtype=np.float64)
    return 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start


def cosine_beta_schedule(n_steps: int, s: float = 0.008, a_min: float = 0.0, a_max: float = 0.999) -> np.ndarray:
    steps = n_steps + 1
    x = np.linspace(0, steps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, a_min, a_max)


def exponential_beta_schedule(n_steps: int, beta_start: float = 1e-4, beta_end: float = 1.0) -> np.ndarray:
    """The cart-pole production schedule; the grid is ``linspace(0, n, n)``
    so the exponent reaches ``n`` and the last beta equals ``beta_end``."""
    x = np.linspace(0, n_steps, n_steps, dtype=np.float64)
    a = (1.0 / n_steps) * np.log(beta_end / beta_start)
    return beta_start * np.exp(a * x)


def constant_fraction_beta_schedule(n_steps: int) -> np.ndarray:
    x = np.linspace(0, n_steps, n_steps, dtype=np.float64)
    return 1.0 / (n_steps - x + 1.0)


def variance_preserving_beta_schedule(n_steps: int, beta_start: float = 1e-4, beta_end: float = 1.0) -> np.ndarray:
    x = np.linspace(0, n_steps, n_steps, dtype=np.float64)
    alphas = np.exp(
        -beta_start * (1.0 / n_steps)
        - 0.5 * (beta_end - beta_start) * (2.0 * x - 1.0) / (n_steps ** 2)
    )
    return 1.0 - alphas


BETA_SCHEDULES: Dict[str, Callable[..., np.ndarray]] = {
    "linear": linear_beta_schedule,
    "quadratic": quadratic_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
    "cosine": cosine_beta_schedule,
    "exponential": exponential_beta_schedule,
    "constant_fraction": constant_fraction_beta_schedule,
    "variance_preserving": variance_preserving_beta_schedule,
}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM coefficient tables, one float32 CPU tensor of length T each.
    Samplers move the tables they need to their own device."""

    n_steps: int
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor


def make_schedule(name: str, n_steps: int, **kwargs) -> DiffusionSchedule:
    if name not in BETA_SCHEDULES:
        raise ValueError(f"unknown beta schedule '{name}'; have {sorted(BETA_SCHEDULES)}")
    betas = np.asarray(BETA_SCHEDULES[name](n_steps, **kwargs), dtype=np.float64)
    alphas = np.maximum(1.0 - betas, 0.0)
    alphas_cumprod = np.maximum(np.cumprod(alphas), _ALPHAS_CUMPROD_FLOOR)
    alphas_cumprod_prev = np.concatenate([np.ones(1), alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return DiffusionSchedule(
        n_steps=n_steps,
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
    )
