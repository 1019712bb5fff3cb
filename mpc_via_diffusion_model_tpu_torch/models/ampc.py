"""The AMPC baseline: port of ``mpc_via_diffusion_model_tpu/models/ampc.py``.

A tanh MLP that regresses the whole normalized control horizon from the
normalized plant state, the reference's ``AMPCNet``: state_dim -> 2 -> 50 ->
50 -> horizon * control_dim by default, the 2-unit bottleneck included,
reshaped to (B, horizon, control_dim). Its output feeds the plant directly,
so its matmuls stay fp32 (``utils/device.py``: TF32 off). The flax layout
(``Dense_i``) and the initializers are in ``models/weights.py``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

__all__ = ["AMPCNet"]


class AMPCNet(nn.Module):
    """``hidden`` defaults to the reference's (2, 50, 50); ``state_dim`` is
    the input width, which the flax module infers at its first call."""

    def __init__(self, horizon: int, control_dim: int = 1, hidden: Sequence[int] = (2, 50, 50),
                 state_dim: int = 5):
        super().__init__()
        self.horizon, self.control_dim = int(horizon), int(control_dim)
        self.hidden, self.state_dim = tuple(int(h) for h in hidden), int(state_dim)
        widths = (self.state_dim,) + self.hidden
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.out = nn.Linear(widths[-1], self.horizon * self.control_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, state_dim) normalized -> (B, horizon, control_dim) normalized."""
        h = x
        for layer in self.layers:
            h = torch.tanh(layer(h))
        return self.out(h).reshape(x.shape[0], self.horizon, self.control_dim)
