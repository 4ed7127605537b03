"""Quadratic costs with diagonal weights about a target state.

On the card the line-search rollout kernel takes the cost as data: these
two modules are the costs it accepts. On the CPU, and in the plain path,
any callable with the same signature works. The target ``x_goal`` (the
flat (q, v) state) defaults to zero, which leaves every result bit for bit
as without it (x - 0 is x).
"""

from __future__ import annotations

import torch
from torch import nn

from nimblephysics_tpu_torch.models.model import Model


def _weights(model: Model, w, n: int) -> torch.Tensor:
    t = torch.as_tensor(w, dtype=model.dtype, device=model.device)
    return t.expand(n).clone() if t.dim() == 0 else t.reshape(n).clone()


class QuadraticCost(nn.Module):
    """running_cost(x, u, t) = sum wq (q - q_goal)^2 + sum wv (v - v_goal)^2
    + sum wu u^2, with x the flat (q, v) state and x_goal = (q_goal,
    v_goal). Weights are scalars or per-dof/per-action."""

    def __init__(self, model: Model, wq=0.0, wv=0.0, wu=0.0, x_goal=0.0):
        super().__init__()
        self.register_buffer("wq", _weights(model, wq, model.nq))
        self.register_buffer("wv", _weights(model, wv, model.nq))
        self.register_buffer("wu", _weights(model, wu, model.num_actions))
        self.register_buffer("x_goal", _weights(model, x_goal, 2 * model.nq))

    def forward(self, x: torch.Tensor, u: torch.Tensor, t=None) -> torch.Tensor:
        nq = self.wq.shape[0]
        d = x - self.x_goal
        q, v = d[..., :nq], d[..., nq:]
        return ((self.wq * (q * q)).sum(-1) + (self.wv * (v * v)).sum(-1)
                + (self.wu * (u * u)).sum(-1))


class QuadraticFinalCost(nn.Module):
    """final_cost(x) = sum wx (x - x_goal)^2."""

    def __init__(self, model: Model, wx=0.0, x_goal=0.0):
        super().__init__()
        self.register_buffer("wx", _weights(model, wx, 2 * model.nq))
        self.register_buffer("x_goal", _weights(model, x_goal, 2 * model.nq))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x - self.x_goal
        return (self.wx * (d * d)).sum(-1)
