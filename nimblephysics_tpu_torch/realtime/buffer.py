"""Control plan buffers: a functional ``RealTimeControlBuffer``.

PyTorch counterpart of ``nimblephysics_tpu/realtime/buffer.py``. The
planner produces an immutable ``ControlPlan`` of tensors on the plan's
device; swapping the buffer is one reference assignment on the host, so no
lock protocol is needed. The native seqlock buffer (``native``) serves the
plan's controls to threads that must not take the GIL.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class ControlPlan(NamedTuple):
    """A timestamped receding-horizon plan.

    u: (H, na) planned controls starting at ``start_time``
    K: optional (H, na, nx) feedback gains and x_ref (H+1, nx): when
       present, ``control_at`` applies time-varying LQR feedback around the
       reference trajectory.
    """

    start_time: float
    dt: float
    u: torch.Tensor
    x_ref: Optional[torch.Tensor] = None
    K: Optional[torch.Tensor] = None


def plan_index(plan: ControlPlan, t: float) -> int:
    """Index of the control slot covering wall time t (clamped to the plan)."""
    i = int(np.floor((t - plan.start_time) / plan.dt))
    return max(0, min(i, plan.u.shape[0] - 1))


def control_at(plan: ControlPlan, t: float, x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The control to apply at time t (``MPC::getControlForceNow``).

    With gains and a current state estimate x, serves u_i + K_i (x - x_ref_i):
    a first-order hold against replan latency."""
    i = plan_index(plan, t)
    u = plan.u[i]
    if plan.K is not None and plan.x_ref is not None and x is not None:
        u = u + plan.K[i] @ (x - plan.x_ref[i])
    return u


def estimate_state_at(model, plan: ControlPlan, state, state_time: float, t: float):
    """``RealTimeControlBuffer::estimateWorldStateAt``: roll the last
    observed state forward under the planned controls to wall time t, on
    the plant's own step (``simulation/step.py`` ``step``; the full
    constrained step on a model with limits)."""
    from nimblephysics_tpu_torch.simulation.step import step

    n = max(0, int(round((t - state_time) / plan.dt)))
    s = state
    for k in range(n):
        tk = state_time + k * plan.dt
        s = step(model, s, control_at(plan, tk, s.flat()))
    return s


class VectorLog:
    """Time-indexed ring log (ControlLog/VectorLog/ObservationLog,
    dart/realtime/), on the host in numpy."""

    def __init__(self, dim: int, capacity: int = 4096):
        self.times = np.zeros(capacity)
        self.values = np.zeros((capacity, dim))
        self.capacity = capacity
        self.count = 0

    def record(self, t: float, value) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        i = self.count % self.capacity
        self.times[i] = t
        self.values[i] = np.asarray(value)
        self.count += 1

    def latest_before(self, t: float):
        n = min(self.count, self.capacity)
        if n == 0:
            return None
        times = self.times[:n]
        mask = times <= t
        if not mask.any():
            return None
        i = int(np.argmax(np.where(mask, times, -np.inf)))
        return float(times[i]), self.values[i].copy()

    def window(self, t0: float, t1: float):
        n = min(self.count, self.capacity)
        sel = (self.times[:n] >= t0) & (self.times[:n] <= t1)
        order = np.argsort(self.times[:n][sel])
        return self.times[:n][sel][order], self.values[:n][sel][order]
