"""Receding-horizon MPC: the ``MPCLocal`` equivalent.

PyTorch counterpart of ``nimblephysics_tpu/realtime/mpc.py``. A planner
loop {estimate the state at a rounded future time, advance the plan,
re-optimize warm, publish the new plan} runs beside a control thread that
reads ``control_now``. Each replan is one ``ilqr_solve_batch`` call at
B = 1 (semantically ``vmap(ilqr_solve)``): on the card its linearize (K3),
Riccati backward (K1) and line-search rollout (K2) run as CUDA kernels,
on the CPU their plain versions; a planning model with constraint rows
takes the full constrained step (jacfwd of the step, K1, rollouts of the
step; K7 for the LCPs of a model with contact slots). Warm starting is
the shifted previous solution (``Problem::advanceSteps`` +
``Solution::reoptimize``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from nimblephysics_tpu_torch._device import model_device, resolve_device
from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.realtime.buffer import (
    ControlPlan,
    VectorLog,
    control_at,
    estimate_state_at,
)
from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost
from nimblephysics_tpu_torch.trajectory.ilqr import ILQRConfig, ilqr_solve_batch


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """The JAX package's MPCConfig without ``unroll``, its scan's unroll
    knob, which has no meaning in eager PyTorch."""

    horizon: int = 100
    replan_iters: int = 8           # iLQR iterations per replan (warm-started)
    first_solve_iters: int = 40     # cold-start iterations for the first plan
    use_feedback_gains: bool = True


class MPC:
    """Host-side receding-horizon controller around the batched iLQR
    replan."""

    def __init__(
        self,
        model: Model,
        running_cost: Callable,
        final_cost: Callable,
        config: MPCConfig = MPCConfig(),
        planning_model: Optional[Model] = None,
        device="cuda",
    ):
        """``model`` is the plant (state estimation steps it, limits and
        all); ``planning_model`` is what iLQR linearizes, the plant itself
        when None. A planning model with constraint rows plans on the full
        constrained step (``ilqr_solve_batch`` without classes: the LCP
        solved in every step and differentiated by its implicit rule);
        ``relax_limits(model)`` plans on the smooth dynamics while the plant
        keeps its limits. On the card the costs must be a QuadraticCost and
        a QuadraticFinalCost (the line-search kernel takes the cost as
        data). ``device`` is where the plan is made: "cuda" by default."""
        self.device = resolve_device(device)
        plan_model = planning_model if planning_model is not None else model
        if self.device.type == "cuda" and not (isinstance(running_cost, QuadraticCost)
                                               and isinstance(final_cost, QuadraticFinalCost)):
            raise TypeError("MPC: on the card the costs must be a QuadraticCost and a "
                            "QuadraticFinalCost (ROADMAP queue B, K2: other costs on the card)")
        for name, m in (("model", model), ("planning_model", plan_model)):
            self.device = model_device(f"MPC: {name}", m, device, "the plan")
        self.model = model
        self.plan_model = plan_model
        self.running_cost, self.final_cost = running_cost, final_cost
        self.config = config
        self.obs_log = VectorLog(2 * model.nq)
        self._plan: Optional[ControlPlan] = None
        self._dt = float(model.dt)
        self._zero_u = torch.zeros((config.horizon, model.num_actions), dtype=plan_model.dtype,
                                   device=self.device)

    def _replan(self, x0: torch.Tensor, u_warm: torch.Tensor, iters: int):
        sol = ilqr_solve_batch(self.plan_model, x0[None].contiguous(), u_warm[None].contiguous(),
                               self.running_cost, self.final_cost, ILQRConfig(iters=iters))
        return sol.u[0], sol.x[0], sol.K[0]

    # -- observation side (MPC::recordGroundTruthState, MPC.hpp:32) ---------
    def record_state(self, t: float, state: State) -> None:
        self.obs_log.record(t, state.flat())

    # -- control side (MPC::getControlForceNow, MPC.hpp:23) -----------------
    def control_now(self, t: float, state: Optional[State] = None) -> torch.Tensor:
        plan = self._plan
        if plan is None:
            return torch.zeros(self.model.num_actions, dtype=self.model.dtype,
                               device=self.device)
        x = state.flat() if state is not None else None
        return control_at(plan, t, x)

    # -- planner side -------------------------------------------------------
    def replan_at(self, now: float) -> float:
        """One optimizer-loop iteration (``MPCLocal::optimizePlan``).
        Returns the wall-clock seconds of the solve, ended by a
        synchronize on the card."""
        obs = self.obs_log.latest_before(now)
        if obs is None:
            return 0.0
        t_obs, x_obs = obs
        x_obs = torch.as_tensor(x_obs, dtype=self.model.dtype, device=self.device)

        t0 = time.perf_counter()
        if self._plan is None:
            start_time = now
            u, xs, K = self._replan(x_obs, self._zero_u, self.config.first_solve_iters)
        else:
            # round the plan start to the step grid ahead of `now`
            shift = max(1, int(np.ceil((now - self._plan.start_time) / self._dt)))
            start_time = self._plan.start_time + shift * self._dt
            x0 = estimate_state_at(self.model, self._plan, State.from_flat(x_obs), t_obs,
                                   start_time)
            # advanceSteps: shift the previous controls left, hold the tail
            u_prev = self._plan.u
            shift_c = min(shift, u_prev.shape[0] - 1)
            u_warm = torch.cat([u_prev[shift_c:], u_prev[-1:].expand(shift_c, -1)])
            u, xs, K = self._replan(x0.flat(), u_warm, self.config.replan_iters)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dur = time.perf_counter() - t0
        gains = self.config.use_feedback_gains
        self._plan = ControlPlan(start_time=start_time, dt=self._dt, u=u,
                                 x_ref=xs if gains else None, K=K if gains else None)
        return dur

    @property
    def plan(self) -> Optional[ControlPlan]:
        return self._plan


class AsyncMPC:
    """Background-replanning MPC: the ``MPCLocal`` concurrency model.

    A replanner thread drives ``MPC.replan_at`` and publishes each new plan
    twice: into the native seqlock ``RtControlBuffer`` (the lock-free path,
    ``control_now_native``) and as an atomic Python ``ControlPlan`` swap for
    the gain-feedback path (``control_now``), which never blocks on a
    replan in flight. The native library is built at first use; where it
    cannot be, the constructor raises."""

    def __init__(self, mpc: MPC, clock: Optional[Callable[[], float]] = None,
                 min_period: float = 0.0):
        from nimblephysics_tpu_torch.native import RtControlBuffer

        self.mpc = mpc
        self._clock = clock if clock is not None else time.monotonic
        self._min_period = min_period
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._replan_durations: list = []
        self._error: Optional[BaseException] = None
        self._buf = RtControlBuffer(mpc.config.horizon, mpc.model.num_actions)

    # -- observation / control side (robot threads) -------------------------
    def record_state(self, t: float, state: State) -> None:
        self.mpc.record_state(t, state)

    def control_now(self, t: float, state: Optional[State] = None) -> torch.Tensor:
        """Gain-feedback serving path: reads the atomically swapped plan."""
        return self.mpc.control_now(t, state)

    def control_now_native(self, t: float) -> Optional[np.ndarray]:
        """Lock-free open-loop serving path through the native seqlock
        buffer (RealTimeControlBuffer::getPlannedForce); None before the
        first plan. Safe from any thread."""
        return self._buf.control_at(t)[1]

    # -- planner thread ------------------------------------------------------
    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                dur = self.mpc.replan_at(self._clock())
                plan = self.mpc.plan
                if plan is not None:
                    self._buf.publish(plan.start_time, plan.dt, plan.u)
                if dur > 0:
                    self._replan_durations.append(dur)
                # MPCLocal sleeps only if the solve beat the plan horizon;
                # min_period rate-limits. Before the first observation
                # replan_at returns 0.0 at once: wait briefly rather than spin.
                wait = self._min_period - dur
                if dur <= 0.0:
                    wait = max(wait, 1e-3)
                if wait > 0:
                    self._stop.wait(wait)
        except BaseException as e:  # handed to the caller by stop()
            self._error = e

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._error = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the replanner thread; re-raises what ended it early."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("AsyncMPC: the replanner thread failed") from err

    @property
    def num_published(self) -> int:
        return self._buf.num_published

    @property
    def replan_durations(self):
        return list(self._replan_durations)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class Ticker:
    """Fixed-rate callback driver (``dart/realtime/Ticker``), synchronous
    variant for tests: ``run(n)`` invokes the callbacks n times at the given
    period against a simulated or real clock."""

    def __init__(self, period: float, realtime: bool = False):
        self.period = period
        self.realtime = realtime
        self._callbacks = []

    def register(self, fn: Callable[[float], None]) -> None:
        self._callbacks.append(fn)

    def run(self, steps: int, t0: float = 0.0) -> float:
        t = t0
        for _ in range(steps):
            for fn in self._callbacks:
                fn(t)
            if self.realtime:
                time.sleep(self.period)
            t += self.period
        return t
