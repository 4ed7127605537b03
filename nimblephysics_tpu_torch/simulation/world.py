"""The end-user API: ``timestep`` and the stateful ``World``.

PyTorch counterpart of ``nimblephysics_tpu/simulation/world.py``, and of
Nimble's ``nimble.timestep(world, state, action)``. ``timestep`` is the
differentiable step itself: autograd and ``torch.func`` flow through it,
through the boxed LCP by its implicit rule (``ops/lcp.py``
``_ImplicitLCP``), which is what Nimble's timestep autograd function
computes. ``World`` holds a model, its current state, time and frame
counters and a ``Recording`` of the states, on the model's device; every
getter returns tensors.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from nimblephysics_tpu_torch._device import model_device
from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.simulation.step import step as _step


def timestep(model: Model, state: State, action: torch.Tensor) -> State:
    """One step of ``model`` from ``state`` under ``action``; the state
    (..., nq) and the action (..., na) may carry leading batch
    dimensions."""
    return _step(model, state, action)


class Recording:
    """The states a World passed through, in order."""

    def __init__(self):
        self._states: List[State] = []

    def add(self, state: State) -> None:
        self._states.append(state)

    def __len__(self) -> int:
        return len(self._states)

    def state(self, i: int) -> State:
        return self._states[i]

    def poses(self) -> torch.Tensor:
        """(len, nq) positions."""
        return torch.stack([s.q for s in self._states])

    def vels(self) -> torch.Tensor:
        """(len, nq) velocities."""
        return torch.stack([s.v for s in self._states])

    def clear(self) -> None:
        self._states.clear()


class World:
    """An imperative holder of (Model, State) with the RL-style API of
    Nimble's ``World`` (World.hpp:483-520). ``device`` (default "cuda")
    must be the model's; states and actions given as arrays or lists are
    made tensors of the model's dtype there, and every getter returns a
    tensor on it."""

    def __init__(self, model: Model, state: Optional[State] = None, device="cuda"):
        self.device = model_device("World's model", model, device, "the world steps")
        self.model = model
        zero = torch.zeros(model.nq, dtype=model.dtype, device=self.device)
        self.state = state or State(q=zero, v=zero.clone())
        self.time = 0.0
        self.frame = 0
        self.recording = Recording()

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.model.dtype, device=self.device)

    def get_state(self) -> torch.Tensor:
        """The flat state (q, v)."""
        return self.state.flat()

    def set_state(self, x) -> None:
        self.state = State.from_flat(self._t(x))

    def get_positions(self) -> torch.Tensor:
        return self.state.q

    def set_positions(self, q) -> None:
        self.state = State(self._t(q), self.state.v)

    def get_velocities(self) -> torch.Tensor:
        return self.state.v

    def set_velocities(self, v) -> None:
        self.state = State(self.state.q, self._t(v))

    @property
    def action_size(self) -> int:
        return self.model.num_actions

    def step(self, action=None, record: bool = True) -> State:
        """Advance one step under ``action`` (zeros when None)."""
        a = (torch.zeros(self.model.num_actions, dtype=self.model.dtype, device=self.device)
             if action is None else self._t(action))
        self.state = _step(self.model, self.state, a)
        self.time += float(self.model.dt)
        self.frame += 1
        if record:
            self.recording.add(self.state)
        return self.state

    def reset(self, state: Optional[State] = None) -> None:
        if state is not None:
            self.state = state
        self.time = 0.0
        self.frame = 0
        self.recording.clear()

    def state_jacobian(self, action) -> torch.Tensor:
        """d(next flat state) / d(flat state) at the current state
        (``World::getStateJacobian``), by reverse mode."""
        a = self._t(action)
        return torch.func.jacrev(
            lambda x: _step(self.model, State.from_flat(x), a).flat())(self.state.flat())

    def action_jacobian(self, action) -> torch.Tensor:
        """d(next flat state) / d(action) at the current state."""
        return torch.func.jacrev(
            lambda act: _step(self.model, self.state, act).flat())(self._t(action))
