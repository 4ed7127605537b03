"""Online system identification: the reference's ``SSID``.

PyTorch counterpart of ``nimblephysics_tpu/realtime/ssid.py``. The model's
masses are differentiable tensors, so the fit is direct: Adam on the mean
squared error between ``rollout(masses; q0, v0, controls)`` and the
observed states of one logged window. A constrained model rolls out on the
full step with warm starts, the LCP differentiated by its implicit rule
(K7 on the card, once per step of every iteration's rollout).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from nimblephysics_tpu_torch._device import model_device
from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.simulation.step import rollout
from nimblephysics_tpu_torch.utils.optim import adam_init, adam_update, apply_updates


@dataclasses.dataclass(frozen=True)
class SSIDConfig:
    iters: int = 200
    lr: float = 5e-2
    log_space: bool = True   # optimize log-masses (positive, scale-free)


class SSID:
    """Fits a model's body masses to logged windows. ``device`` is where the
    fit runs: "cuda" by default (raising without a card); the model must
    lie there."""

    def __init__(self, model: Model, config: SSIDConfig = SSIDConfig(), device="cuda"):
        self.device = model_device("SSID: the model", model, device)
        self.model = model
        self.config = config

    def _masses(self, theta: torch.Tensor) -> torch.Tensor:
        return torch.exp(theta) if self.config.log_space else theta

    def identify_masses(self, q0, v0, controls, observed_q, observed_v
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fit the body masses to one window: q0, v0 (nq,), controls (T, na),
        observed_q / observed_v (T, nq), the states after each step.
        Returns (masses, the loss before each of the ``iters`` updates).
        Adam with optax's semantics (``utils/optim.py``); the initial state
        gets no gradient."""
        dtype, dev = self.model.dtype, self.device
        q0, v0, us, obs_q, obs_v = (torch.as_tensor(t, dtype=dtype, device=dev)
                                    for t in (q0, v0, controls, observed_q, observed_v))
        m0 = self.model.mass
        params = {"theta": torch.log(m0) if self.config.log_space else m0.clone()}
        opt_state = adam_init(params)
        hist = []
        for _ in range(self.config.iters):
            theta = params["theta"].detach().requires_grad_(True)
            _, traj = rollout(self.model.replace(mass=self._masses(theta)), State(q0, v0), us)
            loss = torch.mean((traj.q - obs_q) ** 2) + torch.mean((traj.v - obs_v) ** 2)
            (g,) = torch.autograd.grad(loss, theta)
            hist.append(loss.detach())
            updates, opt_state = adam_update({"theta": g}, opt_state, self.config.lr)
            params = apply_updates({"theta": params["theta"].detach()}, updates)
        return self._masses(params["theta"]), torch.stack(hist)
