"""Gradient oracles: the differentiable step's Jacobians and mappings.

PyTorch counterpart of ``nimblephysics_tpu/neural`` (the reference's
``dart/neural``): the six step Jacobians, ``backprop_state`` with the
saddle-point escape, and the world-space mappings and IK."""

from nimblephysics_tpu_torch.neural.jacobians import (  # noqa: F401
    StepJacobians,
    backprop_state,
    step_jacobians,
)
from nimblephysics_tpu_torch.neural.mappings import (  # noqa: F401
    IKMapping,
    ik_solve,
    marker_positions,
)
