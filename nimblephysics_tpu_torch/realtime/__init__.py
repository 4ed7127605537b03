"""Real-time control: receding-horizon MPC and control buffers.

PyTorch counterpart of ``nimblephysics_tpu/realtime`` (``dart/realtime/``:
MPCLocal, RealTimeControlBuffer, Ticker, ObservationLog) and online system
identification (``SSID``: masses fitted to a logged window by Adam through
the differentiable rollout)."""

from nimblephysics_tpu_torch.realtime.buffer import (  # noqa: F401
    ControlPlan,
    VectorLog,
    control_at,
    estimate_state_at,
    plan_index,
)
from nimblephysics_tpu_torch.realtime.mpc import MPC, AsyncMPC, MPCConfig, Ticker  # noqa: F401
from nimblephysics_tpu_torch.realtime.ssid import SSID, SSIDConfig  # noqa: F401
