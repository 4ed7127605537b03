"""Real-time control: receding-horizon MPC and control buffers.

PyTorch counterpart of ``nimblephysics_tpu/realtime`` (``dart/realtime/``:
MPCLocal, RealTimeControlBuffer, Ticker, ObservationLog). Online system
identification (``SSID``) waits for the implicit boxed-LCP derivative
(ROADMAP queue A, M4 (a) and M7)."""

from nimblephysics_tpu_torch.realtime.buffer import (  # noqa: F401
    ControlPlan,
    VectorLog,
    control_at,
    estimate_state_at,
    plan_index,
)
from nimblephysics_tpu_torch.realtime.mpc import MPC, AsyncMPC, MPCConfig, Ticker  # noqa: F401
