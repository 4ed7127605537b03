#!/usr/bin/env python3
"""Count the PyTorch operations the full constrained step dispatches, by
stage, on the CPU:

    python3 scripts/torch_step_op_count.py

The full-step iLQR (``ilqr_solve_batch`` without classes) runs this step
eagerly, one launch per operation on the card, so its host time follows
these counts. For the limited cartpole (a limit row open, and every row
closed, where ``boxed_lcp`` returns 0 without the direct solve) and for
the jump worm it counts the aten operations of ``contact_step``'s stages
(forward kinematics, ABA, collision, the constraint rows, the LCP solve,
the position update), of the whole step, and of one ``vmap(jacfwd)`` of
the step over a batch of points (a linearization chunk). K7 is replaced by
a one-operation stand-in, so the worm's LCP counts its wrapper's work
only. Counts, not times: a CPU run gives no device time.
"""

import collections
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from nimblephysics_tpu_torch.models import builders  # noqa: E402
from nimblephysics_tpu_torch.models.model import State  # noqa: E402
from nimblephysics_tpu_torch.ops import contact as tc  # noqa: E402
from nimblephysics_tpu_torch.ops import cuda_lcp  # noqa: E402
from nimblephysics_tpu_torch.ops import dynamics as dyn  # noqa: E402
from nimblephysics_tpu_torch.ops import lcp as tl  # noqa: E402
from nimblephysics_tpu_torch.ops.collide import detect_contacts  # noqa: E402
from nimblephysics_tpu_torch.simulation.step import integrate_positions  # noqa: E402
from nimblephysics_tpu_torch.trajectory.ilqr import _full_step_dyn  # noqa: E402


class Count(TorchDispatchMode):
    """The aten operations dispatched inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def count(fn):
    with Count() as c:
        fn()
    return sum(c.ops.values())


def stages(model, x, u):
    s = State.from_flat(x)
    tau = model.action_to_tau(u)
    kin = dyn.forward_kinematics(model, s.q)
    v_star = s.v + model.dt * dyn.aba(model, s.q, s.v, tau, kin=kin)
    contacts = detect_contacts(model, kin.T_wb)
    _, A, b, lo, hi, fs, _ = tc.build_constraint_system(model, s.q, v_star, kin, contacts)
    method = "gs" if tc.total_slots(model) else "direct"
    return {
        "forward kinematics": count(lambda: dyn.forward_kinematics(model, s.q)),
        "ABA": count(lambda: dyn.aba(model, s.q, s.v, tau, kin=kin)),
        "collision": count(lambda: detect_contacts(model, kin.T_wb)),
        "constraint rows": count(lambda: tc.build_constraint_system(model, s.q, v_star, kin,
                                                                    contacts)),
        f"LCP ({method})": count(lambda: tl.boxed_lcp(A, b, lo, hi, fs, torch.zeros_like(b),
                                                      tc.lcp_findex(model), 60, method)),
        "position update": count(lambda: integrate_positions(model, s.q, s.v)),
        "contact_step": count(lambda: tc.contact_step(model, s, tau)),
    }


def main() -> int:
    cuda_lcp.pgs_batched_plain = lambda A, b, lo, hi, fs, x0, findex, iters=60: b.clone()
    cart = builders.cartpole(dt=0.02, device="cpu")
    worm = builders.jump_worm(dt=0.001, device="cpu")
    cases = []
    x = torch.zeros(6, 4)
    x[:, 0], x[:, 2] = 1.02, 1.0               # past the cart's upper limit, moving out
    cases.append(("cartpole, a limit row open, 6 points", cart, x, torch.zeros(6, 1)))
    cases.append(("cartpole, every row closed, 6 points", cart, torch.zeros(6, 4),
                  torch.zeros(6, 1)))
    x = torch.zeros(64, 8)
    x[:, 1] = -0.5                             # on the floor
    cases.append(("jump worm, 64 points", worm, x, torch.zeros(64, 2)))
    for label, model, x, u in cases:
        tc.contact_step(model, State.from_flat(x), model.action_to_tau(u))
        counts = stages(model, x, u)
        jac = torch.func.vmap(torch.func.jacfwd(_full_step_dyn(model, True), argnums=(0, 1)))
        counts["vmap(jacfwd) of the step"] = count(lambda: jac(x, u))
        print(f"{label}: " + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
