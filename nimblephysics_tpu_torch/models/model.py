"""Model and State: the world as data.

PyTorch counterpart of ``nimblephysics_tpu/models/model.py``: chains of
joints with joint limits, Coulomb joint friction and collision shapes
(``ShapeSpec``; the narrow phase of ops/collide.py covers box and sphere
against halfspace). ``Model`` holds the static topology as plain Python fields
(joint types, parents, names, the actuated dofs, each shape's kind and
body) and every numeric parameter as a tensor; all tensors of one model
lie on one device and have one dtype.

Bodies and joints are 1:1: body i's parent joint is joint i, and
``parents[i]`` is the parent body index (-1 = world), with parents[i] < i.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch._device import resolve_device
from nimblephysics_tpu_torch.ops.lie import Transform

# Number of dofs contributed by each joint type (as in the JAX package).
JOINT_NDOF = {
    "weld": 0,
    "revolute": 1,
    "prismatic": 1,
    "screw": 1,
    "universal": 2,
    "translational2d": 2,
    "translational": 3,
    "planar": 3,
    "ball": 3,
    "euler_xyz": 3,
    "euler_zyx": 3,
    "free": 6,
    "euler_free": 6,
    "ellipsoid": 3,
    "scapulathoracic": 4,
    "constant_curve": 4,
    "constant_curve_incompressible": 3,
}

SHAPE_KINDS = ("box", "sphere", "capsule", "halfspace", "convex", "heightmap",
               "cylinder", "cone", "trimesh", "pointcloud", "linesegment")


@dataclasses.dataclass(frozen=True, eq=False)
class ShapeSpec:
    """One collision shape on a body (``body_index`` -1: static world
    geometry such as a floor), with its friction and restitution.

    params by kind, as in the JAX package: box [sx, sy, sz, 0] full
    extents; sphere [r, 0, 0, 0]; halfspace [nx, ny, nz, offset], the plane
    n.x = offset in the shape frame with the solid below; the other kinds'
    narrow phase is not
    ported yet (ops/collide.py raises naming ROADMAP M4)."""

    kind: str
    body_index: int
    offset: Transform
    params: torch.Tensor            # (4,)
    friction: torch.Tensor          # ()
    restitution: torch.Tensor       # ()


def make_shape(kind: str, body_index: int, offset=None, params=(0.0, 0.0, 0.0, 0.0),
               friction=1.0, restitution=0.0, dtype=None, device="cpu") -> ShapeSpec:
    """A ShapeSpec from numbers or arrays (``offset`` a Transform of arrays,
    None for the identity), its tensors in ``dtype`` on ``device``."""
    if kind not in SHAPE_KINDS:
        raise ValueError(f"unknown shape kind {kind!r}")
    dtype = dtype or torch.get_default_dtype()

    def arr(x):
        return torch.as_tensor(np.array(x, dtype=np.float64), dtype=dtype, device=device)

    R, p = (np.eye(3), np.zeros(3)) if offset is None else (offset.R, offset.p)
    return ShapeSpec(kind=kind, body_index=int(body_index), offset=Transform(arr(R), arr(p)),
                     params=arr(params), friction=arr(friction), restitution=arr(restitution))


# Numeric leaves of a Model, in a fixed order (models/convert.py uses it).
LEAF_NAMES = (
    "T_pj.R", "T_pj.p", "T_cj.R", "T_cj.p", "axes", "mass", "com", "moment",
    "damping", "coulomb_friction", "stiffness", "rest_pos", "q_lower",
    "q_upper", "tau_lower", "tau_upper", "gravity", "dt",
)


class State(NamedTuple):
    """Generalized positions and velocities, each (..., nq)."""

    q: torch.Tensor
    v: torch.Tensor

    def flat(self) -> torch.Tensor:
        return torch.cat([self.q, self.v], dim=-1)

    @staticmethod
    def from_flat(x: torch.Tensor) -> "State":
        nq = x.shape[-1] // 2
        return State(q=x[..., :nq], v=x[..., nq:])


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    """A world: static topology plus tensor parameters."""

    joint_types: Tuple[str, ...]
    parents: Tuple[int, ...]
    joint_names: Tuple[str, ...]
    body_names: Tuple[str, ...]
    T_pj: Transform                 # joint frame in the parent body frame
    T_cj: Transform                 # joint frame in the child body frame
    axes: torch.Tensor              # (nb, 3, 3)
    mass: torch.Tensor              # (nb,)
    com: torch.Tensor               # (nb, 3)
    moment: torch.Tensor            # (nb, 3, 3) about the COM
    damping: torch.Tensor           # (nq,)
    coulomb_friction: torch.Tensor  # (nq,)
    stiffness: torch.Tensor         # (nq,)
    rest_pos: torch.Tensor          # (nq,)
    q_lower: torch.Tensor           # (nq,)
    q_upper: torch.Tensor           # (nq,)
    tau_lower: torch.Tensor         # (nq,)
    tau_upper: torch.Tensor         # (nq,)
    gravity: torch.Tensor           # (3,)
    dt: torch.Tensor                # ()
    actuated: Tuple[int, ...] = ()
    dof_names: Tuple[str, ...] = ()
    # Constraint topology read by ops/contact.lcp_dim. The port builds no
    # servos, mimic couplings or loop closures yet (ROADMAP M4): these stay
    # empty, and ops/contact.py refuses a model that has any.
    shapes: Tuple[ShapeSpec, ...] = ()
    servo_dofs: Tuple[int, ...] = ()
    mimic: Tuple[Tuple[int, int, float, float], ...] = ()
    loops: Tuple[Tuple[str, int, int], ...] = ()

    @property
    def num_bodies(self) -> int:
        return len(self.joint_types)

    @property
    def joint_ndofs(self) -> Tuple[int, ...]:
        return tuple(JOINT_NDOF[t] for t in self.joint_types)

    @property
    def dof_offsets(self) -> Tuple[int, ...]:
        offs, c = [], 0
        for nd in self.joint_ndofs:
            offs.append(c)
            c += nd
        return tuple(offs)

    @property
    def nq(self) -> int:
        return sum(self.joint_ndofs)

    @property
    def num_actions(self) -> int:
        return len(self.actuated)

    @property
    def device(self) -> torch.device:
        return self.mass.device

    @property
    def dtype(self) -> torch.dtype:
        return self.mass.dtype

    def joint_slice(self, i: int) -> slice:
        o = self.dof_offsets[i]
        return slice(o, o + self.joint_ndofs[i])

    def action_to_tau(self, action: torch.Tensor) -> torch.Tensor:
        """Map an action (..., na) onto the control forces (..., nq), built
        by stacking (no scatter) so that it runs under torch.func."""
        act = list(self.actuated)
        zero = action.new_zeros(action.shape[:-1])
        cols = [action[..., act.index(i)] if i in act else zero
                for i in range(self.nq)]
        return torch.stack(cols, dim=-1)

    def replace(self, **kwargs) -> "Model":
        return dataclasses.replace(self, **kwargs)

    def leaves(self) -> dict:
        """The numeric leaves by name (see LEAF_NAMES)."""
        out = {}
        for name in LEAF_NAMES:
            field, _, part = name.partition(".")
            val = getattr(self, field)
            out[name] = getattr(val, part) if part else val
        return out


def build_model(
    joints: Sequence[dict],
    gravity=(0.0, -9.81, 0.0),
    dt=0.002,
    shapes: Sequence[dict] = (),
    actuated: Optional[Sequence[int]] = None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> Model:
    """Assemble a Model from a list of per-joint dicts.

    Each dict: {type, name, parent (body index, -1 = world), body_name,
    T_pj, T_cj (Transform of numpy arrays, or None), axes, mass, com,
    moment, damping, stiffness, rest, q_lower, q_upper, tau_lower,
    tau_upper}. Missing entries get the defaults of the JAX package (mass 1,
    moment I, no limits). ``shapes``: one dict of ``make_shape``'s keyword
    arguments per collision shape. ``dtype`` None means torch's default
    dtype.
    """
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    types, parents, jnames, bnames = [], [], [], []
    TpjR, Tpjp, TcjR, Tcjp = [], [], [], []
    axes_all, mass, com, moment = [], [], [], []
    damping, coulomb, stiffness, rest = [], [], [], []
    q_lo, q_hi, tau_lo, tau_hi = [], [], [], []
    dof_names = []
    inf = float("inf")
    eye = Transform(np.eye(3), np.zeros(3))
    for i, j in enumerate(joints):
        t = j["type"]
        if t not in JOINT_NDOF:
            raise ValueError(f"unknown joint type {t!r}")
        nd = JOINT_NDOF[t]
        types.append(t)
        parents.append(int(j.get("parent", i - 1)))
        jnames.append(j.get("name", f"joint_{i}"))
        bnames.append(j.get("body_name", f"body_{i}"))
        T_pj = j.get("T_pj") or eye
        T_cj = j.get("T_cj") or eye
        TpjR.append(np.asarray(T_pj.R, dtype=np.float64))
        Tpjp.append(np.asarray(T_pj.p, dtype=np.float64))
        TcjR.append(np.asarray(T_cj.R, dtype=np.float64))
        Tcjp.append(np.asarray(T_cj.p, dtype=np.float64))
        ax = np.eye(3)
        user_axes = j.get("axes")
        if user_axes is not None:
            user_axes = np.atleast_2d(np.asarray(user_axes, dtype=np.float64))
            ax[: user_axes.shape[0]] = user_axes
        axes_all.append(ax)
        mass.append(float(j.get("mass", 1.0)))
        com.append(np.asarray(j.get("com", np.zeros(3)), dtype=np.float64))
        moment.append(np.asarray(j.get("moment", np.eye(3)), dtype=np.float64))
        damping.extend(_per_dof(j.get("damping", 0.0), nd))
        coulomb.extend(_per_dof(j.get("coulomb_friction", 0.0), nd))
        stiffness.extend(_per_dof(j.get("stiffness", 0.0), nd))
        rest.extend(_per_dof(j.get("rest", 0.0), nd))
        q_lo.extend(_per_dof(j.get("q_lower", -inf), nd))
        q_hi.extend(_per_dof(j.get("q_upper", inf), nd))
        tau_lo.extend(_per_dof(j.get("tau_lower", -inf), nd))
        tau_hi.extend(_per_dof(j.get("tau_upper", inf), nd))
        dof_names.extend(
            [jnames[-1]] if nd == 1 else [f"{jnames[-1]}_{k}" for k in range(nd)]
        )

    nq = len(damping)
    if actuated is None:
        actuated = tuple(range(nq))

    def arr(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=device)

    return Model(
        joint_types=tuple(types),
        parents=tuple(parents),
        joint_names=tuple(jnames),
        body_names=tuple(bnames),
        T_pj=Transform(arr(TpjR), arr(Tpjp)),
        T_cj=Transform(arr(TcjR), arr(Tcjp)),
        axes=arr(axes_all),
        mass=arr(mass),
        com=arr(com),
        moment=arr(moment),
        damping=arr(damping),
        coulomb_friction=arr(coulomb),
        stiffness=arr(stiffness),
        rest_pos=arr(rest),
        q_lower=arr(q_lo),
        q_upper=arr(q_hi),
        tau_lower=arr(tau_lo),
        tau_upper=arr(tau_hi),
        gravity=arr(gravity),
        dt=arr(dt),
        actuated=tuple(int(a) for a in actuated),
        dof_names=tuple(dof_names),
        shapes=tuple(make_shape(dtype=dtype, device=device, **sh) for sh in shapes),
    )


def _per_dof(val: Any, nd: int) -> list:
    if np.isscalar(val):
        return [float(val)] * nd
    out = list(np.asarray(val, dtype=np.float64).ravel())
    if len(out) != nd:
        raise ValueError(f"expected {nd} per-dof values, got {len(out)}")
    return out


def relax_limits(model: Model) -> Model:
    """A copy without joint position limits and Coulomb friction: the
    smooth planning model of the MPC layer. Torque limits are kept."""
    return model.replace(
        q_lower=torch.full_like(model.q_lower, -float("inf")),
        q_upper=torch.full_like(model.q_upper, float("inf")),
        coulomb_friction=torch.zeros_like(model.coulomb_friction),
    )


def zero_state(model: Model, dtype=None) -> State:
    dtype = dtype or model.dtype
    z = torch.zeros(model.nq, dtype=dtype, device=model.device)
    return State(q=z, v=z.clone())
