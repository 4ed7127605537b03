"""Carry a model's numeric leaves, given as numpy arrays, into a port Model.

The leaves are the port's weights: the JAX package (or any other source)
hands them over as numpy arrays together with the static topology, and
the port never touches JAX itself.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from nimblephysics_tpu_torch._device import resolve_device
from nimblephysics_tpu_torch.models.model import JOINT_NDOF, LEAF_NAMES, Model, make_shape
from nimblephysics_tpu_torch.ops.lie import Transform

STATIC_KEYS = ("joint_types", "parents", "joint_names", "body_names",
               "actuated", "dof_names", "shapes", "servo_dofs", "mimic", "loops")
# constraint topology the port cannot carry yet: must be empty when given
UNPORTED_KEYS = ("servo_dofs", "mimic", "loops")
SHAPE_FIELDS = ("kind", "body_index", "offset", "params", "friction", "restitution")


def _shape(spec, device, dtype):
    """A port ShapeSpec from a mapping of make_shape's arguments or from any
    object with the fields of SHAPE_FIELDS (a JAX ShapeSpec among them: its
    arrays are read through numpy)."""
    if isinstance(spec, Mapping):
        fields = dict(spec)
    else:
        fields = {f: getattr(spec, f) for f in SHAPE_FIELDS}
    off = fields.get("offset")
    if off is not None:
        fields["offset"] = Transform(np.asarray(off.R), np.asarray(off.p))
    for f in ("params", "friction", "restitution"):
        if f in fields:
            fields[f] = np.asarray(fields[f])
    return make_shape(dtype=dtype, device=device, **fields)


def model_from_numpy(
    static: Mapping,
    leaves: Mapping[str, np.ndarray],
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> Model:
    """Build a Model from its static topology and its numeric leaves.

    ``static`` maps the keys of STATIC_KEYS to the topology (``joint_types``
    and ``parents`` required); ``leaves`` maps every name of
    ``models.model.LEAF_NAMES`` to an array, the joint position limits
    ``q_lower``/``q_upper`` and the Coulomb friction among them (the
    constraint rows of ops/contact.py). ``dtype`` None keeps the leaves'
    own floating type. ``static["shapes"]`` carries the collision shapes,
    each a mapping of ``make_shape``'s arguments or an object with the
    fields of SHAPE_FIELDS. Servos, mimic couplings and loop closures are
    not ported yet (ROADMAP M4): ``static`` may name them only empty, and
    custom joints are refused by their joint type.
    """
    device = resolve_device(device)
    missing = [n for n in LEAF_NAMES if n not in leaves]
    extra = [n for n in leaves if n not in LEAF_NAMES]
    if missing or extra:
        raise ValueError(f"leaves: missing {missing}, unexpected {extra}")
    unknown = [k for k in static if k not in STATIC_KEYS]
    if unknown:
        raise ValueError(f"static: unexpected keys {unknown}")
    given = [k for k in UNPORTED_KEYS if static.get(k)]
    if given:
        raise NotImplementedError(
            f"static: {given} are not ported yet (ROADMAP queue A, M4)")
    types = tuple(static["joint_types"])
    for t in types:
        if t not in JOINT_NDOF:
            raise ValueError(f"unknown joint type {t!r}")
    nb = len(types)

    def arr(name):
        x = torch.as_tensor(np.array(leaves[name]), device=device)
        return x if dtype is None else x.to(dtype)

    t = {name: arr(name) for name in LEAF_NAMES}
    nq = sum(JOINT_NDOF[x] for x in types)
    if t["mass"].shape != (nb,) or t["damping"].shape != (nq,):
        raise ValueError("leaf shapes do not match the topology")
    return Model(
        joint_types=types,
        parents=tuple(int(p) for p in static["parents"]),
        joint_names=tuple(static.get("joint_names",
                                     [f"joint_{i}" for i in range(nb)])),
        body_names=tuple(static.get("body_names",
                                    [f"body_{i}" for i in range(nb)])),
        T_pj=Transform(t["T_pj.R"], t["T_pj.p"]),
        T_cj=Transform(t["T_cj.R"], t["T_cj.p"]),
        axes=t["axes"], mass=t["mass"], com=t["com"], moment=t["moment"],
        damping=t["damping"], coulomb_friction=t["coulomb_friction"],
        stiffness=t["stiffness"], rest_pos=t["rest_pos"],
        q_lower=t["q_lower"], q_upper=t["q_upper"],
        tau_lower=t["tau_lower"], tau_upper=t["tau_upper"],
        gravity=t["gravity"], dt=t["dt"],
        actuated=tuple(int(a) for a in static.get("actuated", range(nq))),
        dof_names=tuple(static.get("dof_names", ())),
        shapes=tuple(_shape(sp, device, t["mass"].dtype) for sp in static.get("shapes", ())),
    )
