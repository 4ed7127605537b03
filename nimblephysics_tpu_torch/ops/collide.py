"""Narrow-phase collision with a static contact-slot topology.

PyTorch counterpart of ``nimblephysics_tpu/ops/collide.py``: every pair of
collision shapes that can touch is enumerated once from the model's
static topology, each contributing a fixed number of contact slots, and
each slot's (point, normal, depth, active) is computed from the body
transforms, batched over their leading dimensions. The normal points from
body B into body A; depth > 0 means penetrating.

Ported pairs: box against halfspace (8 corner slots, the jump worm's
floor), sphere against halfspace (1 slot) and box against box (25 slots:
each box's 8 vertices inside the other, and 9 edge-edge slots of the
separating-axis test; the catapult's projectile on its arm). The slot table of the reference is kept whole, so the static
topology (``enumerate_pairs``, ``total_slots``) of any model matches the
JAX package; the narrow phase of every other pair raises naming ROADMAP
queue A, M4.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from nimblephysics_tpu_torch.models.model import Model, ShapeSpec
from nimblephysics_tpu_torch.ops.lie import Transform

# Round shapes without a dedicated narrow phase for some partner kind
# degrade to their bounding capsule (params share the [r, h] z-axis
# convention), as in the reference.
_CAPSULE_FALLBACK_KINDS = ("cylinder", "cone")

_SLOTS = {
    ("sphere", "halfspace"): 1, ("box", "halfspace"): 8, ("capsule", "halfspace"): 2,
    ("sphere", "sphere"): 1, ("sphere", "box"): 1, ("box", "box"): 25,
    ("capsule", "box"): 2, ("capsule", "capsule"): 1, ("sphere", "capsule"): 1,
    ("convex", "halfspace"): 6, ("sphere", "convex"): 1, ("convex", "convex"): 8,
    ("convex", "box"): 8, ("sphere", "heightmap"): 1, ("box", "heightmap"): 8,
    ("capsule", "heightmap"): 2, ("convex", "heightmap"): 6, ("cylinder", "halfspace"): 8,
    ("sphere", "cylinder"): 1, ("cone", "halfspace"): 5, ("sphere", "cone"): 1,
    ("trimesh", "halfspace"): 6, ("sphere", "trimesh"): 1, ("trimesh", "trimesh"): 8,
    ("trimesh", "box"): 8, ("pointcloud", "halfspace"): 6, ("sphere", "pointcloud"): 1,
    ("pointcloud", "box"): 4, ("linesegment", "halfspace"): 4, ("sphere", "linesegment"): 1,
}


class ContactSlots(NamedTuple):
    """Fixed-size contact buffers (..., K, ...)."""

    point: torch.Tensor        # (..., K, 3) world contact point
    normal: torch.Tensor       # (..., K, 3) world normal, B -> A
    depth: torch.Tensor        # (..., K) penetration depth (>0 = contact)
    active: torch.Tensor       # (..., K) bool
    body_a: Tuple[int, ...]    # static body indices (-1 = world/static)
    body_b: Tuple[int, ...]
    friction: torch.Tensor     # (K,) combined friction coefficient
    restitution: torch.Tensor  # (K,) combined restitution


def _box_corners(params: torch.Tensor) -> torch.Tensor:
    """(8, 3) corner offsets for the full extents params[:3]."""
    half = params[:3] / 2.0
    signs = torch.tensor([[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                          for sz in (-1.0, 1.0)], dtype=params.dtype, device=params.device)
    return signs * half


def _num_slots_table(kind_a: str, kind_b: str) -> int:
    return _SLOTS.get((kind_a, kind_b), 0)


def _capsule_fallback(kind_a: str, kind_b: str) -> Tuple[str, str]:
    """Effective kinds after the bounding-capsule fallback, or the pair
    unchanged when a dedicated routine exists."""
    if _num_slots_table(kind_a, kind_b) > 0:
        return kind_a, kind_b
    fa = "capsule" if kind_a in _CAPSULE_FALLBACK_KINDS else kind_a
    fb = "capsule" if kind_b in _CAPSULE_FALLBACK_KINDS else kind_b
    return fa, fb


def _num_slots(kind_a: str, kind_b: str) -> int:
    return _num_slots_table(*_capsule_fallback(kind_a, kind_b))


def enumerate_pairs(model: Model) -> List[Tuple[int, int, int]]:
    """Static list of (shape index a, shape index b, slots). Shapes on the
    same body, two static shapes and parent-child pairs do not collide; a
    symmetric pair is kept in one direction."""
    out = []
    shapes = model.shapes
    for i in range(len(shapes)):
        for j in range(len(shapes)):
            if i == j:
                continue
            a, b = shapes[i], shapes[j]
            if a.body_index == b.body_index:
                continue
            if a.body_index < 0 and b.body_index < 0:
                continue
            if a.body_index >= 0 and b.body_index >= 0:
                if model.parents[a.body_index] == b.body_index:
                    continue
                if model.parents[b.body_index] == a.body_index:
                    continue
            n = _num_slots(a.kind, b.kind)
            if n == 0:
                continue
            if _num_slots(b.kind, a.kind) > 0 and j < i:
                continue
            out.append((i, j, n))
    return out


def total_slots(model: Model) -> int:
    return sum(n for _, _, n in enumerate_pairs(model))


def _shape_world_transform(model: Model, shape: ShapeSpec, T_wb: List[Transform]) -> Transform:
    off = shape.offset
    if shape.body_index < 0:
        return off
    return T_wb[shape.body_index].compose(off)


def _halfspace_world(pb: torch.Tensor, Tb: Transform):
    """Halfspace params [nx, ny, nz, offset] in the shape frame -> the world
    plane {x : n.x = d}, solid below."""
    n_w = Tb.rotate(pb[:3])
    d_w = pb[3] + (n_w * Tb.p).sum(-1)
    return n_w, d_w


def _sphere_halfspace(pa, pb, Ta: Transform, Tb: Transform):
    """One slot at the sphere's deepest point, moved half the depth back
    (params [r, 0, 0, 0]). The distances keep a trailing axis (torch.func's
    forward-mode promotion of 0-dim tensors)."""
    n, d = _halfspace_world(pb, Tb)
    c = Ta.p
    r = pa[0]
    dist = (n * c).sum(-1, keepdim=True) - d
    depth = r - dist
    point = c - n * (r - 0.5 * depth)
    return [point], [n.expand(point.shape)], [depth[..., 0]]


def _box_halfspace(pa, pb, Ta: Transform, Tb: Transform):
    n, d = _halfspace_world(pb, Tb)
    corners = _box_corners(pa)
    pts, ns, ds = [], [], []
    for k in range(8):
        p_w = Ta.apply(corners[k])
        pts.append(p_w)
        ns.append(n.expand(p_w.shape))
        ds.append(d - (n * p_w).sum(-1))
    return pts, ns, ds


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis, keeping it (torch.func's forward-mode
    promotion of 0-dim tensors)."""
    return (a * b).sum(-1, keepdim=True)


def _vertex_in_box(v_w, half, Tb: Transform):
    """Depth and normal of a world point against a box of half extents
    ``half``: the depth is the least face distance (negative outside), the
    normal that face's outward normal in the world. Depths (..., 1); the
    first least axis wins a tie, as jnp.argmin's."""
    local = Tb.inverse().apply(v_w)
    d = half - local.abs()
    axis = d.argmin(-1, keepdim=True)
    depth = d.amin(-1, keepdim=True)
    e = (axis == torch.arange(3, device=d.device)).to(d.dtype)
    n_local = e * torch.sign(torch.gather(local, -1, axis))
    return depth, Tb.rotate(n_local)


def _box_box(pa, pb, Ta: Transform, Tb: Transform):
    """Each box's 8 vertices against the other box (16 slots), then the 9
    edge-edge slots of ``_box_box_edges``. A vertex of A inside B pushes A
    out along B's face normal; a vertex of B inside A pushes B along minus
    A's."""
    half_a, half_b = pa[:3] / 2.0, pb[:3] / 2.0
    pts, ns, ds = [], [], []
    for corners, half, T_v, T_box, sign in ((_box_corners(pa), half_b, Ta, Tb, 1.0),
                                             (_box_corners(pb), half_a, Tb, Ta, -1.0)):
        for k in range(8):
            v_w = T_v.apply(corners[k])
            depth, n_out = _vertex_in_box(v_w, half, T_box)
            pts.append(v_w)
            ns.append(n_out if sign > 0 else -n_out)
            ds.append(depth[..., 0])
    e_pts, e_ns, e_ds = _box_box_edges(half_a, half_b, Ta, Tb)
    return pts + e_pts, ns + e_ns, ds + e_ds


def _box_box_edges(half_a, half_b, Ta: Transform, Tb: Transform):
    """9 edge-edge slots, one per pair (i, j) of the boxes' axes: the
    normal cross(ua_i, ub_j) oriented B -> A, its overlap the depth, the
    point the midpoint of the closest points of the two supporting edges.
    A slot is active only when every axis overlaps, its axis is within
    5% (ODE's face-preferring fudge) of the least overlap, and the edges
    meet there (their gap within 1.5 depth + 1e-3)."""
    ua = [Ta.R[..., :, k] for k in range(3)]
    ub = [Tb.R[..., :, k] for k in range(3)]
    d_ab = Ta.p - Tb.p

    def overlap(axis):
        ra = sum(half_a[k] * _dot(axis, ua[k]).abs() for k in range(3))
        rb = sum(half_b[k] * _dot(axis, ub[k]).abs() for k in range(3))
        return ra + rb - _dot(axis, d_ab).abs()

    min_face = torch.minimum(
        torch.cat([overlap(ua[k]) for k in range(3)], dim=-1).amin(-1, keepdim=True),
        torch.cat([overlap(ub[k]) for k in range(3)], dim=-1).amin(-1, keepdim=True))
    axes, depths, parallels, cps = [], [], [], []
    for i in range(3):
        for j in range(3):
            n_raw = torch.linalg.cross(ua[i], ub[j])
            length = torch.sqrt(torch.clamp(_dot(n_raw, n_raw), min=1e-18))
            n = n_raw / torch.clamp(length, min=1e-9)
            n = torch.where(_dot(n, d_ab) >= 0.0, n, -n)
            # the supporting edge of A in -n (its material deepest toward
            # B), of B in +n
            ea_c = Ta.p + sum(-torch.sign(_dot(n, ua[k])) * half_a[k] * ua[k]
                              for k in range(3) if k != i)
            eb_c = Tb.p + sum(torch.sign(_dot(n, ub[k])) * half_b[k] * ub[k]
                              for k in range(3) if k != j)
            cps.append(_segment_closest_points(
                ea_c - half_a[i] * ua[i], 2.0 * half_a[i] * ua[i],
                eb_c - half_b[j] * ub[j], 2.0 * half_b[j] * ub[j]))
            axes.append(n)
            depths.append(overlap(n))
            parallels.append(length < 1e-6)
    edge_valid = torch.where(torch.cat(parallels, dim=-1), torch.inf, torch.cat(depths, dim=-1))
    min_all = torch.minimum(min_face, edge_valid.amin(-1, keepdim=True))
    pts, ds = [], []
    for k in range(9):
        cpa, cpb = cps[k]
        gap = torch.sqrt(torch.clamp(((cpa - cpb) ** 2).sum(-1, keepdim=True), min=1e-18))
        depth = depths[k]
        valid = (~parallels[k] & (min_all > 0.0) & (depth <= min_all * 1.05 + 1e-6)
                 & (gap <= depth * 1.5 + 1e-3))
        pts.append(0.5 * (cpa + cpb))
        ds.append(torch.where(valid, depth, -depth.abs() - 1.0)[..., 0])
    return pts, axes, ds


def _segment_closest_points(p1, d1, p2, d2):
    """Closest points of the segments p1 + s d1 and p2 + t d2, s and t in
    [0, 1] (clamped, branch-free)."""
    r = p1 - p2
    a, e, b = _dot(d1, d1), _dot(d2, d2), _dot(d1, d2)
    c, f = _dot(d1, r), _dot(d2, r)
    denom = torch.clamp(a * e - b * b, min=1e-12)
    s = torch.clamp((b * f - c * e) / denom, 0.0, 1.0)
    t = torch.clamp((b * s + f) / torch.clamp(e, min=1e-12), 0.0, 1.0)
    s = torch.clamp((b * t - c) / torch.clamp(a, min=1e-12), 0.0, 1.0)
    return p1 + s * d1, p2 + t * d2


def _narrow_phase(sa: ShapeSpec, sb: ShapeSpec, Ta: Transform, Tb: Transform):
    kinds = _capsule_fallback(sa.kind, sb.kind)
    if kinds == ("sphere", "halfspace"):
        return _sphere_halfspace(sa.params, sb.params, Ta, Tb)
    if kinds == ("box", "halfspace"):
        return _box_halfspace(sa.params, sb.params, Ta, Tb)
    if kinds == ("box", "box"):
        return _box_box(sa.params, sb.params, Ta, Tb)
    raise NotImplementedError(
        f"the {kinds[0]}/{kinds[1]} narrow phase is not ported yet (ROADMAP queue A, M4: "
        "ops/collide.py pair functions beyond box/halfspace, sphere/halfspace and box/box)")


def detect_contacts(model: Model, T_wb: List) -> ContactSlots:
    """Fill every contact slot from the body transforms (leading batch
    dimensions of the transforms carry over)."""
    points, normals, depths, fric, rest = [], [], [], [], []
    bodies_a, bodies_b = [], []
    for ia, ib, n in enumerate_pairs(model):
        sa, sb = model.shapes[ia], model.shapes[ib]
        Ta = _shape_world_transform(model, sa, T_wb)
        Tb = _shape_world_transform(model, sb, T_wb)
        mu = torch.sqrt(torch.clamp(sa.friction * sb.friction, min=0.0))
        e = torch.maximum(sa.restitution, sb.restitution)
        ps, ns, ds = _narrow_phase(sa, sb, Ta, Tb)
        for k in range(n):
            points.append(ps[k])
            normals.append(ns[k])
            depths.append(ds[k])
            bodies_a.append(sa.body_index)
            bodies_b.append(sb.body_index)
            fric.append(mu)
            rest.append(e)
    if not points:
        z = model.mass.new_zeros((0,))
        batch = T_wb[0].p.shape[:-1] if T_wb else ()
        z3b = model.mass.new_zeros(batch + (0, 3))
        zb = model.mass.new_zeros(batch + (0,))
        return ContactSlots(z3b, z3b, zb, zb > 0.0, (), (), z, z)
    batch = torch.broadcast_shapes(*(p.shape[:-1] for p in points))
    depth = torch.stack([d.expand(batch) for d in depths], dim=-1)
    return ContactSlots(
        point=torch.stack([p.expand(batch + (3,)) for p in points], dim=-2),
        normal=torch.stack([nn.expand(batch + (3,)) for nn in normals], dim=-2),
        depth=depth,
        active=depth > 0.0,
        body_a=tuple(bodies_a),
        body_b=tuple(bodies_b),
        friction=torch.stack(fric),
        restitution=torch.stack(rest),
    )
