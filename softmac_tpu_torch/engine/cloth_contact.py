"""Cloth <-> MPM contact: point-triangle queries, the forecast contact
response and the penetration-tracing integer state
(``softmac_tpu/engine/cloth_contact.py``).

Parity sources: ``soft_cloth/engine/primitive/primitive_cloth.py``
(point-triangle distance :121-140, the penetration-signed sdf :143-164,
collide_particle :199-231, collide_mixed :234-280 with the sticky mode),
``process_faces.py`` (BFS face adjacency) and
``soft_cloth/engine/mpm_simulator.py:444-561`` (the contact-pair search and
the penetration tracing, gradient-free there and here).

Per-particle quantities are struct-of-arrays vecs (``ops/m33.py``: tuples
of (N,) tensors). The pair search is dense over (N, F): a few hundred faces.
The pair search and the tracers return integer state only; they run under
``torch.no_grad()`` and record nothing for autograd. The vertex-force
scatter sums in float64 and rounds once, so that the card's atomics, which
add in another order on every run, give the same bits each time.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from softmac_tpu_torch import native
from softmac_tpu_torch.engine.rigid import GradScale
from softmac_tpu_torch.engine.types import _Replace
from softmac_tpu_torch.ops import m33

BIG = 1e10


def process_faces(faces: np.ndarray, n_neighbors: int = 200):
    """Per-face neighbour table (F, n_neighbors) int32, -1 padded, and
    orientation-flip flags (F, n_neighbors) int8: a breadth-first search
    over shared edges; a neighbour reached through an edge traversed in the
    same winding direction has inverted orientation. Runs the port's C++
    (``softmac_tpu_torch.native``), as the JAX package runs its own, or
    ``process_faces_plain`` where the library cannot be built."""
    try:
        return native.process_faces(np.asarray(faces, np.int32), n_neighbors)
    except native.NativeUnavailable:
        return process_faces_plain(faces, n_neighbors)


def process_faces_plain(faces: np.ndarray, n_neighbors: int = 200):
    """``process_faces`` in Python."""
    faces = np.asarray(faces)
    edge_dict = {}
    F = faces.shape[0]
    for i in range(F):
        for j in range(3):
            v1, v2 = faces[i, j], faces[i, (j + 1) % 3]
            edge_dict.setdefault((min(v1, v2), max(v1, v2)), []).append(i)

    neighbors = np.full((F, n_neighbors), -1, np.int32)
    direction = np.zeros((F, n_neighbors), np.int8)
    for i in range(F):
        found = []
        visited = np.zeros(F, bool)
        q = deque([(i, False)])
        while q and len(found) <= n_neighbors:
            cur, inv = q.popleft()
            if visited[cur]:
                continue
            visited[cur] = True
            found.append((cur, inv))
            for j in range(3):
                v1, v2 = faces[cur, j], faces[cur, (j + 1) % 3]
                for f in edge_dict[(min(v1, v2), max(v1, v2))]:
                    if f == cur or visited[f]:
                        continue
                    inv_new = inv
                    for k in range(3):
                        if faces[f, k] == v1 and faces[f, (k + 1) % 3] == v2:
                            inv_new = not inv
                            break
                    q.append((f, inv_new))
        for slot, (f, inv) in enumerate(found[1:n_neighbors + 1]):
            neighbors[i, slot] = f
            direction[i, slot] = int(inv)
    return neighbors, direction


@dataclasses.dataclass
class ClothContactParams(_Replace):
    """Static cloth-contact data (faces and adjacency) and coefficients."""
    faces: torch.Tensor              # (F, 3) int64
    neighbor_faces: torch.Tensor     # (F, K) int32, -1 padded
    neighbor_dirs: torch.Tensor      # (F, K) int8
    friction: torch.Tensor           # scalar
    softness: torch.Tensor           # scalar
    cloth_force_scale: torch.Tensor  # scalar
    mpm_force_scale: torch.Tensor    # scalar
    sticky: bool = False
    mpm_scale: float = 1.0
    # cap on the penetration push-out speed (m/s): -(d/dt)*life reaches
    # ~50 m/s for deep crossings, and one mislabelled particle then blasts
    # its grid neighbourhood through the cloth
    push_velocity_cap: float = 5.0
    # static scales on the contact's gradient edges (values unchanged):
    # the signed distance, normal and barycentrics; the interpolated cloth
    # velocity. 1.0 is the reference's semantics
    contact_geom_grad_scale: float = 1.0
    contact_cv_grad_scale: float = 1.0


@dataclasses.dataclass
class PenetrationState(_Replace):
    """Integer side-state carried without gradient through the rollout."""
    contact_id: torch.Tensor    # (N,) int32, -1 = no contact
    penetration: torch.Tensor   # (N,) int8


def permute_pen(pen: PenetrationState, q) -> PenetrationState:
    """The side-state under a particle permutation."""
    return PenetrationState(contact_id=pen.contact_id[q],
                            penetration=pen.penetration[q])


def _face_corners(params: ClothContactParams, cloth_x, face_id):
    """The 3 corner positions of each face_id (N,) of cloth_x (V, 3): three
    vecs of (N,)."""
    fid = face_id.clamp(0, params.faces.shape[0] - 1).to(torch.int64)
    vid = params.faces[fid]           # (N, 3)
    out = []
    for c in range(3):
        row = cloth_x[vid[:, c]]      # (N, 3)
        out.append((row[:, 0], row[:, 1], row[:, 2]))
    return out[0], out[1], out[2]


def _closest_point_on_edge(p, x0, x1):
    v = m33.vsub(x1, x0)
    w = m33.vsub(p, x0)
    t = torch.clamp(m33.dot(w, v) / torch.clamp(m33.dot(v, v), min=1e-30),
                    0.0, 1.0)
    return m33.vadd(x0, m33.vscale(v, t))


def _barycentric(p, x0, x1, x2):
    """Barycentric coordinates of p (in the plane), primitive_cloth.py:
    99-113: the xy determinant, the xz one where that vanishes."""
    A = m33.vsub(x1, x0)
    B = m33.vsub(x2, x0)
    Cc = m33.vsub(p, x0)
    den_xy = A[0] * B[1] - A[1] * B[0]
    den_xz = A[0] * B[2] - A[2] * B[0]
    use_xz = torch.abs(den_xy) < 1e-10
    den1 = torch.where(use_xz, den_xz, den_xy)
    den1 = torch.where(torch.abs(den1) < 1e-30, 1e-30, den1)
    w1 = torch.where(use_xz, Cc[0] * B[2] - Cc[2] * B[0],
                     Cc[0] * B[1] - Cc[1] * B[0]) / den1
    den2_xy = B[0] * A[1] - B[1] * A[0]
    den2_xz = B[0] * A[2] - B[2] * A[0]
    den2 = torch.where(use_xz, den2_xz, den2_xy)
    den2 = torch.where(torch.abs(den2) < 1e-30, 1e-30, den2)
    w2 = torch.where(use_xz, Cc[0] * A[2] - Cc[2] * A[0],
                     Cc[0] * A[1] - Cc[1] * A[0]) / den2
    return w1, w2, 1.0 - w1 - w2


def _point_triangle(p, x0, x1, x2):
    """(unsigned distance, plane-signed distance, normal, inside): the plane
    distance where the projection lies inside the triangle, else the
    nearest edge's, with the point-to-edge direction as the normal."""
    n = m33.cross(m33.vsub(x1, x0), m33.vsub(x2, x0))
    n = m33.vscale(n, 1.0 / torch.sqrt(m33.dot(n, n) + 1e-14))
    d_plane = m33.dot(n, m33.vsub(p, x0))
    w1, w2, w3 = _barycentric(m33.vsub(p, m33.vscale(n, d_plane)), x0, x1, x2)
    inside = (w1 >= 0) & (w2 >= 0) & (w3 >= 0)

    best_d = torch.full_like(d_plane, 1e6)
    zero = torch.zeros_like(d_plane)
    best_pt = (zero, zero, zero)
    for (a, b) in ((x0, x1), (x1, x2), (x2, x0)):
        pt = _closest_point_on_edge(p, a, b)
        e = m33.vsub(p, pt)
        dd = torch.sqrt(m33.dot(e, e) + 1e-14)
        take = dd < best_d
        best_pt = m33.vwhere(take, pt, best_pt)
        best_d = torch.where(take, dd, best_d)
    n_edge = m33.vsub(p, best_pt)
    n_edge = m33.vscale(n_edge,
                        1.0 / torch.sqrt(m33.dot(n_edge, n_edge) + 1e-14))

    dist_unsigned = torch.where(inside, torch.abs(d_plane), best_d)
    d_signed = torch.where(inside, d_plane, best_d)
    return dist_unsigned, d_signed, m33.vwhere(inside, n, n_edge), inside


def sdf_and_normal(params, cloth_x, p, penetrated, face_id):
    """Penetration-signed distance and normal (primitive_cloth.py:143-164):
    d < 0 iff the penetration flag is set, the normal flipped to match."""
    x0, x1, x2 = _face_corners(params, cloth_x, face_id)
    _, d, n, _ = _point_triangle(p, x0, x1, x2)
    flip = (penetrated == 0) == (d < 0)
    return torch.where(flip, -d, d), m33.vwhere(flip, m33.vscale(n, -1.0), n)


@torch.no_grad()
def get_contact_pair(params: ClothContactParams, cloth_x, x, penetrated_prev):
    """The nearest candidate face of each particle (int32 (N,)); -1 where no
    face's bounding box, grown by 1e-2 * mpm_scale, holds the particle and
    it is not already penetrating. x: a vec of (N,)."""
    threshold = 1e-2 * params.mpm_scale
    tri = cloth_x[params.faces]                        # (F, 3, 3)
    tmin = tri.amin(dim=1) - threshold
    tmax = tri.amax(dim=1) + threshold
    px = torch.stack(tuple(x), dim=1)                  # (N, 3)
    in_bbox = ((px[:, None, :] > tmin[None]) & (px[:, None, :] < tmax[None])
               ).all(dim=-1)
    corner = [tuple(tri[None, :, c, k] for k in range(3)) for c in range(3)]
    dist, _, _, _ = _point_triangle(tuple(t[:, None] for t in x), *corner)
    candidate = in_bbox | (penetrated_prev != 0)[:, None]
    masked = torch.where(candidate, dist, BIG)
    best_d, best = masked.min(dim=1)
    return torch.where(best_d < BIG, best.to(torch.int32), -1)


def check_side(params, cloth_x, p, face_id):
    """Which side of the (unnormalised) face plane p lies on
    (primitive_cloth.py:190-196)."""
    x0, x1, x2 = _face_corners(params, cloth_x, face_id)
    n = m33.cross(m33.vsub(x1, x0), m33.vsub(x2, x0))
    return m33.dot(n, m33.vsub(p, x0)) > 0


def _neighbor_lookup(params, face_cur, face_prev):
    """(neighbouring?, inverse flag) from the BFS table
    (mpm_simulator.py:488-507)."""
    fid = face_cur.clamp(0, params.faces.shape[0] - 1).to(torch.int64)
    rows = params.neighbor_faces[fid]            # (N, K)
    dirs = params.neighbor_dirs[fid]
    hit = rows == face_prev[:, None]
    neighboring = hit.any(dim=1) | (face_cur == face_prev)
    inverse = (hit & (dirs != 0)).any(dim=1) & (face_cur != face_prev)
    return neighboring, inverse


def _trace(params, cloth_x_cur, cloth_x_prev, p_cur, p_prev, pen, cid_new):
    """Flip the penetration bit of a particle that crossed its
    (neighbouring) contact face: its side of the new face (``cloth_x_cur``,
    ``p_cur``) against its side of the old (``cloth_x_prev``, ``p_prev``)."""
    valid = (cid_new >= 0) & (pen.contact_id >= 0)
    neighboring, inverse = _neighbor_lookup(params, cid_new, pen.contact_id)
    side_cur = check_side(params, cloth_x_cur, p_cur, cid_new)
    side_prev = check_side(params, cloth_x_prev, p_prev, pen.contact_id)
    crossed = (side_cur == side_prev) == inverse
    flipped = torch.where(valid & neighboring & crossed,
                          1 - pen.penetration, pen.penetration)
    return PenetrationState(
        contact_id=cid_new,
        penetration=torch.where(valid, flipped, 0).to(torch.int8))


@torch.no_grad()
def trace_penetration_after_mpm(params, cloth_x, x_new, x_prev,
                                pen: PenetrationState, cid_new):
    """After an MPM substep (mpm_simulator.py:485-518): the particle moved
    from x_prev to x_new against the fixed cloth."""
    return _trace(params, cloth_x, cloth_x, x_new, x_prev, pen, cid_new)


@torch.no_grad()
def trace_penetration_after_cloth(params, cloth_x_new, cloth_x_old, x,
                                  pen: PenetrationState, cid_new):
    """After the cloth moved (mpm_simulator.py:521-553): the particle's side
    of its new face on the new cloth against its old face on the old."""
    return _trace(params, cloth_x_new, cloth_x_old, x, x, pen, cid_new)


def _contact_common(params, cloth_x, cloth_v, x, face_id, penetrated):
    d, D = sdf_and_normal(params, cloth_x, x, penetrated, face_id)
    x0, x1, x2 = _face_corners(params, cloth_x, face_id)
    w1, w2, w3 = _barycentric(m33.vsub(x, m33.vscale(D, d)), x0, x1, x2)
    fid = face_id.clamp(0, params.faces.shape[0] - 1).to(torch.int64)
    vid = params.faces[fid]
    vrows = [cloth_v[vid[:, c]] for c in range(3)]
    cv = tuple(w1 * vrows[0][:, k] + w2 * vrows[1][:, k]
               + w3 * vrows[2][:, k] for k in range(3))
    return d, D, (w1, w2, w3), vid, cv


def _splat_vertex_force(n_vertices, vid, weights, force, mask):
    """Scatter each particle's contact force onto its face's 3 vertices by
    its barycentric weights (the reference's atomic adds, :276-278), summed
    in float64 and rounded once."""
    dtype = force[0].dtype
    f = torch.stack([torch.where(mask, c, 0.0) for c in force], dim=1)
    out = torch.zeros((n_vertices, 3), dtype=torch.float64, device=f.device)
    for c, w in enumerate(weights):
        out = out.index_add(0, vid[:, c],
                            (torch.where(mask, w, 0.0)[:, None] * f).double())
    return out.to(dtype)


def _grad_scaled(vec, s):
    return GradScale.apply(float(s), *vec) if s != 1.0 else vec


def collide_cloth(params: ClothContactParams, cloth_x, cloth_v, x, p_v,
                  p_mass, dt, life, pen: PenetrationState, n_vertices,
                  mode: str = "mixed"):
    """Cloth contact of the particles with a contact pair. x, p_v: vecs of
    (N,); cloth_x, cloth_v (V, 3).

    mode "mixed": the forecast model (collide_mixed, the sticky branch
    included); returns the target velocity (a vec) and the vertex forces
    (V, 3). mode "particle": the penalty model; returns the impulse and the
    vertex forces."""
    active = pen.contact_id >= 0
    d, D, weights, vid, cv = _contact_common(
        params, cloth_x, cloth_v, x, pen.contact_id, pen.penetration)
    if params.contact_geom_grad_scale != 1.0:
        s = params.contact_geom_grad_scale
        d, = _grad_scaled((d,), s)
        D = _grad_scaled(D, s)
        weights = _grad_scaled(weights, s)
    cv = _grad_scaled(cv, params.contact_cv_grad_scale)
    threshold = 5e-3 * params.mpm_scale
    # trust radius: a penetration flag engages the rescue only within a few
    # thresholds of the cloth; a mislabelled distant particle is abandoned
    # instead of driven into the cloth
    mistrust = (pen.penetration != 0) & (torch.abs(d) > 3.0 * threshold)
    active = active & ~mistrust

    if mode == "particle":
        c = d - threshold
        mask = active & (c < 0)
        c = torch.where(mask, c, 0.0)
        input_v = m33.vsub(p_v, cv)
        nc = m33.dot(input_v, D)
        v_t = m33.vsub(input_v, m33.vscale(D, nc))
        f1 = m33.vscale(D, -c * 140.0)
        vt_norm = torch.sqrt(m33.dot(v_t, v_t) + 1e-8)
        f2 = m33.vscale(v_t, -torch.abs(nc) * (params.friction * 0.001)
                        / vt_norm)
        p_f = m33.vscale(m33.vadd(f1, f2), 0.3 * params.mpm_force_scale)
        p_f = tuple(torch.where(mask, f, 0.0) for f in p_f)
        c_f = m33.vscale(m33.vadd(f1, f2), -0.01)
        ext = _splat_vertex_force(n_vertices, vid, weights, c_f, mask)
        return m33.vscale(p_f, dt), ext

    mask = active & (d <= threshold)
    d_s = torch.where(mask, d, 0.0)
    input_v = m33.vsub(p_v, cv)
    nc = m33.dot(input_v, D)
    influence = torch.clamp(torch.exp(-d_s * params.softness), max=1.0)
    if params.sticky:
        v_soft = m33.vadd(cv, m33.vscale(input_v, 1.0 - influence))
        p_v1 = m33.vwhere(d_s > 0, v_soft, cv)
        p_v1 = m33.vwhere(mask, p_v1, p_v)
    else:
        v_t = m33.vsub(input_v, m33.vscale(D, torch.clamp(nc, max=0.0)))
        vt_norm = torch.sqrt(m33.dot(v_t, v_t) + 1e-8)
        vt_fric = m33.vscale(v_t, torch.clamp(vt_norm + nc * params.friction,
                                              min=0.0) / vt_norm)
        flag = (nc < 0) & (m33.dot(v_t, v_t) > 1e-60)
        v_t = m33.vwhere(flag, vt_fric, v_t)
        v_contact = m33.vadd(cv, v_t)
        v_soft = m33.vadd(cv, m33.vadd(m33.vscale(input_v, 1.0 - influence),
                                       m33.vscale(v_t, influence)))
        v_near = m33.vwhere(d_s > 0, v_soft, v_contact)
        p_v1 = m33.vwhere(mask & (nc < 0), v_near, p_v)

    # penetrated particles: the velocity replaced by the push-out
    # (:271-272), its speed capped
    pushed = mask & (d < 0)
    mag = torch.clamp(-(d_s / dt) * life, 0.0, params.push_velocity_cap)
    p_v1 = m33.vwhere(pushed, m33.vscale(D, mag), p_v1)

    p_v_out = m33.vwhere(mask, p_v1, p_v)
    c_f = m33.vscale(m33.vsub(p_v, p_v_out),
                     p_mass / dt * params.cloth_force_scale)
    ext = _splat_vertex_force(n_vertices, vid, weights, c_f, mask)
    return p_v_out, ext
