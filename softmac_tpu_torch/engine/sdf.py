"""Signed-distance-field tables: the bake (mesh -> SDF grid), its cache,
and ray queries.

Counterpart of ``softmac_tpu/engine/sdf.py``. Sampling a table
(``gather_rows``, ``interp_rows``, the world-frame sample, with the
reference's out-of-box semantics of ``softmac/engine/primitive/mesh.py:45-113``)
lives in ``ops/contact.py``, beside the contact kernel that does the same.

``preprocess_sdf`` reads the ``<cache_dir>/sdf_<key>.npz`` table of a mesh
(``sdf_cache_key``: the JAX package's content key and file layout, so
each package reads the other's cache) and bakes it on a miss, on the card
unless asked for the CPU. The bake (``bake_mesh_sdf``) is the JAX
package's: the mesh's duplicate vertices welded, a cell-centred grid
around it (dx = min(0.01, extent / 80), margin max(3 dx, 0.01)), and at
every grid point in float32 the distance to the nearest triangle (Ericson's
closest point, Real-Time Collision Detection 5.1.5), signed by the
generalised winding number (inside where it exceeds 1/2), with that
triangle's outward face normal as the normal table. The grid goes through
in chunks of at most 4e7 (point, triangle) pairs on the card, as JAX's
(2^18 on the CPU, whose caches favour small chunks); per pair only the
squared distance and the solid angle are kept, one coordinate at a time,
never a (P, T, 3) tensor. The argmin keeps the first of equal distances,
as JAX's; where two faces tie to the last bit in one package and not in
the other (a point nearest a shared edge or vertex) the normals differ.
"""
from __future__ import annotations

import hashlib
import math
import os
from pathlib import Path

import numpy as np
import torch

from softmac_tpu_torch.engine.types import SDFParams
from softmac_tpu_torch.ops import m33
from softmac_tpu_torch.ops.contact import BIG, sample_sdf_normal_local

# (point, triangle) pairs a bake chunk: JAX's 4e7 on the card
PAIRS_PER_CHUNK = {"cuda": 4e7, "cpu": 2 ** 18}


def sdf_cache_key(verts: np.ndarray, faces: np.ndarray) -> str:
    """Content key of a mesh's baked table (``softmac_tpu`` sdf.py:382-386)."""
    h = hashlib.sha256()
    h.update(b"softmac-tpu-sdf-v2")
    h.update(np.ascontiguousarray(verts).tobytes())
    h.update(np.ascontiguousarray(faces).tobytes())
    return h.hexdigest()[:32]


def weld_vertices(verts: np.ndarray, faces: np.ndarray, tol: float = 1e-8):
    """Merge duplicate vertices (OBJ exports often store unwelded per-face
    corners): (unique vertices, faces re-indexed into them, int32)."""
    keys = np.round(verts / tol).astype(np.int64)
    _, first, inverse = np.unique(keys, axis=0, return_index=True,
                                  return_inverse=True)
    return verts[first], inverse.reshape(-1)[faces].astype(np.int32)


def _cache_fields(data) -> dict:
    return {
        "sdf": data["sdf"],
        "normal": data["normal"],
        "position": (data["lower"], data["upper"]),
        "dx": data["dx"],
        "res": data["res"],
    }


def preprocess_sdf(verts: np.ndarray, faces: np.ndarray, cache_dir,
                   device=None) -> dict:
    """The baked table of a mesh: read from ``<cache_dir>/sdf_<key>.npz``,
    or baked on ``device`` (the card by default) with the JAX package's
    resolution rule (mesh.py:172) and written there."""
    cache_file = Path(cache_dir) / f"sdf_{sdf_cache_key(verts, faces)}.npz"
    if cache_file.exists():
        return _cache_fields(np.load(cache_file))
    length = float(np.max(verts.max(0) - verts.min(0)))
    dx = min(0.01, length / 80)
    margin = max(dx * 3, 0.01)
    out = bake_mesh_sdf(verts, faces, margin, dx, device=device)
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(
        cache_file,
        sdf=out["sdf"], normal=out["normal"],
        lower=out["position"][0], upper=out["position"][1],
        dx=out["dx"], res=out["res"],
    )
    return out


# ======================================================================
# the bake: mesh -> SDF grid
# ======================================================================
def bake_grid(verts: np.ndarray, faces: np.ndarray, margin: float,
              dx: float) -> dict:
    """What the bake samples (layout of the reference's trimesh2sdf,
    mesh.py:178-240): the welded mesh, its unit face normals, the grid's
    ``res`` and cell-centred ``points`` (rx*ry*rz, 3) float64 in C order,
    and the table's ``lower`` / ``upper`` (the first and last point)."""
    verts, faces = weld_vertices(verts, faces)
    bbox = np.stack([verts.min(0), verts.max(0)])
    center = (bbox[0] + bbox[1]) / 2
    res = np.ceil((bbox[1] - bbox[0] + margin * 2) / dx).astype(int)
    lower = center - res * dx / 2.0
    xs = np.arange(0.5, res[0]) * dx + lower[0]
    ys = np.arange(0.5, res[1]) * dx + lower[1]
    zs = np.arange(0.5, res[2]) * dx + lower[2]
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"),
                   axis=-1).reshape(-1, 3)
    fa, fb, fc = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(fb - fa, fc - fa)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
    lower = lower + dx / 2.0
    return {"verts": verts, "faces": faces, "face_normals": fn, "res": res,
            "points": pts, "lower": lower, "upper": lower + (res - 1) * dx}


def bake_points(points, verts, faces, face_normals, device=None):
    """(sdf (P,), normal (P, 3)) float32 numpy at ``points`` (P, 3): the
    bake of ``bake_mesh_sdf`` at any points, on ``device`` (the card by
    default), in chunks of at most ``PAIRS_PER_CHUNK`` pairs; each point's
    values do not depend on the chunk it falls in."""
    from softmac_tpu_torch.engine.env import resolve_device
    device = resolve_device(device)
    kw = dict(dtype=torch.float32, device=device)
    v = torch.as_tensor(np.asarray(verts), **kw)
    f = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    fn = torch.as_tensor(np.asarray(face_normals), **kw)
    tri = (v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
    chunk = max(1, int(PAIRS_PER_CHUNK[device.type] // max(len(f), 1)))
    sdfs, normals = [], []
    for s in range(0, len(points), chunk):
        p = torch.as_tensor(np.asarray(points[s:s + chunk]), **kw)
        sdf, normal = _bake_chunk(p, tri, fn)
        sdfs.append(sdf.cpu().numpy())
        normals.append(normal.cpu().numpy())
    return np.concatenate(sdfs), np.concatenate(normals)


def bake_mesh_sdf(verts: np.ndarray, faces: np.ndarray, margin: float,
                  dx: float, device=None) -> dict:
    """Bake an SDF grid around the mesh (``softmac_tpu`` sdf.py:335-376):
    {"sdf" (rx, ry, rz), "normal" (rx, ry, rz, 3) float32, "position"
    (lower, upper), "dx" (3,), "res" (3,)}."""
    g = bake_grid(verts, faces, margin, dx)
    sdf, normal = bake_points(g["points"], g["verts"], g["faces"],
                              g["face_normals"], device)
    res = g["res"]
    return {
        "sdf": sdf.reshape(res),
        "normal": normal.reshape(tuple(res) + (3,)),
        "position": (g["lower"], g["upper"]),
        "dx": np.ones(3) * dx,
        "res": res,
    }


def _bake_chunk(p, tri, face_normals):
    """Signed distance and nearest-face normal at points p (P, 3)."""
    dist2 = point_triangle_dist2(p, *tri)
    d2, nearest = torch.min(dist2, dim=1)
    del dist2
    inside = winding_number(p, *tri) > 0.5
    d = torch.sqrt(d2)
    return torch.where(inside, -d, d), face_normals[nearest]


def point_triangle_dist2(points, tri_a, tri_b, tri_c):
    """Squared distance (P, T) from points (P, 3) to triangles (T, 3 each):
    the closest point by region (Ericson, Real-Time Collision Detection
    5.1.5), as the JAX package's ``_point_triangle_distance``, built one
    coordinate at a time."""
    ab = tri_b - tri_a                    # (T, 3)
    ac = tri_c - tri_a
    bc = tri_c - tri_b

    def dots(corner):
        """(ab . (p - corner), ac . (p - corner)), each (P, T)."""
        rel = [points[:, None, k] - corner[None, :, k] for k in range(3)]
        return (sum(ab[None, :, k] * rel[k] for k in range(3)),
                sum(ac[None, :, k] * rel[k] for k in range(3)))

    d1, d2 = dots(tri_a)
    d3, d4 = dots(tri_b)
    d5, d6 = dots(tri_c)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    eps = 1e-30
    v_ab = torch.clamp(d1 / torch.clamp_min(d1 - d3, eps), 0.0, 1.0)
    w_ac = torch.clamp(d2 / torch.clamp_min(d2 - d6, eps), 0.0, 1.0)
    w_bc = torch.clamp((d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6),
                                                   eps), 0.0, 1.0)
    denom_in = torch.clamp_min(va + vb + vc, eps)
    v_in = vb / denom_in
    w_in = vc / denom_in

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    dist2 = None
    for k in range(3):
        a, b, c = tri_a[None, :, k], tri_b[None, :, k], tri_c[None, :, k]
        closest = a + v_in * ab[None, :, k] + w_in * ac[None, :, k]
        closest = torch.where(on_bc, b + w_bc * bc[None, :, k], closest)
        closest = torch.where(on_ac, a + w_ac * ac[None, :, k], closest)
        closest = torch.where(on_ab, a + v_ab * ab[None, :, k], closest)
        closest = torch.where(in_c, c, closest)
        closest = torch.where(in_b, b, closest)
        closest = torch.where(in_a, a, closest)
        diff = points[:, None, k] - closest
        dist2 = diff * diff if dist2 is None else dist2 + diff * diff
    return dist2


def winding_number(points, tri_a, tri_b, tri_c):
    """Generalised winding number (P,) of points w.r.t. the triangles: the
    solid-angle sum (van Oosterom and Strackee) over 4 pi."""
    a = [tri_a[None, :, k] - points[:, None, k] for k in range(3)]
    b = [tri_b[None, :, k] - points[:, None, k] for k in range(3)]
    c = [tri_c[None, :, k] - points[:, None, k] for k in range(3)]

    def dot(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    la, lb, lc = (torch.sqrt(dot(u, u)) for u in (a, b, c))
    bxc = (b[1] * c[2] - b[2] * c[1], b[2] * c[0] - b[0] * c[2],
           b[0] * c[1] - b[1] * c[0])
    num = dot(a, bxc)
    den = la * lb * lc + dot(a, b) * lc + dot(b, c) * la + dot(a, c) * lb
    omega = 2.0 * torch.atan2(num, den)
    return omega.sum(dim=1) / (4.0 * math.pi)


# ======================================================================
# ray queries (reference primitive_utils.py:49-72, mesh.py:120-134)
# ======================================================================
def ray_aabb_intersection(box_min, box_max, o, d):
    """Slab-method ray / box test over rays (vec tuples of (N,)): (hit,
    t_near, t_far); a ray parallel to a slab misses unless its origin lies
    in it (the reference's d == 0 rejection)."""
    near = torch.full_like(o[0], -BIG)
    far = torch.full_like(o[0], BIG)
    hit = torch.ones_like(o[0], dtype=torch.bool)
    for i in range(3):
        para = d[i] == 0
        hit = hit & torch.where(para, (o[i] >= box_min[i])
                                & (o[i] <= box_max[i]), True)
        dsafe = torch.where(para, torch.ones_like(d[i]), d[i])
        i1 = (box_min[i] - o[i]) / dsafe
        i2 = (box_max[i] - o[i]) / dsafe
        lo, hi = torch.minimum(i1, i2), torch.maximum(i1, i2)
        near = torch.where(para, near, torch.maximum(near, lo))
        far = torch.where(para, far, torch.minimum(far, hi))
    return hit & (near <= far), near, far


def sdf_ray_local(prim: SDFParams, o, d):
    """Conservative sphere-tracing distance along rays (o, d) in the prim's
    frame: BIG / 200 on a box miss or a box behind the ray, t_near + 8e-3
    from outside the box, else the table's sdf at o."""
    hit, tnear, tfar = ray_aabb_intersection(prim.lower, prim.upper, o, d)
    miss = (~hit) | (tfar <= 0)
    inside_sdf = sample_sdf_normal_local(prim, o)[0]
    val = torch.where(tnear >= 0, tnear + 8e-3, inside_sdf)
    return torch.where(miss, torch.full_like(val, BIG / 200), val)


def sdf_ray_world(prim: SDFParams, bp, bq, o, d):
    """World-frame ray query: the origin into the prim's frame, the
    direction rotated (reference ``mesh.py:121-123``)."""
    qinv = m33.qnorm(m33.qconj(bq))
    return sdf_ray_local(prim, m33.qrot(qinv, m33.vsub(o, bp)),
                         m33.qrot(qinv, d))


def neighborhood_table(bake: dict) -> np.ndarray:
    """(rx*ry*rz, 32) float64: per base cell the 2x2x2 corners x
    [sdf, nx, ny, nz], corner c = 4*i + 2*j + k (``sdf_params_from_bake``
    of the JAX package)."""
    res = tuple(int(r) for r in bake["res"])
    sdf_flat = np.asarray(bake["sdf"], np.float64).reshape(-1)
    n_flat = np.asarray(bake["normal"], np.float64).reshape(-1, 3)
    comb3 = np.concatenate([sdf_flat[:, None], n_flat], axis=1) \
        .reshape(res + (4,))
    neigh = np.zeros(res + (32,))
    c = 0
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                neigh[:res[0] - 1, :res[1] - 1, :res[2] - 1, 4 * c:4 * c + 4] = \
                    comb3[i:res[0] - 1 + i, j:res[1] - 1 + j, k:res[2] - 1 + k]
                c += 1
    return neigh.reshape(-1, 32)


def sdf_params(neighborhood: np.ndarray, lower, upper, inv_dx, res,
               dtype, device) -> SDFParams:
    """SDFParams on ``device`` from host arrays (the table is uploaded once,
    here)."""
    lower = np.array(lower, np.float64)
    upper = np.array(upper, np.float64)
    inv_dx = float(inv_dx)
    kw = dict(dtype=dtype, device=device)
    return SDFParams(
        neighborhood=torch.as_tensor(np.array(neighborhood), **kw),
        lower=torch.as_tensor(lower, **kw),
        upper=torch.as_tensor(upper, **kw),
        inv_dx=torch.tensor(inv_dx, **kw),
        res=tuple(int(r) for r in res),
        geom=tuple(float(a) for a in lower) + tuple(float(a) for a in upper)
        + (inv_dx,),
    )


def sdf_params_from_bake(bake: dict, dtype=torch.float32,
                         device="cpu") -> SDFParams:
    return sdf_params(neighborhood_table(bake), bake["position"][0],
                      bake["position"][1], 1.0 / float(bake["dx"][0]),
                      bake["res"], dtype, device)

