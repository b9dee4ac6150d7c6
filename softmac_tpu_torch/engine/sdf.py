"""Signed-distance-field tables: loading the baked cache.

Counterpart of the table half of ``softmac_tpu/engine/sdf.py``. Sampling a
table (``gather_rows``, ``interp_rows``, the world-frame sample, with the
reference's out-of-box semantics of ``softmac/engine/primitive/mesh.py:45-113``)
lives in ``ops/contact.py``, beside the contact kernel that does the same.

The bake (mesh -> SDF grid) is not ported yet: ``preprocess_sdf`` reads the
``assets/*/sdf_<key>.npz`` cache under the JAX package's content key and
raises on a miss. ``weld_vertices`` (the bake's first step) merges a mesh's
duplicate vertices; the rigid bodies' surface samples start from it.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from softmac_tpu_torch.engine.types import SDFParams


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


def preprocess_sdf(verts: np.ndarray, faces: np.ndarray, cache_dir) -> dict:
    """Load the cached bake of a mesh. The port has no bake yet: a missing
    cache file raises (bake it with the JAX package's ``preprocess_sdf``)."""
    cache_file = Path(cache_dir) / f"sdf_{sdf_cache_key(verts, faces)}.npz"
    if not cache_file.exists():
        raise FileNotFoundError(
            f"no baked SDF table {cache_file}; the PyTorch port reads the "
            "cache only (the bake comes with a later slice of the port)")
    data = np.load(cache_file)
    return {
        "sdf": data["sdf"],
        "normal": data["normal"],
        "position": (data["lower"], data["upper"]),
        "dx": data["dx"],
        "res": data["res"],
    }


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

