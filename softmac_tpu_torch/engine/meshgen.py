"""Procedural cloth meshes (``softmac_tpu/engine/meshgen.py``, the port's
own copy): the triangulated tortilla disk (the reference's
``soft_cloth/envs/assets/tortilla/generate_circle.py``), the towel-style
rectangular grid, and an OBJ writer for either. NumPy only; the arrays
equal the JAX package's.
"""
from __future__ import annotations

import numpy as np


def generate_disk(n_rings: int = 8, radius: float = 1.0):
    """Triangulated disk in the y=0 plane: center vertex + concentric rings.

    Returns (verts (V,3), faces (F,3))."""
    verts = [np.zeros(3)]
    ring_start = [0]
    for r in range(1, n_rings + 1):
        n_seg = 6 * r
        ring_start.append(len(verts))
        rad = radius * r / n_rings
        for s in range(n_seg):
            t = 2 * np.pi * s / n_seg
            verts.append(np.array([rad * np.cos(t), 0.0, rad * np.sin(t)]))
    verts = np.asarray(verts)

    faces = []
    # innermost fan
    first = ring_start[1]
    for s in range(6):
        faces.append([0, first + s, first + (s + 1) % 6])
    # ring-to-ring strips
    for r in range(1, n_rings):
        inner, outer = ring_start[r], ring_start[r + 1]
        n_in, n_out = 6 * r, 6 * (r + 1)
        for s in range(n_out):
            o0 = outer + s
            o1 = outer + (s + 1) % n_out
            i0 = inner + int(round(s * n_in / n_out)) % n_in
            faces.append([i0, o0, o1])
        for s in range(n_in):
            i0 = inner + s
            i1 = inner + (s + 1) % n_in
            o0 = outer + int(np.ceil((s + 0.5) * n_out / n_in)) % n_out
            faces.append([i0, o0, i1])
    return verts, np.asarray(faces, np.int32)


def generate_grid(nx: int = 12, nz: int = 12, width: float = 0.45,
                  height: float = 0.5):
    """Rectangular cloth grid in the x-y plane (towel-style)."""
    xs = np.linspace(0, width, nx)
    ys = np.linspace(0, height, nz)
    verts = np.array([[x, y, 0.0] for y in ys for x in xs])
    faces = []
    for j in range(nz - 1):
        for i in range(nx - 1):
            a = j * nx + i
            b = a + 1
            c = a + nx
            d = c + 1
            faces.append([a, b, d])
            faces.append([a, d, c])
    return verts, np.asarray(faces, np.int32)


def save_obj(path, verts, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
