"""Mesh and URDF loading (host side, NumPy only).

A copy of ``softmac_tpu/engine/meshio.py``: ``load_obj`` parses an OBJ
file with the port's C++ parser (``softmac_tpu_torch.native``), as the JAX
package does with its own, and with the Python body ``load_obj_plain``
where the library cannot be built; both give the same vertex bytes (and
with them the SDF cache keys).

Covers what the reference needs: Wavefront OBJ triangle meshes
(``softmac/engine/primitive/mesh.py`` loads them via trimesh) and the URDF
subset used by its scenes (``softmac/engine/primitive/primitives.py:26-41``
reads collision meshes/colors; ``softmac/engine/rigid_simulator.py:72-77``
loads joint structure through nimblephysics): links with inertial/visual/
collision elements and fixed/revolute/prismatic/floating joints.
"""
from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from softmac_tpu_torch import native


# ======================================================================
# OBJ
# ======================================================================
def load_obj(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    """Load a Wavefront OBJ as (vertices (V,3) f64, faces (F,3) i32).

    Polygons are fan-triangulated; negative indices supported.
    """
    try:
        return native.parse_obj(path)
    except native.NativeUnavailable:
        return load_obj_plain(path)


def load_obj_plain(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    """``load_obj`` in Python."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


# ======================================================================
# URDF
# ======================================================================
@dataclasses.dataclass
class UrdfLink:
    name: str
    mass: float
    inertia: np.ndarray          # (3,3)
    inertial_origin: np.ndarray  # (3,)
    mesh_path: Optional[str]     # collision mesh
    color: np.ndarray            # rgba


@dataclasses.dataclass
class UrdfJoint:
    name: str
    jtype: str                   # fixed | revolute | prismatic | floating
    parent: str
    child: str
    origin_xyz: np.ndarray       # (3,)
    origin_rpy: np.ndarray       # (3,)
    axis: np.ndarray             # (3,)
    limit_lower: float = -np.inf
    limit_upper: float = np.inf
    limit_velocity: float = np.inf


@dataclasses.dataclass
class UrdfModel:
    name: str
    links: List[UrdfLink]
    joints: List[UrdfJoint]
    path: str

    def moving_links(self) -> List[Tuple[UrdfLink, UrdfJoint]]:
        """Links with a collision mesh, paired with the joint attaching them
        (the reference instantiates one contact primitive per collision mesh,
        primitives.py:22-24)."""
        out = []
        by_name = {l.name: l for l in self.links}
        for j in self.joints:
            link = by_name.get(j.child)
            if link is not None and link.mesh_path is not None:
                out.append((link, j))
        return out


def _parse_vec(s: Optional[str], default) -> np.ndarray:
    if not s:
        return np.asarray(default, np.float64)
    return np.asarray([float(x) for x in s.split()], np.float64)


def load_urdf(path: str | Path) -> UrdfModel:
    path = str(path)
    tree = ET.parse(path)
    root = tree.getroot()
    base = os.path.dirname(path)

    links = []
    for link in root.findall("link"):
        name = link.attrib["name"]
        mass, inertia = 1.0, np.eye(3)
        iorigin = np.zeros(3)
        inertial = link.find("inertial")
        if inertial is not None:
            m = inertial.find("mass")
            if m is not None:
                mass = float(m.attrib.get("value", 1.0))
            io = inertial.find("origin")
            if io is not None:
                iorigin = _parse_vec(io.attrib.get("xyz"), (0, 0, 0))
            it = inertial.find("inertia")
            if it is not None:
                a = it.attrib
                ixx = float(a.get("ixx", 1)); iyy = float(a.get("iyy", 1))
                izz = float(a.get("izz", 1)); ixy = float(a.get("ixy", 0))
                ixz = float(a.get("ixz", 0)); iyz = float(a.get("iyz", 0))
                inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])

        mesh_path = None
        col = link.find("collision/geometry/mesh")
        if col is not None:
            mesh_path = os.path.join(base, col.attrib.get("filename", ""))

        color = np.array([0.7, 0.7, 0.7, 1.0])
        c = link.find("visual/material/color")
        if c is not None:
            color = _parse_vec(c.attrib.get("rgba"), color)

        links.append(UrdfLink(name, mass, inertia, iorigin, mesh_path, color))

    joints = []
    for j in root.findall("joint"):
        lim = j.find("limit")
        lo = float(lim.attrib.get("lower", -np.inf)) if lim is not None else -np.inf
        hi = float(lim.attrib.get("upper", np.inf)) if lim is not None else np.inf
        vmax = float(lim.attrib.get("velocity", np.inf)) if lim is not None else np.inf
        if vmax == 0:
            vmax = np.inf
        joints.append(UrdfJoint(
            limit_lower=lo, limit_upper=hi, limit_velocity=vmax,
            name=j.attrib["name"],
            jtype=j.attrib["type"],
            parent=j.find("parent").attrib["link"],
            child=j.find("child").attrib["link"],
            origin_xyz=_parse_vec(
                j.find("origin").attrib.get("xyz") if j.find("origin") is not None else None,
                (0, 0, 0)),
            origin_rpy=_parse_vec(
                j.find("origin").attrib.get("rpy") if j.find("origin") is not None else None,
                (0, 0, 0)),
            axis=_parse_vec(
                j.find("axis").attrib.get("xyz") if j.find("axis") is not None else None,
                (1, 0, 0)),
        ))

    return UrdfModel(root.attrib.get("name", "robot"), links, joints, path)
