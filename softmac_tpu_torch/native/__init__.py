"""Host-side mesh preprocessing in C++ (``preprocess.cpp`` beside this file),
loaded through ctypes: the cloth's face adjacency and the OBJ parser.

The library is built by g++ at first use into
``build/softmac_tpu_torch/native/`` at the repository root, named by a hash
of the source and flags (a changed source rebuilds; a build is moved into
place whole, so processes building at once do not see a partial file).
Nothing runs when the package is imported. ``library()`` raises
``NativeUnavailable`` where there is no g++ or the build fails; the callers
in ``engine.meshio`` and ``engine.cloth_contact`` then run their Python
bodies, which give the same arrays.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "softmac_tpu_torch" / "native")
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


class NativeUnavailable(RuntimeError):
    """The C++ library cannot be built or loaded here."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libsoftmac_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if no build of this source exists; its path."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeUnavailable("g++ not found: the native preprocessing "
                                "library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / so.name
        out = subprocess.run([gxx, *FLAGS, str(SRC), "-o", str(tmp_so)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise NativeUnavailable(f"g++ failed on {SRC.name}:\n"
                                    f"{out.stdout}{out.stderr}")
        os.replace(tmp_so, so)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library (built first where needed)."""
    lib = ctypes.CDLL(str(build()))
    lib.softmac_process_faces.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8)]
    lib.softmac_process_faces.restype = ctypes.c_int
    lib.softmac_parse_obj.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.softmac_parse_obj.restype = ctypes.c_int
    return lib


def process_faces(faces: np.ndarray, n_neighbors: int = 200):
    """The face adjacency of ``cloth_contact.process_faces_plain`` in C++:
    (neighbours (F, n_neighbors) int32, -1 padded, flip flags int8)."""
    lib = library()
    faces = np.ascontiguousarray(faces, np.int32)
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces are (F, 3), got {faces.shape}")
    F = faces.shape[0]
    neighbors = np.empty((F, n_neighbors), np.int32)
    dirs = np.empty((F, n_neighbors), np.int8)
    rc = lib.softmac_process_faces(
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), F,
        n_neighbors, neighbors.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dirs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    if rc != 0:
        raise NativeUnavailable(f"softmac_process_faces returned {rc}")
    return neighbors, dirs


def parse_obj(path):
    """``meshio.load_obj_plain`` in C++: (vertices (V, 3) float64, faces
    (F, 3) int32)."""
    lib = library()
    name = str(path).encode()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    if lib.softmac_parse_obj(name, None, None, ctypes.byref(nv),
                             ctypes.byref(nf)) != 0:
        raise FileNotFoundError(f"cannot read {path}")
    verts = np.empty((nv.value, 3), np.float64)
    faces = np.empty((nf.value, 3), np.int32)
    rc = lib.softmac_parse_obj(
        name, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(nv), ctypes.byref(nf))
    if rc != 0:
        raise OSError(f"cannot read {path} (it changed while it was read)"
                      if rc == 2 else f"cannot read {path}")
    return verts[:nv.value], faces[:nf.value]
