"""PyTorch port: the procedural meshes (softmac_tpu_torch.engine.meshgen)
and the C++ preprocessing (softmac_tpu_torch.native), on the CPU.

- generate_disk, generate_grid and save_obj equal the JAX package's
  exactly (the arrays and the written file).
- The C++ library builds with g++ from the port's own preprocess.cpp into
  build/softmac_tpu_torch/native/; its OBJ parse equals the Python body
  (load_obj_plain) byte for byte on the tortilla, the towel and every
  mesh under assets/, and its face adjacency equals the Python body
  (process_faces_plain) on the tortilla and the towel and on a generated
  disk and grid; meshio.load_obj and cloth_contact.process_faces take the
  C++ path and give the same.
- Where the library cannot be built (no g++) both fall back to their
  Python bodies.
"""
from pathlib import Path

import numpy as np
import pytest

from softmac_tpu.engine import meshgen as jmeshgen

from softmac_tpu_torch import native
from softmac_tpu_torch.engine import cloth_contact, meshgen, meshio

ROOT = Path(__file__).resolve().parents[1]
CLOTH_MESHES = ["envs/assets/tortilla/tortilla.obj",
                "envs/assets/towel/towel.obj"]


@pytest.mark.parametrize("args", [(8, 1.0), (3, 0.5), (1, 2.0)])
def test_generate_disk_matches_jax(args):
    for a, b in zip(meshgen.generate_disk(*args),
                    jmeshgen.generate_disk(*args)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("args", [(12, 12, 0.45, 0.5), (3, 5, 1.0, 2.0)])
def test_generate_grid_and_save_obj_match_jax(tmp_path, args):
    v, f = meshgen.generate_grid(*args)
    jv, jf = jmeshgen.generate_grid(*args)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert f.dtype == jf.dtype
    meshgen.save_obj(tmp_path / "a.obj", v, f)
    jmeshgen.save_obj(tmp_path / "b.obj", jv, jf)
    assert (tmp_path / "a.obj").read_text() == (tmp_path / "b.obj").read_text()


def test_native_builds_the_ports_own_source():
    assert native.SRC == ROOT / "softmac_tpu_torch/native/preprocess.cpp"
    assert native.SRC.exists()
    lib = native.library()
    assert native.library_path().exists()
    assert native.library_path().parent == (ROOT / "build/softmac_tpu_torch"
                                            / "native")
    assert lib.softmac_process_faces.restype is not None
    text = (ROOT / "softmac_tpu_torch/native/__init__.py").read_text()
    assert "softmac_tpu/native" not in text


OBJS = CLOTH_MESHES + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "assets").glob("*/*.obj"))


@pytest.mark.parametrize("path", OBJS)
def test_native_parse_equals_python(path):
    v, f = native.parse_obj(ROOT / path)
    pv, pf = meshio.load_obj_plain(ROOT / path)
    assert v.dtype == pv.dtype == np.float64 and f.dtype == pf.dtype
    assert v.tobytes() == pv.tobytes() and f.tobytes() == pf.tobytes()
    lv, lf = meshio.load_obj(ROOT / path)
    assert lv.tobytes() == pv.tobytes() and np.array_equal(lf, pf)


def _meshes():
    out = [meshio.load_obj(ROOT / p)[1] for p in CLOTH_MESHES]
    return out + [meshgen.generate_disk(4)[1], meshgen.generate_grid(6, 5)[1]]


@pytest.mark.parametrize("which", range(4), ids=["tortilla", "towel",
                                                 "disk", "grid"])
def test_native_adjacency_equals_python(which):
    faces = _meshes()[which]
    want = cloth_contact.process_faces_plain(faces, 200)
    for got in (native.process_faces(faces, 200),
                cloth_contact.process_faces(faces, 200)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    small = native.process_faces(faces, 7)
    np.testing.assert_array_equal(small[0], want[0][:, :7])


def test_fallback_without_toolchain(monkeypatch):
    def unavailable():
        raise native.NativeUnavailable("no g++")
    monkeypatch.setattr(native, "library", unavailable)
    faces = meshgen.generate_grid(4, 4)[1]
    for a, b in zip(cloth_contact.process_faces(faces, 20),
                    cloth_contact.process_faces_plain(faces, 20)):
        np.testing.assert_array_equal(a, b)
    v, f = meshio.load_obj(ROOT / CLOTH_MESHES[1])
    assert v.shape == (144, 3) and f.shape == (242, 3)
