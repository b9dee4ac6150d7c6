"""PyTorch port: package boundaries. The port and chip_smoke.py import
neither JAX nor the JAX package; the port loads configs to the same dicts;
its entry points refuse to fall back to the CPU and its kernel wrappers
refuse devices they have no implementation for."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import softmac_tpu
import softmac_tpu_torch
from softmac_tpu.engine.env import SoftMacEnv as JaxEnv
from softmac_tpu_torch.engine import env as torch_env
from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine import sdf as tsdf
from softmac_tpu_torch.engine.types import MPMConfig
from softmac_tpu_torch.ops import build, contact, transfer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "softmac_tpu")
PORT_FILES = sorted((ROOT / "softmac_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


OPS_FILES = sorted((ROOT / "softmac_tpu_torch/ops").glob("*.py"))


@pytest.mark.parametrize("path", OPS_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in OPS_FILES])
def test_ops_do_not_import_engine(path):
    """Kernel wrappers sit below the engine that calls them."""
    above = ("softmac_tpu_torch.engine", "softmac_tpu_torch.config")
    bad = [m for m in _imports(path)
           if m.startswith(above) or m == "softmac_tpu_torch"]
    assert not bad, f"{path} imports {bad}"


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


@pytest.mark.parametrize("name", [None, "demo_pour_vel_config.py"])
def test_config_loads_to_same_dict(name):
    jpath = tpath = None
    if name is not None:
        jpath = str(ROOT / "softmac_tpu/config" / name)
        tpath = str(ROOT / "softmac_tpu_torch/config" / name)
    assert _plain(softmac_tpu_torch.load(tpath)) == _plain(softmac_tpu.load(jpath))


def test_env_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_pour_vel_config.py"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        softmac_tpu_torch.SoftMacEnv(cfg, init_particles=np.zeros((4, 3)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_env.resolve_device("cuda")
    assert torch_env.resolve_device("cpu").type == "cpu"


def test_wrappers_refuse_other_devices():
    n, window = 8, (8, 8, 8)
    meta = dict(device="meta", dtype=torch.float32)
    x = torch.empty((3, n), **meta)
    corner = torch.empty(3, dtype=torch.int32, device="meta")
    g = torch.empty((64, 8), **meta)
    with pytest.raises(TypeError, match="no implementation"):
        transfer.p2g(x, torch.empty((13, n), **meta), corner, window, 128.0)
    with pytest.raises(TypeError, match="no implementation"):
        transfer.g2p(x, g, g, g, corner, window, 128.0)
    prim = tsdf.sdf_params(
        np.zeros((8, 32)), np.zeros(3), np.ones(3), 1.0, (2, 2, 2),
        torch.float32, "meta")
    b3 = torch.empty(3, **meta)
    with pytest.raises(TypeError, match="no implementation"):
        contact.collide_particle(prim, b3, torch.empty(4, **meta), b3, b3,
                                 torch.empty((), **meta), x, x, 1e-3, 1e-5)
    assert transfer.p2g.launches == 0 and transfer.g2p.launches == 0
    assert contact.collide_particle.launches == 0


@pytest.mark.parametrize("n_steps,start,stride", [
    (5, None, 1), (100, None, 20), (100, 0, 20), (6, 1, 4), (5, None, 3),
    (12, 3, 7)])
def test_sample_mask_matches_jax(n_steps, start, stride):
    """Loss-frame sampling (block path and general path) as in JAX."""
    class _Sub:
        substeps = 1
    got = torch_env.SoftMacEnv._sample_mask(_Sub(), n_steps, start, stride)
    ref = JaxEnv._sample_mask(_Sub(), n_steps, start, stride)
    assert got[:2] == ref[:2] and got[3] == ref[3]
    np.testing.assert_array_equal(got[2], ref[2])
    assert (got[4] is None) == (ref[4] is None)
    if ref[4] is not None:
        np.testing.assert_array_equal(got[4], ref[4])


def test_window_geometry_reports_overflow():
    cfg = MPMConfig(n_particles=4, n_grid=64, active_window=(8, 8, 8),
                    dtype=torch.float64)
    x = torch.full((3, 4), 0.5, dtype=torch.float64)
    _, corner, ovf = tmpm.window_geometry(cfg, x)
    assert not bool(ovf)
    assert corner.tolist() == [28, 28, 28]
    x[0, 0] = 0.9    # an outlier outside the window raises the flag
    _, corner2, ovf = tmpm.window_geometry(cfg, x)
    assert bool(ovf) and corner2[1:].tolist() == [28, 28]


def test_kernel_library_is_keyed_by_sources():
    path = build.library_path()
    assert path.parent == ROOT / "build" / "softmac_tpu_torch"
    assert path == build.library_path()
    assert set(build.SIGNATURES) == {
        "softmac_p2g", "softmac_g2p", "softmac_collide_particle",
        "softmac_p2g_bwd", "softmac_g2p_bwd", "softmac_collide_particle_bwd"}
    sources = " ".join(p.read_text() for p in build.CSRC.glob("*.cu"))
    for name in build.SIGNATURES:
        assert f'extern "C" int {name}(' in sources


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_kernel_signature_matches_source(name):
    """The ctypes argument list of each entry point has the C prototype's
    length and types (pointer, int, float), so no argument is cut."""
    sources = " ".join(p.read_text() for p in build.CSRC.glob("*.cu"))
    head = sources.split(f'extern "C" int {name}(', 1)[1].split(")", 1)[0]
    params = [a.strip() for a in head.split(",")]
    kinds = ["p" if "*" in a else "i" if a.startswith("int ") else "f"
             for a in params]
    want = {build.ctypes.c_void_p: "p", build.ctypes.c_int: "i",
            build.ctypes.c_float: "f"}
    assert kinds == [want[t] for t in build.SIGNATURES[name]]
