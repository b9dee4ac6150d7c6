"""PyTorch port: preprocess_sdf bakes the door, the palm and the finger, whose
tables the repository ships (``assets/door/sdf_b4dae...npz``, 86 x 54 x 21;
``assets/gripper/sdf_*.npz``, the JAX bake's own output), into an empty
cache directory on the CPU, and the result is held against the shipped
files.

- Same key, same grid: res, lower, upper, dx; the same fields and dtypes
  in the file it writes.
- sdf within 5e-7 of the shipped table (float32 in another order of
  operations); the same sign wherever |sdf| > 5e-7 (the palm's grid puts
  points on its faces, whose distance is a rounding error in both).
- The normal table equal to the shipped one except at nearest-face ties
  (at most 0.5 % of cells: the finger has 0.19 %); at every such cell the
  shipped normal's face lies, in float64, within 1e-6 of the nearest
  distance.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from softmac_tpu_torch.engine import sdf as tsdf
from softmac_tpu_torch.engine.meshio import load_obj

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("mesh", ["door/door", "gripper/palm",
                                  "gripper/finger"])
def test_bake_matches_shipped_cache(tmp_path, mesh):
    v, f = load_obj(ROOT / f"assets/{mesh}.obj")
    key = tsdf.sdf_cache_key(v, f)
    shipped = ROOT / "assets" / mesh.split("/")[0] / f"sdf_{key}.npz"
    assert shipped.exists()
    got = tsdf.preprocess_sdf(v, f, tmp_path, device="cpu")
    ref = np.load(shipped)
    if mesh == "door/door":
        assert tuple(ref["res"]) == (86, 54, 21)
    with np.load(tmp_path / f"sdf_{key}.npz") as mine:
        assert sorted(mine.files) == sorted(ref.files)
        for k in mine.files:
            assert mine[k].dtype == ref[k].dtype
            assert mine[k].shape == ref[k].shape
    np.testing.assert_array_equal(got["res"], ref["res"])
    np.testing.assert_array_equal(got["dx"], ref["dx"])
    np.testing.assert_array_equal(got["position"][0], ref["lower"])
    np.testing.assert_array_equal(got["position"][1], ref["upper"])
    np.testing.assert_allclose(got["sdf"], ref["sdf"], rtol=0, atol=5e-7)
    far = np.abs(ref["sdf"]) > 5e-7
    assert (np.sign(got["sdf"]) == np.sign(ref["sdf"]))[far].all()

    differ = np.abs(got["normal"] - ref["normal"]).max(axis=-1) > 1e-6
    assert differ.mean() <= 0.005
    if differ.any():
        length = float(np.max(v.max(0) - v.min(0)))
        dx = min(0.01, length / 80)
        g = tsdf.bake_grid(v, f, max(dx * 3, 0.01), dx)
        pts = torch.as_tensor(g["points"][differ.reshape(-1)])
        tri = [torch.as_tensor(g["verts"][g["faces"][:, k]])
               for k in range(3)]
        dist = torch.sqrt(tsdf.point_triangle_dist2(pts, *tri)).numpy()
        fn = g["face_normals"].astype(np.float32)
        picked = np.abs(fn[None] - ref["normal"][differ][:, None]).max(
            axis=-1) < 1e-6
        near = np.where(picked, dist, np.inf).min(axis=1)
        np.testing.assert_allclose(near, dist.min(axis=1), rtol=0, atol=1e-6)
