"""PyTorch port: the SDF bake and the ray queries of
softmac_tpu_torch.engine.sdf against the JAX package's, on the CPU.

- bake_mesh_sdf of a unit cube and of a UV sphere at dx 0.05 (as
  tests/test_sdf.py bakes): the same grid (res, lower, upper, dx); the sdf
  within 2e-6 of JAX's (both bake in float32, in another order of
  operations); the same sign wherever |sdf| > 1e-6; the normal table equal
  to JAX's except at cells whose nearest face is a tie: a point nearest a
  shared edge, whose two faces' float32 distances round apart in another
  order. At every such cell (at most 5 % of the sphere's) the face of
  either normal lies, in float64, within 1e-6 of the nearest distance;
  the normals are unit length everywhere.
- The chunking of the grid changes no value.
- ray_aabb_intersection, sdf_ray_local and sdf_ray_world on seeded rays
  (axis-parallel ones inside and outside the slabs, origins inside, outside
  and beyond the box, a turned and moved body) against JAX's in float64:
  within 1e-12.
- preprocess_sdf bakes on a cache miss and writes sdf_<key>.npz; JAX's
  preprocess_sdf reads that file, and the port reads the file JAX writes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from softmac_tpu.engine import sdf as jsdf

from softmac_tpu_torch.engine import sdf as tsdf
from softmac_tpu_torch.engine.quat import w2quat

torch.set_num_threads(1)


def unit_cube():
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 dtype=np.float64)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 7, 5], [4, 6, 7],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def uv_sphere(n_lat=10, n_lon=16, r=0.4, center=(0.5, 0.5, 0.5)):
    """A closed, outward-wound UV sphere."""
    verts = [[0.0, r, 0.0]]
    for i in range(1, n_lat):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                          r * np.sin(th) * np.sin(ph)])
    verts.append([0.0, -r, 0.0])
    bottom = len(verts) - 1

    def ring(i, j):
        return 1 + (i - 1) * n_lon + j % n_lon
    faces = [[0, ring(1, j + 1), ring(1, j)] for j in range(n_lon)]
    for i in range(1, n_lat - 1):
        for j in range(n_lon):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            faces += [[a, b, d], [a, d, c]]
    faces += [[bottom, ring(n_lat - 1, j), ring(n_lat - 1, j + 1)]
              for j in range(n_lon)]
    return np.asarray(verts) + np.asarray(center), np.asarray(faces, np.int32)


@pytest.mark.parametrize("mesh", [unit_cube, uv_sphere])
def test_bake_matches_jax(mesh):
    v, f = mesh()
    ref = jsdf.bake_mesh_sdf(v, f, margin=0.1, dx=0.05)
    got = tsdf.bake_mesh_sdf(v, f, margin=0.1, dx=0.05, device="cpu")
    np.testing.assert_array_equal(got["res"], ref["res"])
    np.testing.assert_array_equal(got["dx"], ref["dx"])
    for a, b in zip(got["position"], ref["position"]):
        np.testing.assert_array_equal(a, b)
    assert got["sdf"].dtype == got["normal"].dtype == np.float32
    np.testing.assert_allclose(got["sdf"], ref["sdf"], rtol=0, atol=2e-6)
    far = np.abs(ref["sdf"]) > 1e-6
    assert (np.sign(got["sdf"]) == np.sign(ref["sdf"]))[far].all()
    assert (got["sdf"] < 0).any() and (got["sdf"] > 0).any()
    differ = np.abs(got["normal"] - ref["normal"]).max(axis=-1) > 1e-6
    assert differ.mean() <= 0.05
    # each differing cell: both packages' faces are nearest to 1e-6
    g = tsdf.bake_grid(v, f, 0.1, 0.05)
    pts = torch.as_tensor(g["points"][differ.reshape(-1)])
    tri = [torch.as_tensor(g["verts"][g["faces"][:, k]]) for k in range(3)]
    dist = torch.sqrt(tsdf.point_triangle_dist2(pts, *tri)).numpy()
    fn = g["face_normals"].astype(np.float32)
    for normal in (got["normal"][differ], ref["normal"][differ]):
        picked = np.abs(fn[None] - normal[:, None]).max(axis=-1) < 1e-6
        near = np.where(picked, dist, np.inf).min(axis=1)
        np.testing.assert_allclose(near, dist.min(axis=1), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got["normal"], axis=-1), 1.0,
                               atol=1e-6)


def test_chunks_change_nothing(monkeypatch):
    v, f = uv_sphere()
    g = tsdf.bake_grid(v, f, 0.1, 0.05)
    whole = tsdf.bake_points(g["points"], g["verts"], g["faces"],
                             g["face_normals"], "cpu")
    monkeypatch.setitem(tsdf.PAIRS_PER_CHUNK, "cpu", 50000)
    small = tsdf.bake_points(g["points"], g["verts"], g["faces"],
                             g["face_normals"], "cpu")
    for a, b in zip(whole, small):
        np.testing.assert_array_equal(a, b)


def _rays(n=300, seed=0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-1.0, 2.0, (n, 3))
    d = rng.randn(n, 3)
    d[::7, 1] = 0.0                   # parallel to the y slabs
    d[::11, 0] = 0.0
    o[::13] = rng.uniform(0.2, 0.8, (len(o[::13]), 3))    # inside the mesh
    return o, d


def test_rays_match_jax():
    v, f = unit_cube()
    bake = jsdf.bake_mesh_sdf(v, f, margin=0.1, dx=0.05)
    jprim = jsdf.sdf_params_from_bake(bake, jnp.float64)
    tprim = tsdf.sdf_params_from_bake(bake, torch.float64, "cpu")
    o, d = _rays()
    jo, jd = (tuple(jnp.asarray(a[:, k]) for k in range(3)) for a in (o, d))
    to, td = (tuple(torch.as_tensor(a[:, k]) for k in range(3))
              for a in (o, d))
    ref = jsdf.ray_aabb_intersection(jprim.lower, jprim.upper, jo, jd)
    got = tsdf.ray_aabb_intersection(tprim.lower, tprim.upper, to, td)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert got[0].any() and not got[0].all()
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    ref = np.asarray(jsdf.sdf_ray_local(jprim, jo, jd))
    got = tsdf.sdf_ray_local(tprim, to, td).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    assert (got == tsdf.BIG / 200).any() and (got < 0).any()
    q = w2quat(torch.tensor([0.3, -0.7, 0.5], dtype=torch.float64)).numpy()
    p = np.array([0.2, -0.1, 0.3])
    ref = np.asarray(jsdf.sdf_ray_world(
        jprim, tuple(jnp.asarray(x) for x in p),
        tuple(jnp.asarray(x) for x in q), jo, jd))
    got = tsdf.sdf_ray_world(tprim, tuple(torch.tensor(x) for x in p),
                             tuple(torch.tensor(x) for x in q), to, td)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_caches_cross_packages(tmp_path):
    """A miss bakes and writes the cache; each package reads the other's
    file under the same key."""
    v, f = unit_cube()
    v = v * 0.05
    key = tsdf.sdf_cache_key(v, f)
    got = tsdf.preprocess_sdf(v, f, tmp_path / "port", device="cpu")
    path = tmp_path / "port" / f"sdf_{key}.npz"
    assert path.exists()
    ref = jsdf.preprocess_sdf(v, f, tmp_path / "port")   # JAX reads the port's
    for k in ("sdf", "normal", "dx", "res"):
        np.testing.assert_array_equal(ref[k], got[k])
    jsdf.preprocess_sdf(v, f, tmp_path / "jax")           # JAX bakes its own
    back = tsdf.preprocess_sdf(v, f, tmp_path / "jax", device="cpu")
    jax_file = np.load(tmp_path / "jax" / f"sdf_{key}.npz")
    for k in ("sdf", "normal", "dx", "res"):
        np.testing.assert_array_equal(back[k], jax_file[k])
    with np.load(path) as mine:
        assert sorted(mine.files) == sorted(jax_file.files)
        for k in mine.files:
            assert mine[k].dtype == jax_file[k].dtype
