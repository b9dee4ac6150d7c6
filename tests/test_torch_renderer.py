"""PyTorch port: the renderer (softmac_tpu_torch.engine.renderer) against
the JAX package's PointRenderer on the same inputs, both in float64, the
port on the CPU.

- The scenes of tests/test_renderer.py at 96-192 px, ssaa 1 and 2, shadows
  on and off: the floor alone, particles with float and with 0xRRGGBB
  colours, a flat-shaded box and a transparent one overlapping it (alpha
  0.5), two overlapping transparent boxes (alpha 0.5 and 0.8), the
  Gouraud-shaded disk of meshgen.generate_disk, the target overlay, and
  the near-horizontal light (no shadow projection).
- One frame of the port's pour (400 particles, 2 facade steps, the glass
  and the bowl at alpha 0.8 and the target): its snapshot through both
  renderers.
- Criterion: identical uint8 images. The port draws with the same float64
  operations in the same order per pixel; it may differ where a BLAS
  product or the smooth normals' scatter sum rounds its last bit another
  way, or where two triangles tie in mean depth and NumPy's unstable
  argsort orders them otherwise. None of that shows in these scenes.
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from softmac_tpu.config.node import CN as JCN
from softmac_tpu.engine.meshgen import generate_disk
from softmac_tpu.engine.renderer import PointRenderer as JRenderer

import softmac_tpu_torch
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch.config.node import CN as TCN
from softmac_tpu_torch.engine.renderer import PointRenderer, int_color_to_rgb

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _cfgs(res, ssaa, shadows, light=(-math.pi / 4, 0.0)):
    out = []
    for CN in (JCN, TCN):
        cfg = CN()
        cfg.mode = "rgb_array"
        cfg.light_rot = light
        cfg.camera_pos = (0.5, 0.6, 1.5)
        cfg.camera_rot = (-0.25, 0.0)
        cfg.image_res = (res, res)
        cfg.ssaa = ssaa
        cfg.shadows = shadows
        out.append(cfg)
    return out


def _box(center, half=0.05):
    c = np.asarray(center, float)
    lo, hi = -half, half
    verts = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                      for z in (lo, hi)]) + c
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    return verts, faces


class _Bodies:
    """Two bodies: the first at rest, the second moved and turned."""
    pos = np.array([[0.0, 0.0, 0.0], [0.03, 0.02, 0.01]])
    quat = np.array([[1.0, 0.0, 0.0, 0.0],
                     np.array([0.9, 0.1, 0.3, 0.2])
                     / np.linalg.norm([0.9, 0.1, 0.3, 0.2])])


def _disk():
    dv, df = generate_disk(10, 0.22)
    dv = np.asarray(dv, float).copy()
    dv[:, 1] = 0.38 + 0.08 * np.sin(10 * dv[:, 0]) * np.cos(10 * dv[:, 2])
    dv[:, 0] += 0.5
    dv[:, 2] += 0.5
    return dv, np.asarray(df)


def _pair(res, ssaa, shadows, light=(-math.pi / 4, 0.0)):
    jcfg, tcfg = _cfgs(res, ssaa, shadows, light)
    renderers = JRenderer(jcfg, None), PointRenderer(tcfg, None,
                                                     device="cpu")
    for r in renderers:
        r.prim_meshes = [_box([0.5, 0.35, 0.5]),
                         _box([0.55, 0.3, 0.55], 0.07)]
        r.prim_colors = [np.array([0.2, 0.4, 0.9, 1.0]),
                         np.array([0.9, 0.3, 0.2, 0.5])]
    return renderers


def _same(args, kw, renderers):
    ref, got = (r.render(*args, **kw) for r in renderers)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("res,ssaa,shadows", [(96, 1, False), (128, 2, True),
                                              (192, 1, True)])
def test_scenes_match_jax(res, ssaa, shadows):
    rng = np.random.default_rng(res)
    pts = rng.random((400, 3)) * 0.3 + np.array([0.35, 0.2, 0.35])
    target = rng.random((50, 3)) * 0.2 + 0.4
    renderers = _pair(res, ssaa, shadows)
    floor = _same((np.zeros((0, 3)), None, None), {}, renderers)
    shown = _same((pts, rng.integers(0, 1 << 24, 400), _Bodies()), {},
                  renderers)
    _same((pts, rng.random((400, 3)), _Bodies()), {}, renderers)
    for r in renderers:
        r.set_target(target)
    _same((pts, None, _Bodies()), dict(cloth=_disk()), renderers)
    # the scene is drawn: meshes and particles cover part of the floor
    assert (shown != floor).any(axis=-1).mean() > 0.02


@pytest.mark.parametrize("ssaa", [1, 2])
def test_two_transparent_boxes_match_jax(ssaa):
    """Both boxes transparent (alpha 0.5 and 0.8), overlapping: each pixel
    composes its covering triangles far to near."""
    renderers = _pair(160, ssaa, True)
    for r in renderers:
        r.prim_colors = [np.array([0.2, 0.4, 0.9, 0.5]),
                         np.array([0.9, 0.3, 0.2, 0.8])]
    pts = np.random.default_rng(5).random((300, 3)) * 0.3 + 0.3
    img = _same((pts, None, _Bodies()), {}, renderers)
    floor = _same((np.zeros((0, 3)), None, None), {}, renderers)
    assert (img != floor).any(axis=-1).mean() > 0.02


def test_horizontal_light_matches_jax():
    renderers = _pair(128, 1, True, light=(0.0, 0.0))
    assert renderers[1]._shadow_light() is None
    pts = np.random.default_rng(3).random((200, 3)) * 0.3 + 0.3
    _same((pts, None, _Bodies()), {}, renderers)


def test_contracts_of_the_legacy_suite():
    """tests/test_renderer.py's contracts on the port: output size and dtype,
    the floor's two checker greys, flat shading (at most three shades of
    the box), ssaa keeping the output size."""
    jcfg, tcfg = _cfgs(192, 1, False)
    r = PointRenderer(tcfg, None, device="cpu")
    img = r.render(np.zeros((0, 3)), None, None)
    assert img.shape == (192, 192, 3) and img.dtype == np.uint8
    assert img[150:, :, 0].astype(float).std() > 5.0
    r.prim_meshes = [_box([0.5, 0.35, 0.5])]
    r.prim_colors = [np.array([0.2, 0.4, 0.9, 1.0])]

    class One:
        pos = np.zeros((1, 3))
        quat = np.array([[1.0, 0.0, 0.0, 0.0]])
    img = r.render(np.zeros((0, 3)), None, One())
    blue = (img[..., 2] > 120) & (img[..., 0] < 120)
    assert blue.sum() > 50 and len(np.unique(img[..., 2][blue])) <= 3
    tcfg.ssaa = 2
    assert PointRenderer(tcfg, None, device="cpu").render(
        np.zeros((0, 3)), None, One()).shape == (192, 192, 3)
    np.testing.assert_array_equal(
        int_color_to_rgb(np.array([0x7F007F, 255])).numpy(),
        [[127 / 255, 0, 127 / 255], [0, 0, 1.0]])


def test_small_candidate_chunks_match(monkeypatch):
    """The (triangle, pixel) candidates in many small chunks give the same
    image as in one."""
    from softmac_tpu_torch.engine import renderer
    rng = np.random.default_rng(7)
    pts = rng.random((300, 3)) * 0.3 + 0.3
    imgs = []
    for chunk in (renderer.MAX_CANDIDATES["cpu"], 97):
        monkeypatch.setitem(renderer.MAX_CANDIDATES, "cpu", chunk)
        _, tcfg = _cfgs(128, 2, True)
        r = PointRenderer(tcfg, None, device="cpu")
        r.prim_meshes = [_box([0.5, 0.35, 0.5]),
                         _box([0.55, 0.3, 0.55], 0.07)]
        r.prim_colors = [np.array([0.2, 0.4, 0.9, 1.0]),
                         np.array([0.9, 0.3, 0.2, 0.5])]
        imgs.append(r.render(pts, None, _Bodies(), cloth=_disk()))
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_pour_frame_matches_jax():
    """A frame of the port's pour (400 particles, 2 facade steps): the
    facade's render against JAX's renderer on the same snapshot and the
    env's meshes, which equal JAX's load of the URDFs."""
    from softmac_tpu.engine.meshio import load_obj, load_urdf
    cfg = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_pour_config.py"))
    base = np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")
    x = base[np.random.RandomState(0).choice(len(base), 400, replace=False)]
    env = TorchEnv(cfg, device="cpu", init_particles=x[:, :3])
    acts = env.adjust_action_with_ext_force(np.zeros((2, 12)))
    for a in acts:
        env.step(a)
    target = np.load(ROOT / "envs/pour/pour_mpm_target_position_corotated.npy")
    env.set_render_target(target)
    got = env.render()

    meshes, colors = [], []
    for name in ("glass", "bowl"):
        for link, _ in load_urdf(ROOT / f"assets/{name}/{name}.urdf") \
                .moving_links():
            meshes.append(load_obj(link.mesh_path))
            colors.append(link.color)
    assert len(env.prim_meshes) == len(meshes) == 2
    for (v, f), (tv, tf), c, tc in zip(meshes, env.prim_meshes, colors,
                                       env.prim_colors):
        np.testing.assert_array_equal(tv, v)
        np.testing.assert_array_equal(tf, f)
        np.testing.assert_array_equal(tc, c)
    assert 0.999 > colors[0][3] > 0.5      # the glass is drawn transparent
    ref_r = JRenderer(cfg.RENDERER, env)
    ref_r.set_target(target)
    xs, bodies, _, _ = env.get_state_frame(env.cur)
    ref = ref_r.render(xs, env.particle_colors, bodies)
    assert got.shape == (512, 512, 3)
    np.testing.assert_array_equal(got, ref)
