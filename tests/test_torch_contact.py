"""PyTorch port: penalty particle contact (softmac_tpu_torch.engine.contact.
collide_particle, the plain version on the CPU) against the JAX package's
XLA implementation contact._collide_particle_xla, in float64.

Two tables: a synthetic sphere SDF (the bake tests/test_pallas_contact.py
builds) and the real glass table read from assets/glass. The JAX tables are
carried into the port through softmac_tpu_torch.convert, so both sides read
the same bytes. Impulse and wrench agree to 1e-12 relative (float64 sums in
another order)."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softmac_tpu.engine import contact as jcontact
from softmac_tpu.engine.meshio import load_obj
from softmac_tpu.engine.sdf import preprocess_sdf, sdf_params_from_bake

from softmac_tpu_torch import convert
from softmac_tpu_torch.engine import contact as tcontact
from softmac_tpu_torch.ops import contact as tcontact_ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12


def _sphere_prim(res=10):
    lower, upper = np.zeros(3), np.ones(3)
    dx = 1.0 / (res - 1)
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, res)] * 3, indexing="ij"),
                 axis=-1)
    d = np.linalg.norm(g - 0.5, axis=-1) - 0.25
    n = (g - 0.5) / np.maximum(np.linalg.norm(g - 0.5, axis=-1,
                                              keepdims=True), 1e-9)
    bake = {"res": (res, res, res), "sdf": d, "normal": n,
            "position": (lower, upper), "dx": (dx, dx, dx)}
    # table frame [0, 1]^3; particles span it and beyond
    bp = np.array([0.02, -0.03, 0.01])
    return sdf_params_from_bake(bake, jnp.float64), bp, bp + 0.5, 0.8


def _glass_prim():
    verts, faces = load_obj(ROOT / "assets/glass/glass.obj")
    bake = preprocess_sdf(verts, faces, ROOT / "assets/glass")
    # the glass origin sits near (0.7, 0.31, 0.5) in the pour scene
    bp = np.array([0.72, 0.28, 0.51])
    return sdf_params_from_bake(bake, jnp.float64), bp, bp, 0.25


def _scene(prim_fn, n=600, seed=0):
    prim, bp, center, span = prim_fn()
    rng = np.random.RandomState(seed)
    x = center[:, None] + span * (rng.rand(3, n) - 0.5)
    v = 0.5 * rng.randn(3, n)
    q = np.array([0.9, 0.1, -0.2, 0.15])
    q /= np.linalg.norm(q)
    body = dict(bp=bp, bq=q, bv=np.array([0.1, -0.2, 0.05]),
                bw=np.array([0.3, 0.1, -0.2]), friction=np.float64(10.0))
    return prim, x, v, body


@pytest.mark.parametrize("prim_fn", [_sphere_prim, _glass_prim],
                         ids=["sphere", "glass"])
def test_collide_particle_matches_jax(prim_fn):
    prim, x, v, body = _scene(prim_fn)
    kw = dict(p_mass=1.5e-5, dt=1e-3)
    imp_j, wr_j = jcontact._collide_particle_xla(
        prim, *(jnp.asarray(body[k]) for k in ("bp", "bq", "bv", "bw",
                                                 "friction")),
        tuple(jnp.asarray(x[d]) for d in range(3)),
        tuple(jnp.asarray(v[d]) for d in range(3)), **kw)

    tprim = convert.sdf_params(
        {"neighborhood": np.asarray(prim.neighborhood),
         "lower": np.asarray(prim.lower), "upper": np.asarray(prim.upper),
         "inv_dx": np.asarray(prim.inv_dx), "res": prim.res})
    t = {k: torch.as_tensor(a) for k, a in body.items()}
    imp_t, wr_t = tcontact.collide_particle(
        tprim, t["bp"], t["bq"], t["bv"], t["bw"], t["friction"],
        torch.as_tensor(x), torch.as_tensor(v), kw["dt"], kw["p_mass"])

    imp_j = np.stack([np.asarray(i) for i in imp_j])
    assert (np.abs(imp_j).sum(0) > 0).sum() > 20, "too few contacts"
    np.testing.assert_allclose(imp_t.numpy(), imp_j, rtol=RTOL,
                               atol=RTOL * np.abs(imp_j).max())
    wr_j = np.asarray(wr_j)
    np.testing.assert_allclose(wr_t.numpy(), wr_j, rtol=RTOL,
                               atol=RTOL * np.abs(wr_j).max())


def test_plain_mask_is_contact_set():
    """The kernel's second output, the mask, marks exactly the particles
    with a nonzero impulse here (no particle sits at zero impulse inside)."""
    prim, x, v, body = _scene(_sphere_prim, seed=3)
    tprim = convert.sdf_params(
        {"neighborhood": np.asarray(prim.neighborhood),
         "lower": np.asarray(prim.lower), "upper": np.asarray(prim.upper),
         "inv_dx": np.asarray(prim.inv_dx), "res": prim.res})
    t = {k: torch.as_tensor(a) for k, a in body.items()}
    imp, mask = tcontact_ops.collide_particle(
        tprim, t["bp"], t["bq"], t["bv"], t["bw"], t["friction"],
        torch.as_tensor(x), torch.as_tensor(v), 1e-3, 1.5e-5)
    assert mask.dtype == torch.bool and mask.any()
    np.testing.assert_array_equal(mask.numpy(),
                                  (imp.abs().sum(0) > 0).numpy())
