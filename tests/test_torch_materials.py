"""PyTorch port: the constitutive models (softmac_tpu_torch.engine.
materials) against the JAX package's compute_stress_and_F, in float64.
Tolerance 1e-13 relative for the models that need no SVD (the port's cube
root is a power, JAX's is cbrt), for the values and for the gradients of
the corotated liquid's sign-safe cube root; 1e-12 for the corotated
plastic (clip and von Mises) and elastic models, which take the 3x3 SVD,
values and gradients."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softmac_tpu.engine import materials as jmat
from softmac_tpu.engine.types import MPMConfig as JConfig
from softmac_tpu_torch.engine import materials as tmat
from softmac_tpu_torch.engine.types import MPMConfig as TConfig
from softmac_tpu_torch.ops import m33

torch.set_num_threads(1)

N = 64


@pytest.mark.parametrize("model,ptype", [(0, 2), (1, 1), (1, 2)],
                         ids=["corotated-liquid", "neohookean-elastic",
                              "neohookean-liquid"])
def test_stress_and_F_match_jax(model, ptype):
    rng = np.random.RandomState(4)
    F = np.eye(3)[:, :, None] + 0.05 * rng.randn(3, 3, N)
    mu, lam = jmat.lame_parameters(22.0, 0.2, ptype)
    assert (mu, lam) == tmat.lame_parameters(22.0, 0.2, ptype)
    jcfg = JConfig(n_particles=N, material_model=model, ptype=ptype,
                   dtype=jnp.float64)
    tcfg = TConfig(n_particles=N, material_model=model, ptype=ptype,
                   dtype=torch.float64)
    assert not jmat.needs_svd(jcfg) and not tmat.needs_svd(tcfg)
    js, jF = jmat.compute_stress_and_F(
        jcfg, tuple(tuple(jnp.asarray(F[i, j]) for j in range(3))
                    for i in range(3)),
        None, None, None, jnp.full(N, mu), jnp.full(N, lam))
    ts, tF = tmat.compute_stress_and_F(
        tcfg, m33.from_mat_array(torch.as_tensor(F)),
        torch.full((N,), mu, dtype=torch.float64),
        torch.full((N,), lam, dtype=torch.float64))
    for got, ref in ((ts, js), (tF, jF)):
        got = m33.to_mat_array(got).numpy()
        ref = np.stack([np.broadcast_to(np.asarray(ref[i][j]), (N,))
                        for i in range(3) for j in range(3)]).reshape(3, 3, N)
        np.testing.assert_allclose(got, ref, rtol=1e-13,
                                   atol=1e-13 * np.abs(ref).max())


@pytest.mark.parametrize("ptype", [0, 1])
def test_svd_models_raise(ptype):
    """The corotated plastic (ptype 0) and elastic (1) models need the SVD
    and now compute it: stress and new F against JAX's (the SVD from JAX's
    svd3_soa), values and the cotangent of F_tmp, at 1e-12; the plastic
    model under both plastic modes, with a yield stress that some
    particles exceed."""
    from softmac_tpu.engine.svd3 import svd3_soa
    rng = np.random.RandomState(5)
    F = np.eye(3)[:, :, None] + 0.05 * rng.randn(3, 3, N)
    mu, lam = jmat.lame_parameters(50.0, 0.2, ptype)
    ys = np.full(N, 0.12 * mu)
    g_s, g_F = rng.randn(3, 3, N), rng.randn(3, 3, N)
    for mode in (("clip", "von_mises") if ptype == 0 else ("clip",)):
        jcfg = JConfig(n_particles=N, material_model=0, ptype=ptype,
                       plastic_mode=mode, dtype=jnp.float64)
        tcfg = TConfig(n_particles=N, material_model=0, ptype=ptype,
                       plastic_mode=mode, dtype=torch.float64)
        assert jmat.needs_svd(jcfg) and tmat.needs_svd(tcfg)

        def jfn(Fa):
            Ft = tuple(tuple(Fa[i, j] for j in range(3)) for i in range(3))
            U, sig, V = svd3_soa(Ft)
            s, nF = jmat.compute_stress_and_F(
                jcfg, Ft, U, sig, V, jnp.full(N, mu), jnp.full(N, lam),
                jnp.asarray(ys))
            return jnp.stack([jnp.stack(r) for r in s]), \
                jnp.stack([jnp.stack(r) for r in nF])
        (js, jF), vjp = jax.vjp(jfn, jnp.asarray(F))
        jg, = vjp((jnp.asarray(g_s), jnp.asarray(g_F)))
        Ft = torch.as_tensor(F).requires_grad_()
        ts, tF = tmat.compute_stress_and_F(
            tcfg, m33.from_mat_array(Ft),
            torch.full((N,), mu, dtype=torch.float64),
            torch.full((N,), lam, dtype=torch.float64), torch.as_tensor(ys))
        ts, tF = m33.to_mat_array(ts), m33.to_mat_array(tF)
        tg, = torch.autograd.grad((ts, tF), Ft, (torch.as_tensor(g_s),
                                                 torch.as_tensor(g_F)))
        for got, ref in ((ts, js), (tF, jF), (tg, jg)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                       atol=1e-12 * np.abs(ref).max())
        if mode == "von_mises":
            assert 0 < int((np.abs(np.asarray(jF) - F) > 1e-9).any(
                axis=(0, 1)).sum()) < N


def test_cube_root_gradient_matches_cbrt():
    """d/dJ of sign(J) |J|^(1/3) against jax.grad of jnp.cbrt, for J on
    both sides of 0 (the liquid keeps J near 1): finite, and equal."""
    J = np.concatenate([np.linspace(0.5, 1.5, 21), -np.linspace(0.2, 2, 5)])
    F = np.zeros((3, 3, J.size))
    F[0, 0], F[1, 1], F[2, 2] = J, 1.0, 1.0
    cfg = TConfig(n_particles=J.size, material_model=0, ptype=2,
                  dtype=torch.float64)
    Ft = torch.as_tensor(F).requires_grad_()
    ones = torch.ones(J.size, dtype=torch.float64)
    _, new_F = tmat.compute_stress_and_F(cfg, m33.from_mat_array(Ft), ones,
                                         ones)
    g, = torch.autograd.grad(new_F[0][0].sum(), Ft)
    ref = np.asarray(jax.vmap(jax.grad(jnp.cbrt))(jnp.asarray(J)))
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g[0, 0].numpy(), ref, rtol=1e-13)
