"""PyTorch port: the constitutive models that need no SVD
(softmac_tpu_torch.engine.materials) against the JAX package's
compute_stress_and_F, in float64. The SVD-driven models raise until the
SVD is ported. Tolerance 1e-13 relative (the port's cube root is a power,
JAX's is cbrt)."""
import numpy as np
import pytest
import torch

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
    cfg = TConfig(n_particles=N, material_model=0, ptype=ptype)
    assert tmat.needs_svd(cfg)
    F = m33.from_mat_array(torch.eye(3)[:, :, None].expand(3, 3, N))
    with pytest.raises(NotImplementedError, match="SVD"):
        tmat.compute_stress_and_F(cfg, F, torch.ones(N), torch.ones(N))
