"""PyTorch port: the 3x3 SVD (softmac_tpu_torch.engine.svd3) against the
JAX package's svd3 in float64 on the CPU, on the cases of tests/test_svd3.py:
random F near the identity, reflections (det F < 0), the identity (all
three singular values repeated) and two repeated singular values. U, sigma
and V agree with JAX's to 1e-12 (the port repeats its Jacobi arithmetic
operation for operation), and the custom backward's cotangent to 1e-12 of
its largest |value| for seeded cotangents of U, sigma and V, finite at the
repeated singular values. Where two singular values are repeated, U and V
are only defined up to a rotation in that pair's plane, so there sigma and
R = U V^T, which are unique, are held to JAX's. The decomposition itself
is checked as tests/test_svd3.py checks it (reconstruction, SO(3),
sigma's order and the sign of det F on sigma_2)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softmac_tpu.engine.svd3 import svd3 as jsvd3
from softmac_tpu_torch.engine.svd3 import svd3

torch.set_num_threads(1)

TOL = 1e-12


def _random_F(n, seed, scale=0.3):
    return np.eye(3) + scale * np.random.RandomState(seed).randn(n, 3, 3)


def _repeated(n, seed):
    """F = R1 diag(s) R2 with s0 = s1 (two repeated singular values)."""
    rng = np.random.RandomState(seed)
    q1, _ = np.linalg.qr(rng.randn(n, 3, 3))
    q2, _ = np.linalg.qr(rng.randn(n, 3, 3))
    s = np.stack([np.full(n, 1.2), np.full(n, 1.2), rng.uniform(0.5, 1, n)],
                 axis=-1)
    return q1 @ (s[..., None] * q2)


CASES = {
    "random": lambda: _random_F(256, 0),
    "negative_det": lambda: _random_F(64, 1) * np.array([-1.0, 1.0, 1.0]),
    "identity": lambda: np.broadcast_to(np.eye(3), (4, 3, 3)).copy(),
    "two_repeated": lambda: _repeated(32, 2),
}


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_svd3_matches_jax(case):
    F = CASES[case]()
    ref = jsvd3(jnp.asarray(F))
    got = svd3(torch.as_tensor(F))
    U, sig, V = (t.numpy() for t in got)
    if case == "two_repeated":
        _close(sig, ref[1])
        _close(U @ np.swapaxes(V, -1, -2),
               ref[0] @ jnp.swapaxes(ref[2], -1, -2))
    else:
        for g, r in zip(got, ref):
            _close(g.numpy(), r)
    recon = U @ (sig[..., None] * np.swapaxes(V, -1, -2))
    np.testing.assert_allclose(recon, F, atol=1e-8)
    for M in (U, V):
        np.testing.assert_allclose(M @ np.swapaxes(M, -1, -2),
                                   np.broadcast_to(np.eye(3), M.shape),
                                   atol=1e-8)
        np.testing.assert_allclose(np.linalg.det(M), 1.0, atol=1e-8)
    assert (sig[:, 0] >= sig[:, 1] - 1e-9).all()
    assert (sig[:, 1] >= sig[:, 2] - 1e-9).all()
    det = np.linalg.det(F)
    np.testing.assert_allclose(np.sign(sig[:, 2]) * np.abs(det), det,
                               atol=1e-8)


@pytest.mark.parametrize("case", ["identity", "negative_det", "random"])
def test_svd3_backward_matches_jax(case):
    """The clamped-denominator backward: F's cotangent for seeded
    cotangents of (U, sigma, V) against jax.vjp of the JAX svd3; finite at
    repeated singular values."""
    F = CASES[case]()
    rng = np.random.RandomState(9)
    gU, gs, gV = rng.randn(*F.shape), rng.randn(F.shape[0], 3), \
        rng.randn(*F.shape)
    _, vjp = jax.vjp(jsvd3, jnp.asarray(F))
    ref, = vjp((jnp.asarray(gU), jnp.asarray(gs), jnp.asarray(gV)))
    Ft = torch.as_tensor(F).requires_grad_()
    got, = torch.autograd.grad(svd3(Ft), Ft, tuple(
        torch.as_tensor(a) for a in (gU, gs, gV)))
    assert bool(torch.isfinite(got).all())
    _close(got.numpy(), ref)


def test_svd3_gradient_finite_at_identity():
    """tests/test_svd3.py's loss at F = I: sum(R * F) + sum(sigma^2)."""
    F = torch.eye(3, dtype=torch.float64).expand(4, 3, 3).clone()
    F.requires_grad_()
    U, sig, V = svd3(F)
    loss = torch.sum(U @ V.transpose(-1, -2) * F) + torch.sum(sig ** 2)
    g, = torch.autograd.grad(loss, F)
    assert bool(torch.isfinite(g).all())

    def jloss(F):
        U, sig, V = jsvd3(F)
        return jnp.sum(U @ jnp.swapaxes(V, -1, -2) * F) + jnp.sum(sig ** 2)
    _close(g.numpy(), jax.grad(jloss)(jnp.asarray(F.detach().numpy())))
