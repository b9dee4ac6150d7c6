"""PyTorch port: the Khatri-Rao pair build of the dense route
(softmac_tpu_torch.ops.kr) against the JAX package's pallas_kr.kr3.

The plain version against the Pallas kernel run in interpret mode on the
CPU (monkeypatched within the test, as tests/test_pallas_kr.py does):
exactly equal in float32 (each output is one float32 multiply). The
cotangents of the KR3 Function against jax.vjp of kr3 (its custom_vjp
backward _kr3_bwd) in float64 within 1e-12 of each output's largest
|value|, on seeded random weights and on the B-spline weights of a scene.
The wrapper's dispatch: the CPU runs the plain version and launches
nothing; any device other than CPU or CUDA raises."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softmac_tpu.ops import pallas_kr

from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine.types import MPMConfig
from softmac_tpu_torch.ops import kr

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_kr, "_INTERPRET", True)
    monkeypatch.setattr(pallas_kr, "_TILE_N", 128)


def _random(dtype, wy=8, wz=16, n=300, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(r, n).astype(dtype) for r in (wy, wz, wy, wz)]


def _bspline(n=200, seed=4):
    """Wy, Wz, WDy, WDz of mpm.axis_weights over a (16, 12, 12) window on
    a 16^3 grid, some particles' stencils cut by the window."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(0.3 + 0.4 * rng.rand(3, n))
    cfg = MPMConfig(n_particles=n, n_grid=16, dtype=torch.float64)
    W, WD = tmpm.axis_weights(cfg, x, (16, 12, 12),
                              torch.tensor([0, 5, 5], dtype=torch.int32))
    assert 0 < int((W[1].sum(0) < 1 - 1e-12).sum()) < n
    return [t.numpy() for t in (W[1], W[2], WD[1], WD[2])]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_plain_matches_pallas_kernel(interpret_mode):
    ins = _random(np.float32)
    ref = pallas_kr.kr3(*(jnp.asarray(a) for a in ins))
    got = kr.kr3_plain(*(torch.as_tensor(a) for a in ins))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (8 * 16, 300)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("case", ["random", "bspline"])
def test_kr3_cotangents_match_jax_vjp(case, interpret_mode):
    ins = _random(np.float64, seed=1) if case == "random" else _bspline()
    rng = np.random.RandomState(2)
    rows = ins[0].shape[0] * ins[1].shape[0]
    cts = [rng.randn(rows, ins[0].shape[1]) for _ in range(3)]
    outs, vjp = jax.vjp(pallas_kr.kr3, *(jnp.asarray(a) for a in ins))
    ref = vjp(tuple(jnp.asarray(c) for c in cts))

    tin = [torch.tensor(a, requires_grad=True) for a in ins]
    got = kr.kr3(*tin)
    for g, o in zip(got, outs):
        assert _rel(g.detach().numpy(), o) == 0.0
    grads = torch.autograd.grad(got, tin, [torch.as_tensor(c) for c in cts])
    for g, r in zip(grads, ref):
        assert _rel(g.numpy(), r) < 1e-12


def test_kr3_dispatch():
    ins = [torch.as_tensor(a) for a in _random(np.float64, wy=3, wz=4, n=5)]
    before = kr.kr3.launches
    out = kr.kr3(*ins)
    assert kr.kr3.launches == before
    for g, r in zip(out, kr.kr3_plain(*ins)):
        assert torch.equal(g, r)
    with pytest.raises(TypeError, match="kr3"):
        kr.kr3(*(t.to("meta") for t in ins))
    tin = [t.clone().requires_grad_() for t in ins]
    assert torch.autograd.gradcheck(
        lambda *a: kr.kr3(*a), tin, eps=1e-6, atol=1e-9)
