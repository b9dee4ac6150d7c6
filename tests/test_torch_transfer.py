"""PyTorch port: plain P2G / G2P (softmac_tpu_torch.ops.transfer) against the
JAX package's chunked-kernel references (pallas_chunked.family().p2g_ref /
g2p_ref, the CPU branch of the TPU kernels) and its dense transfers
(mpm.p2g_dense / g2p_dense), in float64 on the CPU.

The particles are y-sorted and no tile overflows its 16-row y-window
(asserted), so the chunked references drop nothing and must equal the
port's exact-window transfers. A second case shifts the window corner so
that stencils cross the window's x/y/z faces: the port skips those cells as
the dense weights' zero rows do.

The cotangents of both transfers (the plain vjps, and autograd through the
P2G / G2P Functions) are held against jax.vjp of the dense transfers
composed with the dense weights, on the same two cases.

Tolerances: 1e-12 relative against the dense transfers (float64 sums in
another order); 2e-6 relative against the chunked references, which return
their dot products in float32 whatever the input type
(``preferred_element_type=jnp.float32`` in pallas_fused._dg)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softmac_tpu.engine import mpm as jmpm
from softmac_tpu.engine.types import MPMConfig as JConfig
from softmac_tpu.ops import pallas_chunked

from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine.types import MPMConfig as TConfig
from softmac_tpu_torch.ops import m33 as tm33
from softmac_tpu_torch.ops import transfer

torch.set_num_threads(1)

WINDOW = (24, 32, 16)
WX, WY, WZ = WINDOW
N = 400
RTOL = 1e-12
F32_RTOL = 2e-6


def _scene(seed=0):
    rng = np.random.RandomState(seed)
    x = np.stack([0.45 + 0.09 * rng.rand(N),
                  0.30 + 0.06 * rng.rand(N),
                  0.50 + 0.05 * rng.rand(N)])
    x = x[:, np.argsort(np.floor(x[1] * 128 - 0.5), kind="stable")]
    v = rng.randn(3, N)
    C = 0.1 * rng.randn(3, 3, N)
    stress = rng.randn(3, 3, N)
    impulse = 1e-3 * rng.randn(3, N)
    return x, v, C, stress, impulse


def _jcfg():
    return JConfig(n_particles=N, n_grid=128, dt=1e-3, substeps=1,
                   active_window=WINDOW, dtype=jnp.float64)


def _tcfg():
    return TConfig(n_particles=N, n_grid=128, dt=1e-3, substeps=1,
                   active_window=WINDOW, dtype=torch.float64)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _setup(shift):
    x, v, C, stress, impulse = _scene()
    jcfg, tcfg = _jcfg(), _tcfg()
    xj = tuple(jnp.asarray(x[d]) for d in range(3))
    sizes, corner, ovf = jmpm.window_geometry(jcfg, xj)
    assert not bool(ovf)
    t_sizes, t_corner, t_ovf = tmpm.window_geometry(tcfg, torch.as_tensor(x))
    assert t_sizes == sizes and not bool(t_ovf)
    assert t_corner.tolist() == [int(c) for c in corner]
    corner = tuple(jnp.int32(int(c) + shift) for c in corner)
    return x, v, C, stress, impulse, jcfg, tcfg, xj, sizes, corner


def _dense(jcfg, xj, sizes, corner):
    W, WD = jmpm.axis_weights(jcfg, xj, sizes, corner)
    return (W, WD) + tuple(jmpm.hyz_family(jcfg, W, WD))


@pytest.mark.parametrize("shift", [0, 2])
def test_p2g_plain_matches_jax(shift):
    x, v, C, stress, impulse, jcfg, tcfg, xj, sizes, corner = _setup(shift)
    jv = tuple(jnp.asarray(v[d]) for d in range(3))
    jC = tuple(tuple(jnp.asarray(C[i, j]) for j in range(3)) for i in range(3))
    js = tuple(tuple(jnp.asarray(stress[i, j]) for j in range(3))
               for i in range(3))
    ji = tuple(jnp.asarray(impulse[d]) for d in range(3))
    chan16 = np.array(jmpm._p2g_channels(jcfg, jv, jC, js, ji))

    tv = torch.as_tensor(v)
    chan = tmpm._p2g_channels(
        tcfg, (tv[0], tv[1], tv[2]), tm33.from_mat_array(torch.as_tensor(C)),
        tm33.from_mat_array(torch.as_tensor(stress)),
        tuple(torch.as_tensor(impulse)))
    _close(chan.numpy(), chan16[:13])
    t_corner = torch.tensor([int(c) for c in corner], dtype=torch.int32)
    gm, gmom = transfer.p2g(torch.as_tensor(x), chan, t_corner, WINDOW,
                            tcfg.inv_dx)

    W, WD, H, HDy, HDz = _dense(jcfg, xj, sizes, corner)
    ref = jmpm.p2g_dense(jcfg, W, WD, H, HDy, HDz, jv, jC, js, ji)
    _close(gm, ref[0])
    for d in range(3):
        _close(gmom[:, d * WX:(d + 1) * WX], ref[1 + d])
    assert np.abs(np.asarray(ref[0])).max() > 0

    if shift == 0:   # the chunked kernels' CPU reference, no tile overflow
        chan16[13:16] = x * tcfg.inv_dx
        meta, c_ovf = pallas_chunked.chunk_meta(
            jnp.asarray(chan16[14]), corner, WY)
        assert not bool(c_ovf)
        fam = pallas_chunked.family(WINDOW)
        gm_r, gmom_r = fam.p2g_ref(jnp.asarray(chan16), meta)
        _close(gm, gm_r, F32_RTOL)
        _close(gmom, gmom_r, F32_RTOL)


@pytest.mark.parametrize("shift", [0, 2])
def test_g2p_plain_matches_jax(shift):
    x, _, _, _, _, jcfg, tcfg, xj, sizes, corner = _setup(shift)
    rng = np.random.RandomState(5)
    gv = [rng.randn(WY * WZ, WX) for _ in range(3)]
    t_corner = torch.tensor([int(c) for c in corner], dtype=torch.int32)
    out = transfer.g2p(torch.as_tensor(x), *(torch.as_tensor(g) for g in gv),
                       t_corner, WINDOW, tcfg.inv_dx).numpy()
    assert out.shape == (12, N)

    W, WD, H, HDy, HDz = _dense(jcfg, xj, sizes, corner)
    v_ref, C_ref, _ = jmpm.g2p_dense(jcfg, W, WD, H, HDy, HDz,
                                     tuple(jnp.asarray(g) for g in gv), xj)
    s = 4.0 * tcfg.inv_dx
    for d in range(3):
        _close(out[d], v_ref[d])
        for j in range(3):
            _close(s * out[3 + 3 * d + j], C_ref[d][j])

    if shift == 0:
        pv = np.zeros((8, N))
        pv[0:3] = x * tcfg.inv_dx
        meta, c_ovf = pallas_chunked.chunk_meta(jnp.asarray(pv[1]), corner, WY)
        assert not bool(c_ovf)
        ref16 = pallas_chunked.family(WINDOW).g2p_ref(
            jnp.asarray(pv), *(jnp.asarray(g) for g in gv), meta)
        _close(out, np.asarray(ref16)[:12], F32_RTOL)


def test_sort_perm_matches_jax():
    """Stable y-cell argsort: the port's particle order is JAX's."""
    rng = np.random.RandomState(2)
    x = 0.4 + 0.05 * rng.rand(3, N)   # few y cells -> many ties
    jperm, jinv = jmpm.sort_perm(_jcfg(), tuple(jnp.asarray(x[d])
                                                for d in range(3)))
    tperm, tinv = tmpm.sort_perm(_tcfg(), torch.as_tensor(x))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))


# ---------------------------------------------------------------------------
# Cotangents: the P2G / G2P autograd Functions and their plain vjps against
# jax.vjp of the dense transfers composed with axis_weights and hyz_family,
# so that x takes its cotangent through the weights. Random cotangents;
# tolerance 1e-12 of the largest |value| of each output.
# ---------------------------------------------------------------------------

def _vjp_inputs(shift):
    x, _, _, _, _, jcfg, tcfg, xj, sizes, corner = _setup(shift)
    t_corner = torch.tensor([int(c) for c in corner], dtype=torch.int32)
    return x, jcfg, tcfg, sizes, corner, t_corner, np.random.RandomState(11)


def _grad_through_function(fn, inputs, cotangents):
    """torch.autograd.grad through the entry point (the autograd Function)."""
    ins = [torch.as_tensor(a).requires_grad_() for a in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, ins,
                               [torch.as_tensor(c) for c in cotangents])


@pytest.mark.parametrize("shift", [0, 2])
def test_p2g_vjp_matches_jax(shift):
    x, jcfg, tcfg, sizes, corner, t_corner, rng = _vjp_inputs(shift)
    chan = rng.randn(13, N)
    chan[0] = tcfg.p_mass
    dgm = rng.randn(WY * WZ, WX)
    dgmom = rng.randn(WY * WZ, 3 * WX)

    def jax_p2g(xs, mom, adx):
        # p2g_dense with the port's channels: momentum as the impulse (v
        # = 0), dx * affine as dx * p_mass * C (stress = 0)
        W, WD = jmpm.axis_weights(jcfg, xs, sizes, corner)
        H, HDy, HDz = jmpm.hyz_family(jcfg, W, WD)
        zero = jnp.zeros(N)
        C = tuple(tuple(adx[3 * i + j] / (jcfg.p_mass * jcfg.dx)
                        for j in range(3)) for i in range(3))
        out = jmpm.p2g_dense(jcfg, W, WD, H, HDy, HDz, (zero,) * 3, C,
                             tuple(tuple(zero for _ in range(3))
                                   for _ in range(3)), tuple(mom))
        return out[0], jnp.concatenate(out[1:], axis=1)

    xs = tuple(jnp.asarray(x[d]) for d in range(3))
    (gm_j, _), vjp = jax.vjp(jax_p2g, xs, jnp.asarray(chan[1:4]),
                             jnp.asarray(chan[4:13]))
    dxs, dmom, dadx = vjp((jnp.asarray(dgm), jnp.asarray(dgmom)))
    # the mass channel is a constant in p2g_dense: its cotangent is
    # sum_cells W dgm over JAX's dense weights
    W, _ = jmpm.axis_weights(jcfg, xs, sizes, corner)
    H = (W[1][:, None, :] * W[2][None, :, :]).reshape(WY * WZ, N)
    dmass = np.einsum("rp,cp,rc->p", np.asarray(H), np.asarray(W[0]), dgm)
    ref_dx = np.stack([np.asarray(d) for d in dxs])
    ref_dchan = np.concatenate([dmass[None], np.asarray(dmom),
                                np.asarray(dadx)])
    assert np.abs(np.asarray(gm_j)).max() > 0

    args = (torch.as_tensor(x), torch.as_tensor(chan), t_corner, WINDOW,
            tcfg.inv_dx)
    plain = transfer.p2g_vjp_plain(*args, torch.as_tensor(dgm),
                                   torch.as_tensor(dgmom))
    through = _grad_through_function(
        lambda xx, cc: transfer.p2g(xx, cc, t_corner, WINDOW, tcfg.inv_dx),
        (x, chan), (dgm, dgmom))
    for dx, dchan in (plain, through):
        assert dx.shape == (3, N) and dchan.shape == (13, N)
        _close(dx.numpy(), ref_dx)
        _close(dchan.numpy(), ref_dchan)


@pytest.mark.parametrize("shift", [0, 2])
def test_g2p_vjp_matches_jax(shift):
    x, jcfg, tcfg, sizes, corner, t_corner, rng = _vjp_inputs(shift)
    gv = [rng.randn(WY * WZ, WX) for _ in range(3)]
    g = rng.randn(12, N)
    s = 4.0 * tcfg.inv_dx

    def jax_g2p(xs, g0, g1, g2):
        W, WD = jmpm.axis_weights(jcfg, xs, sizes, corner)
        H, HDy, HDz = jmpm.hyz_family(jcfg, W, WD)
        v, C, _ = jmpm.g2p_dense(jcfg, W, WD, H, HDy, HDz, (g0, g1, g2), xs)
        return jnp.stack(list(v) + [C[d][j] for d in range(3)
                                    for j in range(3)])

    xs = tuple(jnp.asarray(x[d]) for d in range(3))
    _, vjp = jax.vjp(jax_g2p, xs, *(jnp.asarray(a) for a in gv))
    # the port's rows 3-11 are C unscaled: the JAX C rows take g / s
    gj = np.concatenate([g[:3], g[3:] / s])
    dxs, *dgv = vjp(jnp.asarray(gj))
    ref = [np.stack([np.asarray(d) for d in dxs])] + [np.asarray(d)
                                                      for d in dgv]

    args = (torch.as_tensor(x), *(torch.as_tensor(a) for a in gv), t_corner,
            WINDOW, tcfg.inv_dx)
    plain = transfer.g2p_vjp_plain(*args, torch.as_tensor(g))
    through = _grad_through_function(
        lambda xx, a, b, c: transfer.g2p(xx, a, b, c, t_corner, WINDOW,
                                         tcfg.inv_dx),
        (x, *gv), (g,))
    for grads in (plain, through):
        assert [tuple(t.shape) for t in grads] == [(3, N)] + [(WY * WZ, WX)] * 3
        for got, want in zip(grads, ref):
            _close(got.numpy(), want)
