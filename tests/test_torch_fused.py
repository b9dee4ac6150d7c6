"""PyTorch port: the dense-weight transfer family (softmac_tpu_torch.ops.
fused, the counterpart of softmac_tpu/ops/pallas_fused.py) and
mpm.axis_weights, against the JAX package on the CPU.

- axis_weights against the JAX mpm.axis_weights, bit for bit, on a window
  that cuts some particles' stencils.
- The plain versions against the JAX dense path (mpm.p2g_dense, g2p_dense,
  gather_dense, splat_channels over axis_weights and hyz_family) in float64
  at 1e-12 of each output's largest |value|, on the B-spline weights and on
  fully dense random weights (the function is defined for any weights).
- Against pallas_fused's own XLA references (_p2g_ref ...), which compute
  in float32 (their dots prefer float32): both sides in float32, 1e-5.
- One interpret-mode pallas_fused case at a tiny window, at the tolerance
  tests/test_pallas_fused.py gives the kernels' bf16x3 dots (2e-3).
- Cotangents of the plain versions through autograd against jax.vjp of the
  JAX references, in float32 at 1e-5, and of the whole chain x ->
  axis_weights -> fused P2G / G2P against jax.vjp of the JAX dense chain in
  float64 at 1e-12.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softmac_tpu.engine import mpm as jmpm
from softmac_tpu.engine.types import MPMConfig as JConfig
from softmac_tpu.ops import m33 as jm33
from softmac_tpu.ops import pallas_fused as jpf
from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine.types import MPMConfig as TConfig
from softmac_tpu_torch.ops import build, fused, m33

torch.set_num_threads(1)

N = 300
WINDOW = (16, 8, 16)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _cfgs(n=N, window=WINDOW):
    kw = dict(n_particles=n, n_grid=64, dt=1e-4, substeps=19,
              active_window=window)
    return JConfig(**kw), TConfig(**kw, dtype=torch.float64)


def _scene(seed, n=N):
    """Particles in a blob about the window's centre, some stencils left
    outside by a corner shifted off the centroid; seeded v, C, stress and
    impulse."""
    rng = np.random.RandomState(seed)
    x = np.stack([0.50 + 0.16 * rng.rand(n), 0.40 + 0.10 * rng.rand(n),
                  0.45 + 0.16 * rng.rand(n)])
    v, imp = rng.randn(3, n), 1e-3 * rng.randn(3, n)
    C, stress = 0.1 * rng.randn(3, 3, n), rng.randn(3, 3, n)
    return x, v, C, stress, imp, rng


def _weights(jcfg, tcfg, x):
    xj = tuple(jnp.asarray(x[d]) for d in range(3))
    sizes, corner, _ = jmpm.window_geometry(jcfg, xj)
    corner = tuple(c + 1 for c in corner)      # cut some stencils
    W, WD = jmpm.axis_weights(jcfg, xj, sizes, corner)
    tc = torch.tensor([int(c) for c in corner], dtype=torch.int32)
    tW, tWD = tmpm.axis_weights(tcfg, torch.as_tensor(x), sizes, tc)
    return (W, WD), (tW, tWD), sizes, corner, tc


def test_axis_weights_match_jax():
    jcfg, tcfg = _cfgs()
    x = _scene(0)[0]
    (W, WD), (tW, tWD), _, _, _ = _weights(jcfg, tcfg, x)
    for j, t in zip(W + WD, tW + tWD):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert t.is_contiguous()
    cut = sum(np.asarray(w).sum(0) < 1 - 1e-9 for w in W)
    assert 0 < int((cut > 0).sum()) < N


def _dense_weights(rng, window=WINDOW, n=N):
    wx, wy, wz = window
    return [rng.randn(w, n) for w in (wx, wx, wy, wy, wz, wz)]


def _ws(case, seed):
    """Six float64 weight matrices (numpy) and the particle data."""
    jcfg, tcfg = _cfgs()
    x, v, C, stress, imp, rng = _scene(seed)
    if case == "dense":
        ws = _dense_weights(rng)
    else:
        (W, WD), _, _, _, _ = _weights(jcfg, tcfg, x)
        ws = [np.asarray(a) for p in zip(W, WD) for a in p]
    return jcfg, tcfg, ws, (v, C, stress, imp), rng


def _jw(ws):
    """The JAX dense path's (W, WD) lists from the six matrices."""
    return [jnp.asarray(ws[0]), jnp.asarray(ws[2]), jnp.asarray(ws[4])], \
        [jnp.asarray(ws[1]), jnp.asarray(ws[3]), jnp.asarray(ws[5])]


def _chan(tcfg, v, C, stress, imp):
    t = torch.as_tensor
    return tmpm._p2g_channels(tcfg, tuple(t(v)), m33.from_mat_array(t(C)),
                              m33.from_mat_array(t(stress)), tuple(t(imp)))


@pytest.mark.parametrize("case", ["bspline", "dense"])
def test_plain_p2g_matches_jax_dense(case):
    jcfg, tcfg, ws, (v, C, stress, imp), _ = _ws(case, 1)
    W, WD = _jw(ws)
    ref = jmpm.p2g_dense(jcfg, W, WD, *jmpm.hyz_family(jcfg, W, WD),
                         tuple(jnp.asarray(v)),
                         jm33.from_mat_array(jnp.asarray(C)),
                         jm33.from_mat_array(jnp.asarray(stress)),
                         tuple(jnp.asarray(imp)))
    gm, gmom = fused.p2g_plain(*(torch.tensor(w) for w in ws),
                               _chan(tcfg, v, C, stress, imp))
    wx = WINDOW[0]
    assert _rel(gm, ref[0]) < 1e-12
    for d in range(3):
        assert _rel(gmom[:, d * wx:(d + 1) * wx], ref[1 + d]) < 1e-12


@pytest.mark.parametrize("case", ["bspline", "dense"])
def test_plain_g2p_gather_splat_match_jax_dense(case):
    jcfg, tcfg, ws, _, rng = _ws(case, 2)
    wx, wy, wz = WINDOW
    W, WD = _jw(ws)
    H = jmpm.hyz_family(jcfg, W, WD)
    gv = [rng.randn(wy * wz, wx) for _ in range(3)]
    jgv = [jnp.asarray(g) for g in gv]
    tws = [torch.tensor(w) for w in ws]
    tgv = [torch.as_tensor(g) for g in gv]

    v_ref, C_ref, _ = jmpm.g2p_dense(jcfg, W, WD, *H, jgv, tuple(W[:3]))
    out = fused.g2p_plain(*tws, *tgv)
    for d in range(3):
        assert _rel(out[d], v_ref[d]) < 1e-12
        for j in range(3):
            assert _rel(4.0 * tcfg.inv_dx * out[3 + 3 * d + j],
                        C_ref[d][j]) < 1e-12

    g_ref = jmpm.gather_dense(jcfg, W, H[0], jgv)
    got = fused.gather_plain(*tws[0::2], *tgv)
    for d in range(3):
        assert _rel(got[d], g_ref[d]) < 1e-12

    vals = rng.randn(3, N)
    s_ref = jmpm.splat_channels(jcfg, W, H[0], [jnp.asarray(a) for a in vals])
    got = fused.splat_plain(*tws[0::2], torch.as_tensor(vals))
    for d in range(3):
        assert _rel(got[:, d * wx:(d + 1) * wx], s_ref[d]) < 1e-12


def _f32_inputs(seed):
    """float32 inputs for the four functions: dense random weights, chan,
    grids, vals, and output cotangents."""
    rng = np.random.RandomState(seed)
    wx, wy, wz = WINDOW
    f = np.float32
    ws = [a.astype(f) for a in _dense_weights(rng)]
    return dict(ws=ws, chan=rng.randn(13, N).astype(f),
                gv=[rng.randn(wy * wz, wx).astype(f) for _ in range(3)],
                vals=rng.randn(3, N).astype(f),
                dgm=rng.randn(wy * wz, wx).astype(f),
                dgmom=rng.randn(wy * wz, 3 * wx).astype(f),
                dout=rng.randn(12, N).astype(f),
                dsplat=rng.randn(wy * wz, 3 * wx).astype(f),
                dv=rng.randn(3, N).astype(f))


def _pad16(a):
    """(12, N) rows -> the JAX kernel layout (16, N), 4 zero rows."""
    return np.concatenate([a, np.zeros((4, a.shape[1]), a.dtype)])


def test_plain_matches_pallas_refs_and_their_vjps():
    """Both sides in float32: the values and the cotangents of every input,
    autograd of the plain versions against jax.vjp of _p2g_ref, _g2p_ref,
    _splat_ref and _gather_ref."""
    d = _f32_inputs(3)
    jin = {k: ([jnp.asarray(a) for a in v] if isinstance(v, list)
               else jnp.asarray(v)) for k, v in d.items()}
    tin = {k: ([torch.as_tensor(a).requires_grad_() for a in v]
               if isinstance(v, list) else torch.as_tensor(v).requires_grad_())
           for k, v in d.items()}
    chan16 = jnp.concatenate([jin["chan"], jnp.zeros((3, N), jnp.float32)])
    cases = [
        (jpf._p2g_ref, (*jin["ws"], chan16), (jin["dgm"], jin["dgmom"]),
         fused.p2g_plain, (*tin["ws"], tin["chan"]),
         (tin["dgm"], tin["dgmom"])),
        (jpf._g2p_ref, (*jin["ws"], *jin["gv"]),
         jnp.asarray(_pad16(d["dout"])), fused.g2p_plain,
         (*tin["ws"], *tin["gv"]), tin["dout"]),
        (jpf._splat_ref, (*jin["ws"][0::2], jin["vals"]), jin["dsplat"],
         fused.splat_plain, (*tin["ws"][0::2], tin["vals"]), tin["dsplat"]),
        (jpf._gather_ref, (*jin["ws"][0::2], *jin["gv"]), jin["dv"],
         fused.gather_plain, (*tin["ws"][0::2], *tin["gv"]), tin["dv"]),
    ]
    for jfn, jargs, jct, tfn, targs, tct in cases:
        jout, vjp = jax.vjp(jfn, *jargs)
        tout = tfn(*targs)
        if jfn is jpf._g2p_ref:      # its 12 used rows of the (16, N)
            jout = jout[:12]
        jouts = jout if isinstance(jout, tuple) else (jout,)
        touts = tout if isinstance(tout, tuple) else (tout,)
        for a, b in zip(touts, jouts):
            assert _rel(a.detach(), b) < 1e-5, jfn.__name__
        jg = vjp(jct)
        tg = torch.autograd.grad(touts, targs,
                                 tct if isinstance(tct, tuple) else (tct,))
        for a, b in zip(tg, jg):     # chan's cotangent: its 13 used rows
            assert _rel(a, np.asarray(b)[:a.shape[0]]) < 1e-5, jfn.__name__


def test_plain_matches_pallas_interpret(monkeypatch):
    """The TPU kernels themselves, in interpret mode at a tiny window
    (8, 8, 8), against the float64 plain versions on the same float32
    inputs, at the bf16x3 tolerance of tests/test_pallas_fused.py."""
    monkeypatch.setattr(jpf, "_INTERPRET", True)
    window, n = (8, 8, 8), 200
    jcfg, tcfg = _cfgs(n, window)
    rng = np.random.RandomState(4)
    x = np.stack([0.5 + 0.04 * rng.rand(n) for _ in range(3)])
    xj = tuple(jnp.asarray(x[d], jnp.float32) for d in range(3))
    sizes, corner, _ = jmpm.window_geometry(jcfg, xj)
    W, WD = jmpm.axis_weights(jcfg, xj, sizes, corner)
    ws = [W[0], WD[0], W[1], WD[1], W[2], WD[2]]
    chan = jnp.asarray(rng.randn(16, n), jnp.float32).at[13:].set(0.0)
    gv = [jnp.asarray(rng.randn(64, 8), jnp.float32) for _ in range(3)]
    vals = jnp.asarray(rng.randn(3, n), jnp.float32)
    t64 = [torch.tensor(np.asarray(a), dtype=torch.float64) for a in ws]
    tgv = [torch.tensor(np.asarray(g), dtype=torch.float64) for g in gv]
    tch = torch.tensor(np.asarray(chan)[:13], dtype=torch.float64)
    pairs = [(jpf.p2g(*ws, chan), fused.p2g_plain(*t64, tch)),
             ((jpf.g2p(*ws, *gv)[:12],), (fused.g2p_plain(*t64, *tgv),)),
             ((jpf.splat(*ws[0::2], vals),),
              (fused.splat_plain(*t64[0::2],
                                 torch.tensor(np.asarray(vals),
                                           dtype=torch.float64)),)),
             ((jpf.gather(*ws[0::2], *gv),),
              (fused.gather_plain(*t64[0::2], *tgv),))]
    for jo, to in pairs:
        for a, b in zip(jo, to):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=2e-3,
                                       atol=2e-3)


def test_chain_cotangents_match_jax_dense():
    """x -> axis_weights -> P2G and G2P: the float64 cotangents with respect
    to x, v and the grids through autograd of the plain route against
    jax.vjp of the JAX dense chain (1e-12)."""
    jcfg, tcfg = _cfgs()
    x, v, C, stress, imp, rng = _scene(5)
    wx, wy, wz = WINDOW
    xj = tuple(jnp.asarray(x[d]) for d in range(3))
    sizes, corner, _ = jmpm.window_geometry(jcfg, xj)
    tc = torch.tensor([int(c) for c in corner], dtype=torch.int32)
    gv = [rng.randn(wy * wz, wx) for _ in range(3)]
    dgm, dgmom = rng.randn(wy * wz, wx), rng.randn(3, wy * wz, wx)
    dv, dC = rng.randn(3, N), rng.randn(3, 3, N)
    Cm, Sm = (jm33.from_mat_array(jnp.asarray(a)) for a in (C, stress))

    def jchain(xa, va, g0, g1, g2):
        xv = tuple(xa[d] for d in range(3))
        W, WD = jmpm.axis_weights(jcfg, xv, sizes, corner)
        H = jmpm.hyz_family(jcfg, W, WD)
        grid = jmpm.p2g_dense(jcfg, W, WD, *H, tuple(va[d] for d in range(3)),
                              Cm, Sm, tuple(jnp.asarray(imp)))
        vn, Cn, _ = jmpm.g2p_dense(jcfg, W, WD, *H, (g0, g1, g2), xv)
        return grid, jnp.stack(vn), jm33.to_mat_array(Cn)

    outs, vjp = jax.vjp(jchain, jnp.asarray(x), jnp.asarray(v),
                        *map(jnp.asarray, gv))
    ref = vjp(((jnp.asarray(dgm),) + tuple(jnp.asarray(dgmom)),
               jnp.asarray(dv), jnp.asarray(dC)))

    tx, tv = (torch.as_tensor(a).requires_grad_() for a in (x, v))
    tgv = [torch.as_tensor(g).requires_grad_() for g in gv]
    W, WD = tmpm.axis_weights(tcfg, tx, sizes, tc)
    ws = (W[0], WD[0], W[1], WD[1], W[2], WD[2])
    t = torch.as_tensor
    chan = tmpm._p2g_channels(tcfg, tuple(tv), m33.from_mat_array(t(C)),
                              m33.from_mat_array(t(stress)), tuple(t(imp)))
    gm, gmom = fused.p2g(*ws, chan)
    out = fused.g2p(*ws, *tgv)
    got = torch.autograd.grad(
        (gm, gmom, out[:3], out[3:].reshape(3, 3, N)), (tx, tv, *tgv),
        (t(dgm), t(dgmom).permute(1, 0, 2).reshape(wy * wz, 3 * wx), t(dv),
         4.0 * tcfg.inv_dx * t(dC)))
    for a, b in zip(got, ref):
        assert _rel(a, b) < 1e-12


def test_wrappers_dispatch():
    """CPU tensors take the plain versions and count no launch; other
    devices raise."""
    ws = [torch.zeros(w, 4) for w in (8, 8, 8, 8, 8, 8)]
    gv = [torch.zeros(64, 8)] * 3
    fused.p2g(*ws, torch.zeros(13, 4))
    fused.g2p(*ws, *gv)
    fused.splat(*ws[0::2], torch.zeros(3, 4))
    fused.gather(*ws[0::2], *gv)
    meta = [torch.empty(8, 4, device="meta")] * 6
    for fn, args in ((fused.p2g, (*meta, torch.empty(13, 4, device="meta"))),
                     (fused.gather, (*meta[0::2], *[torch.empty(
                         64, 8, device="meta")] * 3))):
        with pytest.raises(TypeError, match="no implementation"):
            fn(*args)
    assert all(f.launches == 0 for f in (fused.p2g, fused.g2p, fused.splat,
                                         fused.gather))
    assert build.SIGNATURES["softmac_fused_p2g"]
