"""PyTorch port: the gradients of the dense-weight transfer family
(softmac_tpu_torch.ops.fused: the autograd Functions FusedP2G, FusedG2P,
FusedSplat and FusedGather, the counterparts of pallas_fused's custom_vjps)
against the JAX package on the CPU, in float64.

- Each Function's cotangents of every input (the six or three weight
  matrices, and the channels, grids or values) against jax.vjp of
  pallas_fused._p2g_ref, _g2p_ref (rows 12-15 of its (16, N) given zero
  cotangent), _splat_ref and _gather_ref, at 1e-12 of each output's
  largest |value|, on the B-spline weights of mpm.axis_weights over a
  window that cuts some particles' stencils, and on fully dense random
  weights, window (16, 8, 16). The references' dots ask XLA for a float32
  result (pallas_fused._dg's preferred_element_type); here _dg is pinned to
  float64 at full precision for the test's duration (monkeypatch), so that
  the same formulas are held at 1e-12.
- torch.autograd.gradcheck of the four Functions at a tiny size.
- The cotangent of x through mpm.Transfers (window, axis_weights and the
  four transfers of one substep) against jax.vjp of jmpm.window_geometry,
  jmpm.axis_weights and the four _ref functions, 1e-12.
The backward kernels themselves are held to the plain vjps in
test_torch_kernel_source.py and on the card by chip_smoke.py.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax, vjp

from softmac_tpu.engine import mpm as jmpm
from softmac_tpu.ops import pallas_fused as jpf
from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.ops import fused

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fused import N, WINDOW, _cfgs, _rel, _scene, _ws  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def f64_refs(monkeypatch):
    """pallas_fused's reference dots in float64 at full precision."""
    def dg(a, b, dims, precision):
        return lax.dot_general(a, b, (dims, ((), ())),
                               precision=lax.Precision.HIGHEST)
    monkeypatch.setattr(jpf, "_dg", dg)


def _inputs(case, seed):
    """float64 numpy inputs of the four functions and seeded cotangents of
    their outputs."""
    _, _, ws, _, rng = _ws(case, seed)
    wx, wy, wz = WINDOW
    return dict(ws=ws, chan=rng.randn(13, N), vals=rng.randn(3, N),
                gv=[rng.randn(wy * wz, wx) for _ in range(3)],
                dgm=rng.randn(wy * wz, wx), dgmom=rng.randn(wy * wz, 3 * wx),
                g12=rng.randn(12, N), dout=rng.randn(wy * wz, 3 * wx),
                dv=rng.randn(3, N))


def _cases(d):
    """(JAX ref, its args, its cotangent, port function, its args, its
    cotangents, the Function's grad_fn name)."""
    j = {k: ([jnp.asarray(a) for a in v] if isinstance(v, list)
             else jnp.asarray(v)) for k, v in d.items()}
    chan16 = jnp.concatenate([j["chan"], jnp.zeros((3, N))])
    g16 = jnp.concatenate([j["g12"], jnp.zeros((4, N))])
    return [
        (jpf._p2g_ref, (*j["ws"], chan16), (j["dgm"], j["dgmom"]),
         fused.p2g, (*d["ws"], d["chan"]), (d["dgm"], d["dgmom"]),
         "FusedP2GBackward"),
        (jpf._g2p_ref, (*j["ws"], *j["gv"]), g16,
         fused.g2p, (*d["ws"], *d["gv"]), (d["g12"],), "FusedG2PBackward"),
        (jpf._splat_ref, (*j["ws"][0::2], j["vals"]), j["dout"],
         fused.splat, (*d["ws"][0::2], d["vals"]), (d["dout"],),
         "FusedSplatBackward"),
        (jpf._gather_ref, (*j["ws"][0::2], *j["gv"]), j["dv"],
         fused.gather, (*d["ws"][0::2], *d["gv"]), (d["dv"],),
         "FusedGatherBackward"),
    ]


@pytest.mark.parametrize("case", ["bspline", "dense"])
@pytest.mark.parametrize("fn", ["p2g", "g2p", "splat", "gather"])
def test_function_cotangents_match_jax_vjp(f64_refs, case, fn):
    d = _inputs(case, 11)
    jfn, jargs, jct, tfn, targs, tct, node = next(
        c for c in _cases(d) if c[3].__name__ == fn)
    jout, jvjp = vjp(jfn, *jargs)
    ins = [torch.tensor(a, requires_grad=True) for a in targs]
    out = tfn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    assert type(outs[0].grad_fn).__name__ == node
    jouts = jout if isinstance(jout, tuple) else (
        jout[:12] if fn == "g2p" else jout,)
    for a, b in zip(outs, jouts):
        assert a.dtype == torch.float64 and _rel(a.detach(), b) < 1e-12
    got = torch.autograd.grad(outs, ins, tuple(map(torch.as_tensor, tct)))
    ref = jvjp(jct)
    assert len(got) == len(ref) == len(ins)
    for a, b, i in zip(got, ref, ins):
        b = np.asarray(b)
        if b.shape != a.shape:        # JAX's (16, N) chan: 13 used rows
            assert not np.any(b[13:])
            b = b[:13]
        assert a.shape == i.shape and _rel(a, b) < 1e-12
    # dense in the row: cotangents on weight rows off a particle's stencil
    if case == "bspline":
        off = (got[0] != 0) & (ins[0] == 0)
        assert bool(off.any())


@pytest.mark.parametrize("fn", ["p2g", "g2p", "splat", "gather"])
def test_functions_gradcheck(fn):
    rng = np.random.RandomState(3)
    n, (wx, wy, wz) = 5, (4, 2, 3)
    t = lambda *s: torch.tensor(rng.randn(*s), requires_grad=True)  # noqa: E731
    ws = [t(w, n) for w in (wx, wx, wy, wy, wz, wz)]
    gv = [t(wy * wz, wx) for _ in range(3)]
    args = {"p2g": (fused.FusedP2G, (*ws, t(13, n))),
            "g2p": (fused.FusedG2P, (*ws, *gv)),
            "splat": (fused.FusedSplat, (*ws[0::2], t(3, n))),
            "gather": (fused.FusedGather, (*ws[0::2], *gv))}
    cls, ins = args[fn]
    assert torch.autograd.gradcheck(cls.apply, ins, eps=1e-6, atol=1e-8)


def test_transfers_cotangent_of_x_matches_jax(f64_refs):
    """x -> window -> axis_weights -> the substep's four dense-weight
    transfers (Transfers: P2G, gather, splat, G2P on one set of weights),
    the cotangent of x against jax.vjp of the JAX chain, 1e-12."""
    jcfg, tcfg = _cfgs()
    x, _, _, _, _, rng = _scene(8)
    wx, wy, wz = WINDOW
    chan, vals = rng.randn(13, N), rng.randn(3, N)
    gv = [rng.randn(wy * wz, wx) for _ in range(3)]
    cts = (rng.randn(wy * wz, wx), rng.randn(wy * wz, 3 * wx),
           rng.randn(3, N), rng.randn(wy * wz, 3 * wx), rng.randn(12, N))

    def jchain(xa):
        xv = tuple(xa[d] for d in range(3))
        sizes, corner, _ = jmpm.window_geometry(jcfg, xv)
        W, WD = jmpm.axis_weights(jcfg, xv, sizes, corner)
        ws = (W[0], WD[0], W[1], WD[1], W[2], WD[2])
        g = tuple(jnp.asarray(a) for a in gv)
        gm, gmom = jpf._p2g_ref(*ws, jnp.asarray(chan))
        return (gm, gmom, jpf._gather_ref(*W, *g),
                jpf._splat_ref(*W, jnp.asarray(vals)),
                jpf._g2p_ref(*ws, *g)[:12])
    _, jvjp = vjp(jchain, jnp.asarray(x))
    ref, = jvjp(tuple(jnp.asarray(c) for c in cts))

    tx = torch.tensor(x, requires_grad=True)
    tr = tmpm.Transfers(tcfg, tx)
    assert tr.route == "fused" and bool(tr.overflow)   # stencils cut
    tg = [torch.as_tensor(a) for a in gv]
    outs = (*tr.p2g(torch.as_tensor(chan)), tr.gather(tg),
            tr.splat(torch.as_tensor(vals)), tr.g2p(tg))
    got, = torch.autograd.grad(outs, tx, tuple(map(torch.as_tensor, cts)))
    assert np.abs(np.asarray(ref)).max() > 0
    assert _rel(got, ref) < 1e-12


def test_backward_wrappers_dispatch():
    """The backward wrappers run the plain vjp on CPU tensors (and count no
    launch) and raise on any device but the CPU and CUDA."""
    rng = np.random.RandomState(5)
    n, (wx, wy, wz) = 6, (4, 2, 3)
    t = lambda *s: torch.tensor(rng.randn(*s))  # noqa: E731
    ws = [t(w, n) for w in (wx, wx, wy, wy, wz, wz)]
    gv = [t(wy * wz, wx) for _ in range(3)]
    cases = [(fused.p2g_bwd, fused.p2g_vjp_plain,
              (*ws, t(13, n), t(wy * wz, wx), t(wy * wz, 3 * wx))),
             (fused.g2p_bwd, fused.g2p_vjp_plain, (*ws, *gv, t(12, n))),
             (fused.splat_bwd, fused.splat_vjp_plain,
              (*ws[0::2], t(3, n), t(wy * wz, 3 * wx))),
             (fused.gather_bwd, fused.gather_vjp_plain,
              (*ws[0::2], *gv, t(3, n)))]
    for bwd, plain, args in cases:
        for a, b in zip(bwd(*args), plain(*args)):
            assert torch.equal(a, b)
        with pytest.raises(TypeError, match="no implementation"):
            bwd(*(a.to("meta") for a in args))
        assert bwd.launches == 0
