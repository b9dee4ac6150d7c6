"""PyTorch port: the dense transfer route (softmac_tpu_torch.engine.mpm:
transfer_route "dense", hyz_family, p2g_dense, splat_channels, g2p_dense,
gather_dense) against the JAX package and the NumPy oracle, in float64 on
the CPU (the plain versions).

- The five dense functions against the JAX package's (mpm.py:151-357) on
  the same axis weights, within 1e-12 of each output's largest |value|, on
  the full 16^3 grid and on a (16, 12, 12) window that neither kernel rule
  takes (some stencils cut by it). The port packs P2G's inputs into the
  (13, N) channel block of _p2g_channels and returns G2P's C unscaled
  (times 4 inv_dx outside, as the substep does).
- The route against the branch the JAX package's _Transfers takes in
  float32 (y-chunked -> "transfer", fused -> "fused", else "dense") for no
  window and four windows.
- The dense substep with no primitive (the grid-contact branch) against
  tests/oracle.py oracle_substep for 30 substeps, at the tolerances of
  tests/test_mpm_core.py (x and F 1e-10, v 1e-8, C 1e-6).
- The full-grid flagship pour (TPU.active_window cleared) at 400
  particles over 3 env steps: rollout_and_grad on the dense route against
  the same call on the x-based route (monkeypatched), the end state and
  the action gradient within 1e-10.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softmac_tpu.engine import mpm as jmpm
from softmac_tpu.engine.types import MPMConfig as JConfig

import softmac_tpu_torch
from softmac_tpu_torch import SoftMacEnv
from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine.materials import lame_parameters
from softmac_tpu_torch.engine.types import (
    CONTACT_GRID, MAT_ELASTIC, MAT_LIQUID, MODEL_COROTATED,
    MODEL_NEOHOOKEAN, BodyState, MPMParams, mpm_state_zero)
from softmac_tpu_torch.engine.types import MPMConfig as TConfig
from softmac_tpu_torch.ops import kr, m33

sys.path.insert(0, str(Path(__file__).resolve().parent))
from oracle import oracle_substep  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NG = 16
N = 300


def _close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("window", [None, (16, 12, 12)])
def test_dense_functions_match_jax(window):
    rng = np.random.RandomState(5)
    x = 0.2 + 0.6 * rng.rand(3, N)
    v, imp = rng.randn(3, N), 1e-3 * rng.randn(3, N)
    C, stress = rng.randn(3, 3, N), rng.randn(3, 3, N)
    kw = dict(n_particles=N, n_grid=NG, dt=1e-4, active_window=window)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, dtype=torch.float64)
    assert tmpm.transfer_route(tcfg) == "dense"
    t = torch.as_tensor
    sizes, corner, _ = tmpm.window_geometry(tcfg, t(x))
    if window:
        base = np.floor(x * NG - 0.5) - corner.numpy()[:, None]
        cut = ((base < 0) | (base + 2 >= np.array(sizes)[:, None])).any(0)
        assert 0 < cut.sum() < N, "want stencils inside and cut"

    jW, jWD = jmpm.axis_weights(jcfg, tuple(jnp.asarray(x)), sizes,
                                tuple(jnp.int32(c) for c in corner.tolist()))
    jH = jmpm.hyz_family(jcfg, jW, jWD)
    W, WD = tmpm.axis_weights(tcfg, t(x), sizes, corner)
    for a, b in zip(W + WD, jW + jWD):
        _close(a, b)
    H = tmpm.hyz_family(W, WD)
    for a, b in zip(H, jH):
        _close(a, b)

    wx = sizes[0]
    vt, Ct = tuple(t(v)), m33.from_mat_array(t(C))
    chan = tmpm._p2g_channels(tcfg, vt, Ct, m33.from_mat_array(t(stress)),
                              tuple(t(imp)))
    gm, gmom = tmpm.p2g_dense(W, WD, *H, chan)
    jgrid = jmpm.p2g_dense(
        jcfg, jW, jWD, *jH, tuple(jnp.asarray(v)),
        tuple(tuple(jnp.asarray(C[i, j]) for j in range(3))
              for i in range(3)),
        tuple(tuple(jnp.asarray(stress[i, j]) for j in range(3))
              for i in range(3)), tuple(jnp.asarray(imp)))
    _close(gm, jgrid[0])
    for d in range(3):
        _close(gmom[:, d * wx:(d + 1) * wx], jgrid[1 + d])

    vals = rng.randn(3, N)
    out = tmpm.splat_channels(W, H[0], t(vals))
    ref = jmpm.splat_channels(jcfg, jW, jH[0],
                              [jnp.asarray(c) for c in vals])
    for d in range(3):
        _close(out[:, d * wx:(d + 1) * wx], ref[d])

    gv = [rng.randn(sizes[1] * sizes[2], wx) for _ in range(3)]
    jgv = tuple(jnp.asarray(g) for g in gv)
    vc = tmpm.g2p_dense(W, WD, *H, tuple(t(g) for g in gv))
    jv, jC, _ = jmpm.g2p_dense(jcfg, jW, jWD, *jH, jgv,
                               tuple(jnp.asarray(x)))
    assert vc.shape == (12, N)
    for d in range(3):
        _close(vc[d], jv[d])
        for j in range(3):
            _close(4.0 * tcfg.inv_dx * vc[3 + 3 * d + j], jC[d][j])
    got = tmpm.gather_dense(W, H[0], tuple(t(g) for g in gv))
    for d, r in enumerate(jmpm.gather_dense(jcfg, jW, jH[0], jgv)):
        _close(got[d], r)


def _jax_branch(window):
    """The branch JAX's _Transfers takes for this window in float32 over
    the sorted carry: the two static decisions its __init__ combines
    (mpm.py:430-432), without building the transfers."""
    cfg = JConfig(n_particles=8, n_grid=64, active_window=window,
                  dtype=jnp.float32)
    use_fused = jmpm._fused_transfer_wanted(cfg, jnp.float32)
    use_chunked = use_fused and jmpm._chunked_transfer_wanted(
        cfg, jnp.float32)
    return ("transfer" if use_chunked else "fused" if use_fused
            else "dense")


@pytest.mark.parametrize("window", [None, (48, 32, 16), (32, 16, 32),
                                    (16, 12, 12), (40, 32, 12)])
def test_route_matches_jax_transfers(window):
    cfg = TConfig(n_particles=8, active_window=window)
    assert tmpm.transfer_route(cfg) == _jax_branch(window)


@pytest.mark.parametrize("model,ptype", [(MODEL_NEOHOOKEAN, MAT_ELASTIC),
                                         (MODEL_COROTATED, MAT_LIQUID)])
def test_dense_substep_matches_oracle(model, ptype):
    n = 64
    rng = np.random.RandomState(0)
    x = 0.45 + 0.1 * rng.rand(n, 3)
    cfg = TConfig(n_particles=n, n_grid=NG, dt=1e-4, substeps=10,
                  material_model=model, ptype=ptype,
                  collision_type=CONTACT_GRID, dtype=torch.float64)
    assert tmpm.transfer_route(cfg) == "dense"
    mu, lam = lame_parameters(5e3, 0.2, ptype)
    f64 = dict(dtype=torch.float64)
    params = MPMParams(
        mu=torch.full((n,), mu, **f64), lam=torch.full((n,), lam, **f64),
        yield_stress=torch.full((n,), 50.0, **f64),
        gravity=torch.tensor((0.0, -9.8, 0.0), **f64),
        control_idx=torch.full((n,), -1, dtype=torch.int32),
        friction=torch.zeros((0,), **f64), softness=torch.zeros((0,), **f64))
    state = mpm_state_zero(cfg, torch.as_tensor(x))
    bodies = BodyState.identity(0, torch.float64)
    xo, vo = x, np.zeros((n, 3))
    Co, Fo = np.zeros((n, 3, 3)), np.tile(np.eye(3), (n, 1, 1))
    for _ in range(30):
        state, _, _ = tmpm.substep(cfg, params, (), state, bodies, 0)
        xo, vo, Co, Fo = oracle_substep(
            xo, vo, Co, Fo, dt=cfg.dt, n_grid=NG, mu=mu, lam=lam,
            gravity=(0.0, -9.8, 0.0), material_model=model, ptype=ptype,
            ground_friction=cfg.ground_friction)
    np.testing.assert_allclose(state.x.numpy().T, xo, atol=1e-10)
    np.testing.assert_allclose(state.v.numpy().T, vo, atol=1e-8)
    np.testing.assert_allclose(np.moveaxis(state.C.numpy(), -1, 0), Co,
                               atol=1e-6)
    np.testing.assert_allclose(np.moveaxis(state.F.numpy(), -1, 0), Fo,
                               atol=1e-10)
    assert np.abs(vo).max() > 1e-3, "the scene did not move"


def test_full_grid_pour_matches_x_based_route(monkeypatch):
    cfg = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_pour_config.py"))
    cfg.defrost()
    cfg.TPU.active_window = None
    cfg.freeze()
    x0 = np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")[
        :400, :3] + np.array([0.0, 0.04, 0.0])
    env = SoftMacEnv(cfg, device="cpu", init_particles=x0)
    assert tmpm.transfer_route(env.mpm_cfg) == "dense"
    acts = 0.05 * np.random.RandomState(2).randn(3, env.action_dim)
    calls = []
    plain = kr.kr3_plain
    monkeypatch.setattr(kr, "kr3_plain", lambda *a: calls.append(1)
                        or plain(*a))

    def run():
        return env.rollout_and_grad(acts, loss_start_frame=0, loss_stride=1,
                                    remat="none")
    dense = run()
    assert len(calls) == 3                     # one pair build a substep
    monkeypatch.setattr(tmpm, "transfer_route", lambda c: "transfer")
    ref = run()
    assert len(calls) == 3
    _close(dense["carry"][0].x, ref["carry"][0].x, 1e-10)
    _close(dense["carry"][2].q, ref["carry"][2].q, 1e-10)
    _close(dense["action_grad"], ref["action_grad"], 1e-10)
    np.testing.assert_allclose(dense["loss"].item(), ref["loss"].item(),
                               rtol=1e-10)
    assert ref["action_grad"].abs().max() > 0
