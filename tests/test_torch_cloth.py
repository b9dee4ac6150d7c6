"""PyTorch port: the cloth modules of the hit (softmac_tpu_torch.engine.cloth,
cloth_contact and mpm.substep_cloth) against the JAX package and the NumPy
oracle (tests/oracle.py), in float64 on the CPU.

- ClothModel.step on the hit's towel (its sceneConfig: tol 1e-8, not
  reached in 20 iterations, damping 0.05) against JAX's: from rest under
  gravity, with an external force, with moved attachments from a
  perturbed state; the masked early stop engaged at a tolerance of 5e-7
  (it differs from the fixed 20 iterations). x within 1e-12 of |x|, v * dt
  (the step's displacement) too, and the vjp against jax.vjp within
  1e-10. Rest without gravity is a fixed point.
- The Python BFS equals the cached adjacency_towel.obj.npz exactly.
- get_contact_pair and trace_penetration_after_mpm equal
  oracle_cloth_pair / oracle_cloth_trace_after_mpm exactly,
  trace_penetration_after_cloth equals JAX's.
- collide_cloth: mixed mode (sticky and not) within 1e-12 of
  oracle_cloth_collide_mixed; particle mode and the mixed mode's vjp with
  both gradient scales against JAX's.
- Ten substep_cloth steps against oracle_substep_cloth_mixed at the gates
  of tests/test_oracle_cloth.py (x 1e-9, v 1e-8, ids and bits exact,
  vertex forces 1e-8): the hit's window (32, 24, 32) on a 32-cell grid
  (the x-based "transfer" route, rows 1-8's plain versions), unsorted and
  re-sorted every substep with the side-state, sticky and not, and the
  full grid (the dense route).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softmac_tpu.engine import cloth as jcloth
from softmac_tpu.engine import cloth_contact as jcc
from softmac_tpu.engine.meshgen import generate_grid

import softmac_tpu_torch
from softmac_tpu_torch.engine import cloth, cloth_contact as cc, mpm
from softmac_tpu_torch.engine.materials import lame_parameters
from softmac_tpu_torch.engine.meshio import load_obj
from softmac_tpu_torch.engine.types import (
    CONTACT_MIXED, MAT_PLASTIC, MODEL_COROTATED, MPMConfig, MPMParams,
    mpm_state_zero,
)

from oracle import (
    oracle_cloth_collide_mixed, oracle_cloth_pair,
    oracle_cloth_trace_after_mpm, oracle_substep_cloth_mixed,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
T64 = dict(dtype=torch.float64)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _towel():
    """The hit's towel as its env builds it, and the solver parameters."""
    cfg = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_hit_config.py"))
    verts, faces = load_obj(ROOT / "envs/assets/towel/towel.obj")
    verts = cloth.transform_mesh(verts, dict(cfg.CLOTH.transform[0]))
    sp = cloth.parse_scene_config(dict(cfg.CLOTH.sceneConfig[0]))
    sp.update(dt=cfg.env_dt, velocity_damping=cfg.CLOTH.velocity_damping)
    return verts, faces, sp


VERTS, FACES, SP = _towel()


@pytest.fixture(scope="module")
def models():
    return (cloth.ClothModel(VERTS, FACES, dtype=torch.float64, **SP),
            jcloth.ClothModel(VERTS, FACES, dtype=jnp.float64, **SP))


def _step_cases(rng):
    V = VERTS.shape[0]
    rest = VERTS.copy()
    att = rest[[0, 11]]
    zero = np.zeros((V, 3))
    moved_x = rest + 1e-3 * rng.randn(V, 3)
    return {
        "gravity": (rest, zero, att, zero),
        "force": (rest, 0.05 * rng.randn(V, 3), att, 2e-3 * rng.randn(V, 3)),
        "attachments": (moved_x, 0.02 * rng.randn(V, 3),
                        att + np.array([0.01, -0.02, 0.015]), zero),
    }


def _jstep(jm):
    return jax.jit(lambda x, v, a, f: jm.step(jcloth.ClothState(x=x, v=v), a,
                                              f))


def _check_step(tm, jstep, x, v, a, f, attach):
    ref = jstep(*map(jnp.asarray, (x, v, a, f)))
    st = cloth.ClothState(x=torch.tensor(x), v=torch.tensor(v))
    got = tm.step(st, torch.tensor(a) if attach else None, torch.tensor(f))
    _close(got.x.numpy(), np.asarray(ref.x), 1e-12)
    # v = (1 - damping) (x' - x) / dt: the same 1e-12 of |x| on the step's
    # displacement, v * dt
    np.testing.assert_allclose(got.v.numpy() * tm.dt,
                               np.asarray(ref.v) * tm.dt, rtol=0,
                               atol=1e-12 * np.abs(x).max())
    return st, got


def test_cloth_step_matches_jax(models):
    """The hit's tolerance, 1e-8, is below what 20 iterations reach on
    these cases (their last residual 1e-7 to 1e-5): the step equals the
    fixed 20 iterations."""
    tm, jm = models
    assert tm.convergence_tol == 1e-8 and tm.n_iterations == 20
    jstep = _jstep(jm)
    fixed = cloth.ClothModel(VERTS, FACES, dtype=torch.float64,
                             **{**SP, "convergence_tol": None})
    for name, (x, v, a, f) in _step_cases(np.random.RandomState(0)).items():
        st, got = _check_step(tm, jstep, x, v, a, f, name != "gravity")
        full = fixed.step(st, torch.tensor(a), torch.tensor(f))
        np.testing.assert_array_equal(full.x.numpy(), got.x.numpy())


def test_cloth_early_stop_matches_jax():
    """A tolerance of 5e-7 stops the step from rest under gravity after 5
    of its 20 iterations (the residuals fall 3.9e-5, 4.6e-6, 1.6e-6,
    7.5e-7, 4.4e-7): the masked loop against JAX's, and apart from the
    fixed 20 iterations."""
    sp = {**SP, "convergence_tol": 5e-7}
    tm = cloth.ClothModel(VERTS, FACES, dtype=torch.float64, **sp)
    jm = jcloth.ClothModel(VERTS, FACES, dtype=jnp.float64, **sp)
    x, v, a, f = _step_cases(np.random.RandomState(0))["gravity"]
    st, got = _check_step(tm, _jstep(jm), x, v, a, f, True)
    full = cloth.ClothModel(VERTS, FACES, dtype=torch.float64,
                            **{**SP, "convergence_tol": None}).step(
        st, None, torch.tensor(f))
    diff = float((full.x - got.x).abs().max())
    assert 1e-8 < diff < 1e-5, diff


def test_cloth_step_vjp_matches_jax(models):
    tm, jm = models
    rng = np.random.RandomState(1)
    x, v, a, f = _step_cases(rng)["attachments"]
    ct = rng.randn(2, *x.shape)

    def jfn(x, v, a, f):
        out = jm.step(jcloth.ClothState(x=x, v=v), a, f)
        return out.x, out.v
    _, vjp = jax.vjp(jax.jit(jfn), *map(jnp.asarray, (x, v, a, f)))
    ref = vjp((jnp.asarray(ct[0]), jnp.asarray(ct[1])))
    ins = [torch.tensor(t, requires_grad=True) for t in (x, v, a, f)]
    out = tm.step(cloth.ClothState(x=ins[0], v=ins[1]), ins[2], ins[3])
    got = torch.autograd.grad(
        (out.x * torch.tensor(ct[0])).sum() + (out.v * torch.tensor(ct[1])
                                               ).sum(), ins)
    for g, r in zip(got, ref):
        assert float(np.abs(np.asarray(r)).max()) > 0
        _close(g.numpy(), np.asarray(r), 1e-10)


def test_cloth_rest_is_fixed_point():
    tm = cloth.ClothModel(VERTS, FACES, dtype=torch.float64,
                          **{**SP, "gravity": 0.0})
    s = tm.init_state()
    out = tm.step(s, None, torch.zeros_like(s.x))
    np.testing.assert_allclose(out.x.numpy(), VERTS, atol=1e-12)
    np.testing.assert_allclose(out.v.numpy(), 0.0, atol=1e-9)
    assert float(tm.pd_residual(s)) < 1e-12


def test_process_faces_equals_cached_adjacency():
    nb, nd = cc.process_faces(FACES, n_neighbors=200)
    cached = np.load(ROOT / "envs/assets/towel/adjacency_towel.obj.npz")
    np.testing.assert_array_equal(nb, cached["neighbors"])
    np.testing.assert_array_equal(nd, cached["dirs"])
    assert nb.dtype == np.int32 and nd.dtype == np.int8


def _params(sticky=False, geom=1.0, cv=1.0):
    cached = np.load(ROOT / "envs/assets/towel/adjacency_towel.obj.npz")
    t = torch.tensor
    return cc.ClothContactParams(
        faces=torch.as_tensor(FACES, dtype=torch.int64),
        neighbor_faces=torch.as_tensor(cached["neighbors"]),
        neighbor_dirs=torch.as_tensor(cached["dirs"]),
        friction=t(10.0, **T64), softness=t(666.0, **T64),
        cloth_force_scale=t(1.0, **T64), mpm_force_scale=t(1.0, **T64),
        sticky=sticky, contact_geom_grad_scale=geom,
        contact_cv_grad_scale=cv)


def _jparams(sticky=False, geom=1.0, cv=1.0):
    cached = np.load(ROOT / "envs/assets/towel/adjacency_towel.obj.npz")
    a = jnp.asarray
    return jcc.ClothContactParams(
        faces=a(FACES, jnp.int32), neighbor_faces=a(cached["neighbors"]),
        neighbor_dirs=a(cached["dirs"]), friction=a(10.0),
        softness=a(666.0), cloth_force_scale=a(1.0), mpm_force_scale=a(1.0),
        sticky=sticky, contact_geom_grad_scale=geom,
        contact_cv_grad_scale=cv)


def _near_towel(n, rng, spread=0.012):
    """n points at random spots of random faces, pushed off the face plane
    by up to +-spread, and a tenth of them far away."""
    f = FACES[rng.randint(0, len(FACES), n)]
    w = rng.dirichlet(np.ones(3), n)
    tri = VERTS[f]
    p = np.einsum("nk,nkd->nd", w, tri)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    p = p + nrm * rng.uniform(-spread, spread, (n, 1))
    p[: n // 10] += 0.2
    return p


def _vec(a):
    return tuple(torch.tensor(np.ascontiguousarray(a.T)))


def test_pairs_and_tracing_match_oracle():
    rng = np.random.RandomState(2)
    n = 400
    x_prev = _near_towel(n, rng)
    pen_prev = (rng.rand(n) < 0.2).astype(np.int8)
    x_new = x_prev + rng.uniform(-0.006, 0.006, (n, 3))
    params = _params()
    cloth_x = torch.tensor(VERTS)

    cid_prev = cc.get_contact_pair(params, cloth_x, _vec(x_prev),
                                   torch.tensor(pen_prev))
    ocid_prev = oracle_cloth_pair(FACES, VERTS, x_prev, pen_prev)
    np.testing.assert_array_equal(cid_prev.numpy(), ocid_prev)
    assert cid_prev.dtype == torch.int32 and (ocid_prev >= 0).sum() > 200
    pen = cc.PenetrationState(contact_id=cid_prev,
                              penetration=torch.tensor(pen_prev))
    cid_new = cc.get_contact_pair(params, cloth_x, _vec(x_new),
                                  pen.penetration)
    ocid_new = oracle_cloth_pair(FACES, VERTS, x_new, pen_prev)
    np.testing.assert_array_equal(cid_new.numpy(), ocid_new)
    traced = cc.trace_penetration_after_mpm(params, cloth_x, _vec(x_new),
                                            _vec(x_prev), pen, cid_new)
    cached = np.load(ROOT / "envs/assets/towel/adjacency_towel.obj.npz")
    want = oracle_cloth_trace_after_mpm(
        FACES, cached["neighbors"], cached["dirs"], VERTS, x_new, x_prev,
        ocid_prev, pen_prev, ocid_new)
    np.testing.assert_array_equal(traced.penetration.numpy(), want)
    assert traced.penetration.dtype == torch.int8
    assert 0 < int((want != pen_prev).sum())

    # after the cloth moved: the new face on the new cloth, the old on the
    # old, against JAX's
    cloth_new = VERTS + rng.uniform(-0.008, 0.008, VERTS.shape)
    cid2 = cc.get_contact_pair(params, torch.tensor(cloth_new), _vec(x_new),
                               traced.penetration)
    got = cc.trace_penetration_after_cloth(
        params, torch.tensor(cloth_new), cloth_x, _vec(x_new), traced, cid2)
    jpen = jcc.PenetrationState(contact_id=jnp.asarray(traced.contact_id),
                                penetration=jnp.asarray(traced.penetration))
    jx = tuple(jnp.asarray(x_new[:, d]) for d in range(3))
    jparams = _jparams()
    jcid2 = jax.jit(jcc.get_contact_pair)(jparams, jnp.asarray(cloth_new),
                                          jx, jpen.penetration)
    ref = jax.jit(jcc.trace_penetration_after_cloth)(
        jparams, jnp.asarray(cloth_new), jnp.asarray(VERTS), jx, jpen, jcid2)
    np.testing.assert_array_equal(cid2.numpy(), np.asarray(jcid2))
    np.testing.assert_array_equal(got.penetration.numpy(),
                                  np.asarray(ref.penetration))
    assert 0 < int((np.asarray(ref.penetration)
                    != traced.penetration.numpy()).sum())


def _contact_inputs(seed=3, n=300):
    rng = np.random.RandomState(seed)
    x = _near_towel(n, rng, spread=0.008)
    v = rng.randn(n, 3) * 0.5
    cloth_v = rng.randn(*VERTS.shape) * 0.1
    pen = (rng.rand(n) < 0.25).astype(np.int8)
    cid = oracle_cloth_pair(FACES, VERTS, x, pen)
    pen = np.where(cid >= 0, pen, 0).astype(np.int8)
    return x, v, cloth_v, cid, pen


@pytest.mark.parametrize("sticky", [False, True])
def test_collide_cloth_mixed_matches_oracle(sticky):
    x, v, cloth_v, cid, pen = _contact_inputs()
    dt, p_mass, life = 2e-4, 6.103515625e-05, 1.0 / 3
    v_out, ext = cc.collide_cloth(
        _params(sticky), torch.tensor(VERTS), torch.tensor(cloth_v), _vec(x),
        _vec(v), p_mass, dt, life,
        cc.PenetrationState(contact_id=torch.tensor(cid),
                            penetration=torch.tensor(pen)),
        VERTS.shape[0])
    ov, oext = oracle_cloth_collide_mixed(
        FACES, VERTS, cloth_v, x, v, p_mass, dt, life, cid, pen,
        friction=10.0, softness=666.0, sticky=sticky)
    changed = np.abs(ov - v).max(axis=1) > 0
    assert changed.sum() > 20 and ((pen != 0) & changed).sum() > 0
    _close(torch.stack(v_out).numpy().T, ov, 1e-12)
    _close(ext.numpy(), oext, 1e-12)


def _jcontact(x, v, cloth_v, cid, pen):
    a = jnp.asarray
    return (a(VERTS), a(cloth_v), tuple(a(x[:, d]) for d in range(3)),
            tuple(a(v[:, d]) for d in range(3)),
            jcc.PenetrationState(contact_id=a(cid), penetration=a(pen)))


def test_collide_cloth_particle_mode_matches_jax():
    x, v, cloth_v, cid, pen = _contact_inputs(seed=4)
    dt, p_mass = 2e-4, 6.103515625e-05
    cxj, cvj, xj, vj, penj = _jcontact(x, v, cloth_v, cid, pen)
    ref = jax.jit(lambda *a: jcc.collide_cloth(
        _jparams(), *a[:4], p_mass, dt, 1.0, a[4], VERTS.shape[0],
        mode="particle"))(cxj, cvj, xj, vj, penj)
    imp, ext = cc.collide_cloth(
        _params(), torch.tensor(VERTS), torch.tensor(cloth_v), _vec(x),
        _vec(v), p_mass, dt, 1.0,
        cc.PenetrationState(contact_id=torch.tensor(cid),
                            penetration=torch.tensor(pen)),
        VERTS.shape[0], mode="particle")
    assert float(np.abs(np.asarray(ref[1])).max()) > 0
    _close(torch.stack(imp).numpy(), np.stack(ref[0]), 1e-12)
    _close(ext.numpy(), np.asarray(ref[1]), 1e-12)


def test_collide_cloth_grad_scales_match_jax():
    """The mixed mode's vjp with contact_geom_grad_scale 0.3 and
    contact_cv_grad_scale 0.5 against JAX's; the values are the unscaled
    ones."""
    x, v, cloth_v, cid, pen = _contact_inputs(seed=5)
    dt, p_mass, life = 2e-4, 6.103515625e-05, 0.5
    rng = np.random.RandomState(6)
    ct_v, ct_e = rng.randn(*x.shape), rng.randn(*VERTS.shape)
    cxj, cvj, xj, vj, penj = _jcontact(x, v, cloth_v, cid, pen)
    jp = _jparams(geom=0.3, cv=0.5)

    def jfn(cx, cv, xs, vs):
        out, ext = jcc.collide_cloth(jp, cx, cv, xs, vs, p_mass, dt, life,
                                     penj, VERTS.shape[0])
        return jnp.stack(out, axis=1), ext
    ref, vjp = jax.vjp(jax.jit(jfn), cxj, cvj, xj, vj)
    rg = vjp((jnp.asarray(ct_v), jnp.asarray(ct_e)))
    ins = [torch.tensor(t, requires_grad=True)
           for t in (VERTS, cloth_v, x.T.copy(), v.T.copy())]
    pen_t = cc.PenetrationState(contact_id=torch.tensor(cid),
                                penetration=torch.tensor(pen))
    out, ext = cc.collide_cloth(_params(geom=0.3, cv=0.5), ins[0], ins[1],
                                tuple(ins[2]), tuple(ins[3]), p_mass, dt,
                                life, pen_t, VERTS.shape[0])
    unscaled = cc.collide_cloth(_params(), *(t.detach() for t in ins[:2]),
                                tuple(ins[2].detach()),
                                tuple(ins[3].detach()), p_mass, dt, life,
                                pen_t, VERTS.shape[0])
    _close(torch.stack(out).detach().numpy().T, np.asarray(ref[0]), 1e-12)
    np.testing.assert_array_equal(ext.detach().numpy(),
                                  unscaled[1].numpy())
    got = torch.autograd.grad(
        (torch.stack(out).T * torch.tensor(ct_v)).sum()
        + (ext * torch.tensor(ct_e)).sum(), ins)
    for g, r in zip(got[:2], rg[:2]):
        assert float(np.abs(np.asarray(r)).max()) > 0
        _close(g.numpy(), np.asarray(r), 1e-10)
    for g, r in zip(got[2:], rg[2:]):
        _close(g.numpy(), np.stack(r), 1e-10)


# ---------------------------------------------------------------------------
# ten substeps against oracle_substep_cloth_mixed (tests/test_oracle_cloth.py's
# scene: a blob falling onto a pinned horizontal sheet)
# ---------------------------------------------------------------------------
N_SUB = 10


def _sheet():
    verts, faces = generate_grid(nx=9, nz=9, width=0.36, height=0.36)
    verts = verts[:, [0, 2, 1]] + np.array([0.5 - 0.18, 0.5, 0.5 - 0.18])
    nb, nd = cc.process_faces(faces, n_neighbors=60)
    cloth_v = np.zeros_like(verts)
    cloth_v[:, 0] = 0.05
    return verts, faces, nb, nd, cloth_v


def _blob(n=256, seed=3):
    rng = np.random.RandomState(seed)
    x0 = np.empty((n, 3))
    x0[:, 0] = 0.4 + 0.2 * rng.rand(n)
    x0[:, 1] = 0.501 + 0.03 * rng.rand(n)
    x0[:, 2] = 0.4 + 0.2 * rng.rand(n)
    return x0


@pytest.fixture(scope="module")
def oracle_runs():
    """Ten oracle substeps of the sheet scene, sticky and not."""
    verts, faces, nb, nd, cloth_v = _sheet()
    mu, lam = lame_parameters(5e3, 0.2, MAT_PLASTIC)
    out = {}
    for sticky in (True, False):
        x = _blob()
        n = x.shape[0]
        v = np.zeros((n, 3))
        v[:, 1] = -1.0
        C = np.zeros((n, 3, 3))
        F = np.tile(np.eye(3), (n, 1, 1))
        pen = np.zeros((n,), np.int8)
        cid = oracle_cloth_pair(faces, verts, x, pen)
        ext_sum = np.zeros(verts.shape)
        for k in range(N_SUB):
            x_prev = x.copy()
            x, v, C, F, ext = oracle_substep_cloth_mixed(
                x, v, C, F, dt=2e-4, n_grid=32, mpm_scale=1.0, mu=mu,
                lam=lam, gravity=(0.0, -5.0, 0.0), faces=faces,
                cloth_x=verts, cloth_v=cloth_v, cid=cid, pen=pen,
                life=1.0 / (N_SUB - k), friction=1.0, softness=666.0,
                sticky=sticky, material_model=0, ptype=0,
                ground_friction=1.5)
            ext_sum += ext
            cid_new = oracle_cloth_pair(faces, verts, x, pen)
            pen = oracle_cloth_trace_after_mpm(faces, nb, nd, verts, x,
                                               x_prev, cid, pen, cid_new)
            cid = cid_new
        out[sticky] = (x, v, cid, pen, ext_sum)
    return out


@pytest.mark.parametrize("window,sorted_carry,sticky", [
    ((32, 24, 32), False, False), ((32, 24, 32), True, False),
    ((32, 24, 32), False, True), (None, False, True)],
    ids=["transfer", "transfer-sorted", "transfer-sticky", "dense-sticky"])
def test_substep_cloth_matches_oracle(oracle_runs, window, sorted_carry,
                                      sticky):
    verts, faces, nb, nd, cloth_v = _sheet()
    n = 256
    cfg = MPMConfig(n_particles=n, n_grid=32, dt=2e-4, substeps=N_SUB,
                    material_model=MODEL_COROTATED, ptype=MAT_PLASTIC,
                    collision_type=CONTACT_MIXED, ground_friction=1.5,
                    active_window=window, dtype=torch.float64)
    assert mpm.transfer_route(cfg) == ("dense" if window is None
                                       else "transfer")
    mu, lam = lame_parameters(5e3, 0.2, MAT_PLASTIC)
    params = MPMParams(
        mu=torch.full((n,), mu, **T64), lam=torch.full((n,), lam, **T64),
        yield_stress=torch.full((n,), 60.0, **T64),
        gravity=torch.tensor([0.0, -5.0, 0.0], **T64),
        control_idx=torch.full((n,), -1, dtype=torch.int32),
        friction=torch.zeros(1, **T64), softness=torch.zeros(1, **T64))
    t = torch.tensor
    cparams = cc.ClothContactParams(
        faces=torch.as_tensor(faces, dtype=torch.int64),
        neighbor_faces=torch.as_tensor(nb), neighbor_dirs=torch.as_tensor(nd),
        friction=t(1.0, **T64), softness=t(666.0, **T64),
        cloth_force_scale=t(1.0, **T64), mpm_force_scale=t(1.0, **T64),
        sticky=sticky)
    cx, cv = torch.tensor(verts), torch.tensor(cloth_v)
    state = mpm_state_zero(cfg, torch.tensor(_blob()))
    state = state.replace(v=state.v.index_fill(0, torch.tensor([1]), -1.0))
    pen = cc.PenetrationState(
        contact_id=cc.get_contact_pair(cparams, cx, tuple(state.x),
                                       torch.zeros(n, dtype=torch.int8)),
        penetration=torch.zeros(n, dtype=torch.int8))
    ids = torch.arange(n)
    ext_sum = torch.zeros_like(cx)
    for k in range(N_SUB):
        if sorted_carry:
            q, _ = mpm.sort_perm(cfg, state.x)
            state, pen, ids = (mpm.permute_state(state, q),
                               cc.permute_pen(pen, q), ids[q])
            params = mpm.permute_params(params, q)
        x_prev = state.x
        state, ext, aux = mpm.substep_cloth(cfg, params, cparams, state, cx,
                                            cv, pen, k)
        assert not bool(aux["window_overflow"])
        ext_sum = ext_sum + ext
        cid = cc.get_contact_pair(cparams, cx, tuple(state.x),
                                  pen.penetration)
        pen = cc.trace_penetration_after_mpm(cparams, cx, tuple(state.x),
                                             tuple(x_prev), pen, cid)
    inv = torch.argsort(ids)
    state, pen = mpm.permute_state(state, inv), cc.permute_pen(pen, inv)

    ox, ov, ocid, open, oext = oracle_runs[sticky]
    assert int((ocid >= 0).sum()) > 20 and float(np.abs(oext).max()) > 0
    np.testing.assert_allclose(state.x.numpy().T, ox, atol=1e-9)
    np.testing.assert_allclose(state.v.numpy().T, ov, atol=1e-8)
    np.testing.assert_array_equal(pen.contact_id.numpy(), ocid)
    np.testing.assert_array_equal(pen.penetration.numpy(), open)
    np.testing.assert_allclose(ext_sum.numpy(), oext, atol=1e-8)
