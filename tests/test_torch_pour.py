"""PyTorch port, the slice as a whole: the flagship pour (forecast mixed
contact, two floating force-controlled bodies) of softmac_tpu_torch.
SoftMacEnv against the coupled NumPy oracle and the JAX package, in float64
on the CPU.

- State: the 400-particle scene of test_oracle_coupled.build_small_pour_env
  (full grid), 3 env steps of its seeded actions through the port's
  _env_step_fn, against run_oracle_env_steps at that test's tolerances
  (x 1e-9, v 1e-7, q 1e-8, qd 1e-6 absolute).
- Rollout: the same particles with the demo's window (48, 32, 16), 3 env
  steps, loss_stride 1: the port's rollout and rollout_and_grad against
  the JAX rollout_and_grad (which returns what its rollout does): loss and
  each term agree to 1e-8 relative, the end state to 1e-8 absolute.
- Gradient: rollout_and_grad of the same steps (loss_stride 1), the action
  gradient to 1e-8 of its largest |value|. On the CPU the port's gather,
  splat and mixed contact run through their autograd Functions (Gather,
  Splat, CollideMixed) whose backward is the plain vjp: the yardstick of
  their backward kernels on the card. The same under
  SOFTMAC_TPU_CONTACT_SPLIT (CollideMixedSplit) against JAX's merged
  gradient.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import softmac_tpu
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch import load as torch_load

from test_oracle_coupled import build_small_pour_env, run_oracle_env_steps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WINDOW = (48, 32, 16)
N_STEPS = 3
RTOL = 1e-8


def _particles(n=400):
    base = np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")
    pick = np.random.RandomState(3).choice(base.shape[0], n, replace=False)
    return base[pick, :3] + np.array([0.0, 0.04, 0.0])


def _actions(action_dim):
    return np.random.RandomState(7).randn(N_STEPS, action_dim) * 0.05


def _cfg(load, pkg_dir, window):
    cfg = load(str(ROOT / pkg_dir / "config/demo_pour_config.py"))
    cfg.defrost()
    cfg.TPU.active_window = tuple(window)
    return cfg.freeze()


def _torch_env(window):
    return TorchEnv(_cfg(torch_load, "softmac_tpu_torch", window),
                    device="cpu", init_particles=_particles())


def test_pour_env_steps_match_coupled_oracle():
    jenv = build_small_pour_env(n=400)
    tenv = _torch_env(())
    acts = _actions(jenv.action_dim)
    assert tenv.action_dim == jenv.action_dim == 12
    ox, ov, oq, oqd = run_oracle_env_steps(jenv, acts)
    carry = tenv._initial_carry()
    for a in acts:
        carry, (overflow, ext_f) = tenv._env_step_fn(carry, torch.as_tensor(a))
    mpm, _, rigid = carry
    assert np.abs(mpm.x.numpy().T - ox).max() < 1e-9
    assert np.abs(mpm.v.numpy().T - ov).max() < 1e-7
    assert np.abs(rigid.q.numpy() - oq).max() < 1e-8
    assert np.abs(rigid.qd.numpy() - oqd).max() < 1e-6
    # the contact engaged: the glass took a wrench and moved
    assert np.abs(oqd).max() > 0 and float(ext_f[0].abs().max()) > 0


@pytest.fixture(scope="module")
def runs():
    jenv = softmac_tpu.SoftMacEnv(_cfg(softmac_tpu.load, "softmac_tpu",
                                       WINDOW), init_particles=_particles())
    tenv = _torch_env(WINDOW)
    acts = _actions(tenv.action_dim)
    # JAX's rollout_and_grad returns what its rollout does and the gradient
    return (jenv.rollout_and_grad(acts, loss_stride=1),
            tenv.rollout(acts, loss_stride=1),
            tenv.rollout_and_grad(acts, loss_stride=1))


@pytest.mark.parametrize("term", [
    "loss", "chamfer_loss", "pose_loss", "vel_loss", "final_chamfer_loss",
    "final_pose_loss", "final_vel_loss"])
def test_rollout_loss_matches_jax(runs, term):
    jout = runs[0]
    ref = float(jout["loss"] if term == "loss" else jout["terms"][term])
    assert ref != 0.0
    for tout in runs[1:]:
        got = float(tout["loss"] if term == "loss" else tout["terms"][term])
        assert abs(got - ref) <= RTOL * abs(ref)
        assert not bool(tout["terms"]["window_overflow"])


def test_rollout_state_matches_jax(runs):
    jout, tout = runs[0], runs[1]
    jm, _, jr = jout["carry"]
    tm, _, tr = tout["carry"]
    np.testing.assert_allclose(tm.x.numpy(), np.asarray(jm.x), rtol=0,
                               atol=RTOL)
    np.testing.assert_allclose(tm.v.numpy(), np.asarray(jm.v), rtol=0,
                               atol=RTOL)
    np.testing.assert_allclose(tr.q.numpy(), np.asarray(jr.q), rtol=0,
                               atol=RTOL)
    np.testing.assert_allclose(tr.qd.numpy(), np.asarray(jr.qd), rtol=0,
                               atol=RTOL)


def test_action_grad_matches_jax(runs):
    jg = np.asarray(runs[0]["action_grad"])
    g = runs[2]["action_grad"]
    assert g.shape == jg.shape and not g.requires_grad
    assert np.abs(jg).max() > 0
    assert np.abs(g.numpy() - jg).max() <= RTOL * np.abs(jg).max()


def test_split_action_grad_matches_jax(runs, monkeypatch):
    """The split contact (CollideMixedSplit) under rollout_and_grad: loss
    and action gradient as JAX's merged run, and the Function was used."""
    from softmac_tpu_torch.ops import contact
    monkeypatch.setenv("SOFTMAC_TPU_CONTACT_SPLIT", "1")
    calls = []
    apply = contact.CollideMixedSplit.apply
    monkeypatch.setattr(contact.CollideMixedSplit, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    tenv = _torch_env(WINDOW)
    out = tenv.rollout_and_grad(_actions(tenv.action_dim), loss_stride=1)
    jout = runs[0]
    assert calls
    ref = float(jout["loss"])
    assert abs(float(out["loss"]) - ref) <= RTOL * abs(ref)
    jg = np.asarray(jout["action_grad"])
    assert np.abs(out["action_grad"].numpy() - jg).max() \
        <= RTOL * np.abs(jg).max()


def test_gather_cotangent_mostly_zero(monkeypatch):
    """What the gather backward kernel's skip relies on: rollout_and_grad
    hands Gather.backward a cotangent that is exactly zero for most
    particles (out of both bodies' contact bands the contact passes it
    through and the splat's -2 (v_tmp - v_tgt) takes it back), and the
    plain vjp with those particles dropped gives the same grid cotangents
    to the bit, and dx zero there."""
    from softmac_tpu_torch.ops import transfer
    seen = []
    vjp = transfer.gather_vjp_plain
    monkeypatch.setattr(transfer, "gather_vjp_plain",
                        lambda *a: seen.append(a) or vjp(*a))
    tenv = _torch_env(WINDOW)
    tenv.rollout_and_grad(_actions(tenv.action_dim), loss_stride=1)
    assert seen
    for x, gv0, gv1, gv2, corner, window, inv_dx, dv in seen:
        zero = (dv == 0).all(dim=0)
        assert int(zero.sum()) > x.shape[1] // 2, int(zero.sum())
        assert bool((dv[:, ~zero] != 0).any())
        full = vjp(x, gv0, gv1, gv2, corner, window, inv_dx, dv)
        kept = vjp(x[:, ~zero], gv0, gv1, gv2, corner, window, inv_dx,
                   dv[:, ~zero])
        assert torch.equal(full[0][:, zero], torch.zeros_like(x[:, zero]))
        for a, b in zip(full[1:], kept[1:]):
            assert torch.equal(a, b)
