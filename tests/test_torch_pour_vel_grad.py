"""PyTorch port, the slice as a whole: the pour_vel rollout_and_grad of
softmac_tpu_torch.SoftMacEnv against the JAX package's
SoftMacEnv.rollout_and_grad, in float64 on the CPU.

The 400-particle pour_vel scene and window (48, 32, 16) of
test_torch_pour_vel.py, with the same seeded actions.

- Case A: 5 env steps, loss_stride 1, in both packages. Loss and terms
  agree to 1e-8 relative, the action gradient to 1e-8 of its largest
  |value|.
- Case B: the loss weights set to chamfer only (1, 0, 0) in both configs,
  loss_start_frame 1, loss_stride 3, bptt_window 2 and a grad_clip cap
  below the unclipped cotangent norm. The chamfer depends on the actions
  only through contact, so a nonzero gradient in the glass's columns that
  matches JAX shows that the contact backward is on the path; the clipped
  gradient differs from the unclipped one. Case B runs 6 env steps: with
  5, the general loss-sampling path makes five one-step blocks and a
  bptt_window of 2 then cuts every block into a segment of its own, where
  the chamfer has no action gradient at all.
- Port only: remat "step", "none" and "window:2" give the same action
  gradient (1e-12 relative), and rollout and rollout_and_grad the same loss.

The chamfer's frozen-argmin backward is also held on its own against the
JAX custom_vjp, with row blocks smaller than the input and tied distances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import softmac_tpu
from softmac_tpu.engine.losses import common as jcommon
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch import load as torch_load
from softmac_tpu_torch.engine.losses import common as tcommon

from test_torch_pour_vel import _cfg, _particles

torch.set_num_threads(1)

RTOL = 1e-8
CLIP = 1e3   # below the case-B carry cotangent norm (about 2e3)
GLASS_COLS = [2, 3, 4]   # the glass's wz, vx, vy: the demo's action columns


def _actions(n_steps):
    return np.random.RandomState(7).randn(n_steps, 12) * 0.05


def _envs(chamfer_only=False):
    cfgs = [_cfg(softmac_tpu.load, "softmac_tpu"),
            _cfg(torch_load, "softmac_tpu_torch")]
    if chamfer_only:
        for c in cfgs:
            c.defrost()
            c.ENV.loss.weight = (1.0, 0.0, 0.0)
            c.freeze()
    return (softmac_tpu.SoftMacEnv(cfgs[0], init_particles=_particles()),
            TorchEnv(cfgs[1], device="cpu", init_particles=_particles()))


@pytest.fixture(scope="module")
def case_a():
    jenv, tenv = _envs()
    acts = _actions(5)
    return (tenv, acts, jenv.rollout_and_grad(acts, loss_stride=1),
            tenv.rollout_and_grad(acts, loss_stride=1))


@pytest.fixture(scope="module")
def case_b():
    jenv, tenv = _envs(chamfer_only=True)
    acts = _actions(6)
    kw = dict(loss_start_frame=1, loss_stride=3, bptt_window=2)
    return (jenv.rollout_and_grad(acts, grad_clip=CLIP, **kw),
            tenv.rollout_and_grad(acts, grad_clip=CLIP, **kw),
            tenv.rollout_and_grad(acts, **kw))


def _grad_close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("term", [
    "loss", "chamfer_loss", "pose_loss", "vel_loss", "final_chamfer_loss",
    "final_pose_loss", "final_vel_loss"])
def test_case_a_loss_matches_jax(case_a, term):
    _, _, jout, tout = case_a
    if term == "loss":
        ref, got = float(jout["loss"]), float(tout["loss"])
    else:
        ref, got = float(jout["terms"][term]), float(tout["terms"][term])
    assert ref != 0.0
    assert abs(got - ref) <= RTOL * abs(ref)
    assert not bool(tout["terms"]["window_overflow"])


def test_case_a_action_grad_matches_jax(case_a):
    tenv, acts, jout, tout = case_a
    g = tout["action_grad"]
    assert g.shape == acts.shape and g.dtype == tenv.dtype
    assert not g.requires_grad and not tout["loss"].requires_grad
    _grad_close(g.numpy(), jout["action_grad"], RTOL)


def test_case_b_contact_gradient_matches_jax(case_b):
    jout, tout, _ = case_b
    assert abs(float(tout["loss"]) - float(jout["loss"])) \
        <= RTOL * abs(float(jout["loss"]))
    jg = np.asarray(jout["action_grad"])
    assert np.abs(jg[:, GLASS_COLS]).max() > 0
    _grad_close(tout["action_grad"].numpy(), jg, RTOL)


def test_case_b_clipping_engaged(case_b):
    _, clipped, unclipped = case_b
    a, b = clipped["action_grad"], unclipped["action_grad"]
    assert float(clipped["loss"]) == float(unclipped["loss"])
    assert (a - b).abs().max() > 0.1 * b.abs().max()


@pytest.mark.parametrize("remat", ["none", "window:2"])
def test_remat_modes_agree(case_a, remat):
    tenv, acts, _, tout = case_a
    got = tenv.rollout_and_grad(acts, loss_stride=1, remat=remat)
    _grad_close(got["action_grad"], tout["action_grad"], 1e-12)
    assert float(got["loss"]) == float(tout["loss"])


def test_rollout_and_grad_loss_is_rollout_loss(case_a):
    tenv, acts, _, tout = case_a
    fwd = tenv.rollout(acts, loss_stride=1)
    assert not fwd["loss"].requires_grad
    assert abs(float(fwd["loss"]) - float(tout["loss"])) \
        <= 1e-12 * abs(float(tout["loss"]))


def test_bad_remat_raises(case_a):
    tenv, acts, _, _ = case_a
    with pytest.raises(ValueError, match="remat"):
        tenv.rollout_and_grad(acts, remat="layer")


def test_chamfer_backward_matches_jax(monkeypatch):
    """Frozen-argmin cotangents with 7-row blocks over 40 points and
    duplicated targets (ties keep the first index, as jnp.argmin)."""
    rng = np.random.RandomState(2)
    a, b = rng.rand(40, 3), rng.rand(25, 3)
    b[3] = b[10] = a[0] + 1e-3     # a[0]'s closest target, twice
    a[5] = a[30] = b[7] + 1e-3     # target 7's closest point, twice
    monkeypatch.setattr(tcommon, "_CHAMFER_BLOCK_ELEMS", 7 * 25)
    ta = torch.as_tensor(a).requires_grad_()
    tb = torch.as_tensor(b).requires_grad_()
    loss = tcommon.chamfer(ta, tb)
    got = torch.autograd.grad(loss, (ta, tb),
                              torch.tensor(1.7, dtype=torch.float64))
    ref_loss, vjp = jax.vjp(jcommon.chamfer, jnp.asarray(a), jnp.asarray(b))
    ref = vjp(jnp.asarray(1.7))
    assert abs(loss.item() - float(ref_loss)) <= 1e-12 * float(ref_loss)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(r)).max())
