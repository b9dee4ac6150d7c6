"""PyTorch port, the slice as a whole: the pour_vel forward rollout of
softmac_tpu_torch.SoftMacEnv against the JAX package's SoftMacEnv.rollout.

A 400-particle pour_vel scene (demo_pour_vel_config.py, window (48, 32, 16))
is built in both packages from the same particles and rolled out for 5 env
steps of a fixed nonzero seeded action with loss_stride 1. On the CPU in
float64 the JAX side runs its dense transfers and XLA contact; the port runs
its sorted carry with the plain versions of its kernels. x and v agree to
1e-8 absolute, the loss and each term to 1e-8 relative. A second rollout
(loss_start_frame 1, loss_stride 3) takes the general loss-sampling path
of _sample_mask."""
from pathlib import Path

import numpy as np
import pytest
import torch

import softmac_tpu
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch import convert
from softmac_tpu_torch import load as torch_load

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WINDOW = (48, 32, 16)
N_STEPS = 5


def _particles(n=400):
    base = np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")
    pick = np.random.RandomState(3).choice(base.shape[0], n, replace=False)
    return base[pick, :3] + np.array([0.0, 0.04, 0.0])


def _actions():
    return np.random.RandomState(7).randn(N_STEPS, 12) * 0.05


def _cfg(load, pkg_dir):
    cfg = load(str(ROOT / pkg_dir / "config/demo_pour_vel_config.py"))
    cfg.defrost()
    cfg.TPU.active_window = WINDOW
    return cfg.freeze()


@pytest.fixture(scope="module")
def runs():
    jenv = softmac_tpu.SoftMacEnv(_cfg(softmac_tpu.load, "softmac_tpu"),
                                  init_particles=_particles())
    tenv = TorchEnv(_cfg(torch_load, "softmac_tpu_torch"), device="cpu",
                    init_particles=_particles())
    outs = {}
    for key, kw in (("block", dict(loss_stride=1)),
                    ("general", dict(loss_start_frame=1, loss_stride=3))):
        outs[key] = (jenv.rollout(_actions(), **kw),
                     tenv.rollout(_actions(), **kw))
    return jenv, tenv, outs


def test_initial_state_is_identical(runs):
    """Both envs start from the same bytes: the JAX initial carry and SDF
    tables carried over with convert equal the port's own."""
    jenv, tenv, _ = runs
    jm, jb, _ = jenv._initial_carry()
    tm, tb, _ = tenv._initial_carry()
    for got, ref in (
            (tm, convert.mpm_state({k: getattr(jm, k) for k in "xvCF"})),
            (tb, convert.body_state({k: getattr(jb, k)
                                     for k in ("pos", "quat", "v", "w")}))):
        for k in got.__dataclass_fields__:
            assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for jp, tp in zip(jenv.prims, tenv.prims):
        ref = convert.sdf_params({"neighborhood": jp.neighborhood,
                                  "lower": jp.lower, "upper": jp.upper,
                                  "inv_dx": jp.inv_dx, "res": jp.res})
        assert torch.equal(tp.neighborhood, ref.neighborhood)
        assert tp.geom == ref.geom and tp.res == ref.res
    for k in ("mu", "lam", "gravity", "friction"):
        assert torch.equal(getattr(tenv.mpm_params, k),
                           torch.as_tensor(np.array(getattr(jenv.mpm_params, k))))


def test_rollout_state_matches_jax(runs):
    jout, tout = runs[2]["block"]
    jm, jb, _ = jout["carry"]
    tm, tb, _ = tout["carry"]
    assert np.abs(tm.x.numpy() - np.asarray(jm.x)).max() <= 1e-8
    assert np.abs(tm.v.numpy() - np.asarray(jm.v)).max() <= 1e-8
    assert np.abs(tb.pos.numpy() - np.asarray(jb.pos)).max() <= 1e-12
    assert np.abs(tb.quat.numpy() - np.asarray(jb.quat)).max() <= 1e-12
    assert np.abs(np.asarray(jm.v)).max() > 0.1   # the liquid moved


@pytest.mark.parametrize("path", ["block", "general"])
@pytest.mark.parametrize("term", [
    "loss", "chamfer_loss", "pose_loss", "vel_loss", "final_chamfer_loss",
    "final_pose_loss", "final_vel_loss"])
def test_loss_terms_match_jax(runs, term, path):
    jout, tout = runs[2][path]
    if term == "loss":
        ref, got = float(jout["loss"]), float(tout["loss"])
    else:
        ref, got = float(jout["terms"][term]), float(tout["terms"][term])
    assert ref != 0.0
    assert abs(got - ref) <= 1e-8 * abs(ref)
    assert not bool(jout["terms"]["window_overflow"])
    assert not bool(tout["terms"]["window_overflow"])


def test_glass_contact_engages(runs):
    """The particle-contact path is exercised: the glass's wrench is
    nonzero in at least one of the rollout's steps."""
    tenv = runs[1]
    carry = tenv._initial_carry()
    acts = torch.as_tensor(_actions())
    forces = []
    for t in range(N_STEPS):
        carry, (_, ext_f) = tenv._env_step_fn(carry, acts[t])
        forces.append(ext_f[0].abs().max().item())
    assert max(forces) > 0.0
