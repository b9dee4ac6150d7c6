"""Body-body contact demo: drop the pour scene's glass onto the bowl (the
port of ``scripts/demo_body_contact.py``).

    python -m softmac_tpu_torch.demos.demo_body_contact [--device cpu]
        [--steps N] [--no-stick] [--render] [--log-root DIR]

The glass free-falls (zero actions, no gravity compensation) from just
above the floating bowl, clinks onto it and comes to rest supported by it
with ``RIGID.body_contact`` on; with it off it falls through. Both runs go
through the facade (``env.step``), 2000 of the pour's particles parked
away from the bodies. Afterwards the per-step deepest glass-bowl overlap
(each body's surface samples in the other's SDF table, the most negative
value) is computed in one batched call over the recorded states. Checks
the script's four discriminators: the run without contact overlaps by
more than a wall's thickness (3 mm) and never moves the bowl; the run with
it stays within 3 mm, above the other's overlap, and pushes the bowl down
by more than 1 cm. Writes ``<log-root>/body_contact/trajectory.npy`` (a
dict of both runs' q and overlaps) and, with ``--render``,
``body_contact.gif``: about 20 frames of the run with contact from its
recorded history. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from softmac_tpu_torch import SoftMacEnv, load
from softmac_tpu_torch.engine import quat as Q
from softmac_tpu_torch.ops.contact import sample_sdf_normal_world
from softmac_tpu_torch.utils import make_gif_from_numpy

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "softmac_tpu_torch/config/demo_pour_config.py"
N_PARTICLES = 2000
GLASS_START = (0.34, 0.38, 0.5)   # centred above the bowl's interior


def parse_args(argv=None):
    ap = ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--log-root", type=str, default="logs",
                    help="directory the body_contact log dir goes in")
    ap.add_argument("--no-stick", action="store_true",
                    help="Coulomb-clamped viscous friction instead of the "
                         "stick branch")
    ap.add_argument("--render", action="store_true",
                    help="write body_contact.gif of the run with contact")
    return ap.parse_args(argv)


def build_env(body_contact: bool, stick: bool, device=None):
    """The pour scene with the drop's settings: settle-friendly contact
    constants, the stick branch (or not), the glass above the bowl, the
    particles parked, no loss."""
    cfg = load(str(CONFIG))
    cfg.defrost()
    cfg.RIGID.body_contact = body_contact
    cfg.RIGID.body_contact_stiffness = 5e4
    cfg.RIGID.body_contact_damping = 100.0
    cfg.RIGID.body_contact_stick = 0.9 if stick else 0.0
    init = list(cfg.RIGID.init_state)
    init[3:6] = GLASS_START
    cfg.RIGID.init_state = tuple(init)
    cfg.ENV.loss_type = ""
    cfg.freeze()
    base = np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")
    pick = np.random.RandomState(0).choice(base.shape[0], N_PARTICLES,
                                           replace=False)
    pts = base[pick, :3] * 0.3 + np.array([0.15, 0.0, 0.15])
    return SoftMacEnv(cfg, device=device, init_particles=pts)


def overlap_depths(env, qs: torch.Tensor) -> torch.Tensor:
    """(T,) the deepest glass-bowl overlap at each recorded q (T, D): both
    bodies' surface samples against the other's SDF table, in one batched
    call (the scene's two bodies are floating: q = [exp(3), pos(3)])."""
    m = env.rigid_model
    if [b.jtype for b in m.bodies] != ["floating", "floating"]:
        raise ValueError("the drop scene has two floating bodies")
    pose = [(qs[:, b.q_offset + 3:b.q_offset + 6],
             Q.w2quat(qs[:, b.q_offset:b.q_offset + 3])) for b in m.bodies]
    worst = None
    for a, b in ((0, 1), (1, 0)):
        pts = torch.as_tensor(m.bodies[a].contact_points, dtype=qs.dtype,
                              device=qs.device)
        pos_a, q_a = pose[a]
        pos_b, q_b = pose[b]
        p_w = Q.qrot(q_a[:, None], pts[None]) + pos_a[:, None]   # (T, K, 3)
        sdf, _ = sample_sdf_normal_world(
            env.prims[b], tuple(pos_b[:, None, d] for d in range(3)),
            tuple(q_b[:, None, d] for d in range(4)),
            tuple(p_w[..., d] for d in range(3)))
        depth = sdf.min(dim=1).values
        worst = depth if worst is None else torch.minimum(worst, depth)
    return worst


def run(env, steps):
    """``steps`` facade steps of zero actions: (q (steps, D) numpy, the
    overlap depths (steps,) numpy)."""
    zero = np.zeros(env.action_dim)
    qs = []
    for _ in range(steps):
        env.step(zero)
        qs.append(env._carry[2].q)
    qs = torch.stack(qs)
    return qs.cpu().numpy(), overlap_depths(env, qs).cpu().numpy()


def render_gif(env, log_dir, steps):
    """``body_contact.gif`` of ``env``'s recorded history: every
    max(steps // 20, 1)-th of its ``steps`` env steps and the start."""
    frames = range(0, steps + 1, max(steps // 20, 1))
    make_gif_from_numpy([env.render(f * env.substeps) for f in frames],
                        log_dir, "body_contact")
    print(f"wrote {Path(log_dir) / 'body_contact.gif'}")


def main(argv=None):
    """Both drops and the checks; returns the numbers the checks read."""
    args = parse_args(argv)
    stick = not args.no_stick
    log_dir = Path(args.log_root) / "body_contact"
    log_dir.mkdir(parents=True, exist_ok=True)
    traj_off, depth_off = run(build_env(False, stick, args.device), args.steps)
    env_on = build_env(True, stick, args.device)
    traj_on, depth_on = run(env_on, args.steps)
    np.save(log_dir / "trajectory.npy",
            {"on": traj_on, "off": traj_off,
             "depth_on": depth_on, "depth_off": depth_off})
    # the bowl's height (q[10]): pushed down by the clink with contact,
    # untouched without
    out = {"steps": args.steps, "stick": stick,
           "glass_y_start": float(traj_on[0, 4]),
           "glass_y_final_on": float(traj_on[-1, 4]),
           "glass_y_final_off": float(traj_off[-1, 4]),
           "depth_min_on": float(depth_on.min()),
           "depth_min_off": float(depth_off.min()),
           "bowl_drop_on": float(traj_on[0, 10] - traj_on[:, 10].min()),
           "bowl_drop_off": float(traj_off[0, 10] - traj_off[:, 10].min())}
    print("glass y: start {glass_y_start:.3f}, final ON {glass_y_final_on:.3f}"
          " / OFF {glass_y_final_off:.3f}".format(**out))
    print("deepest glass-bowl overlap: OFF {depth_min_off:.4f} m (pass-"
          "through at wall thickness), ON {depth_min_on:.4f} m (penalty-"
          "bounded)".format(**out))
    print("bowl pushed down: ON {bowl_drop_on:.4f} m (clink transmitted), "
          "OFF {bowl_drop_off:.6f} m (no interaction)".format(**out))
    assert out["depth_min_off"] < -0.003, \
        "the scene never overlapped: geometry off"
    assert (out["depth_min_on"] > -0.003
            and out["depth_min_on"] > out["depth_min_off"]), \
        f"body contact failed to bound the overlap: {out['depth_min_on']}"
    assert out["bowl_drop_off"] < 1e-4, out["bowl_drop_off"]
    assert out["bowl_drop_on"] > 0.01, out["bowl_drop_on"]
    if args.render:
        render_gif(env_on, log_dir, args.steps)
    return out


if __name__ == "__main__":
    main()
