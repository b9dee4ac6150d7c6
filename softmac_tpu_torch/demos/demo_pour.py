"""Pour demo: optimise a wrench trajectory (torque and force on the glass)
so that the liquid lands in the bowl, by gradient descent through
``SoftMacEnv.rollout_and_grad`` (``demos/demo_pour.py`` of the JAX package,
reference ``softmac/demo_pour.py``).

    python -m softmac_tpu_torch.demos.demo_pour [--device cpu] [--epochs N]
        [--steps T] [--remat step|none|window:K] [--safeguard]
        [--init-actions ckpt/actions_K.npy] [--log-root DIR]

The initial actions are compensated for gravity and the contact wrench
(``adjust_action_with_ext_force``); two Adam controllers (torque at 0.3x the
force's lr, b1 = 0) step on the action gradient every epoch; each epoch
writes ``<log-root>/<exp-name>/ckpt/actions_<epoch>.npy`` and ``losses.npy``.
Runs on the card unless ``--device cpu``. ``--body-contact`` turns on the
rigid-rigid penalty contact between the glass and the bowl
(``RIGID.body_contact``; the reference's Jade world resolves it by LCP).
Every ``--render-interval`` epochs (and after the first) the epoch's actions
are replayed through the facade and drawn to ``epoch<K>.gif`` on the env's
device, with the target overlaid; ``loss_curve.png`` at the end.
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from softmac_tpu_torch import SoftMacEnv
from softmac_tpu_torch.utils import (
    Controller, EpochTimer, make_gif_from_numpy, plot_loss_curve, prepare,
    render,
)

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "softmac_tpu_torch/config/demo_pour_config.py"
TARGET = ROOT / "envs/pour/pour_mpm_target_position_corotated.npy"


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--exp-name", "-n", type=str, default="pour")
    parser.add_argument("--config", type=str, default=str(CONFIG))
    parser.add_argument("--log-root", type=str, default="logs",
                        help="directory the experiment's log dir goes in")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--render-interval", type=int, default=5,
                        help="render a GIF every K epochs (0 disables)")
    parser.add_argument("--init-actions", type=str, default=None,
                        help="resume from a saved ckpt/actions_*.npy")
    parser.add_argument("--remat", type=str, default="step",
                        help="rollout remat policy: step | none | window:K")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--body-contact", action="store_true",
                        help="rigid-rigid contact between the glass and the "
                             "bowl")
    parser.add_argument("--safeguard", action="store_true",
                        help="reject overshooting Adam steps (rollback + lr "
                             "halving); off = raw reference driver")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the optimisation; returns {"losses", "epoch_seconds"} per
    epoch."""
    args = parse_args(argv)
    log_dir, cfg = prepare(args, args.log_root)
    if args.body_contact:
        # the glass clinks on the bowl (off by default: the reference
        # trajectory never makes the bodies touch)
        cfg.defrost()
        cfg.RIGID.body_contact = True
        cfg.freeze()
    env = SoftMacEnv(cfg, device=args.device)
    try:
        env.set_render_target(np.load(TARGET))
    except FileNotFoundError:
        pass

    if args.init_actions:
        # a saved per-epoch checkpoint, already compensated
        actions0 = np.asarray(np.load(args.init_actions))[:args.steps]
    else:
        actions0 = env.adjust_action_with_ext_force(np.zeros((args.steps, 12)))
    n_act = max(args.steps // 20, 1)    # one action per 20 steps
    # two optimisers with different lrs, as in the reference (torque 0.3x)
    torque_ctl = Controller(n_act, 3, args.steps, lr=1e-2 * 0.3, warmup=5,
                            decay=0.98, betas=(0.0, 0.999),
                            actions_init=actions0[:, :3])
    force_ctl = Controller(n_act, 3, args.steps, lr=1e-2, warmup=5,
                           decay=0.98, betas=(0.0, 0.999),
                           actions_init=actions0[:, 3:6])

    # --safeguard: when an epoch's loss regresses, roll both optimisers back
    # to the pre-step state, halve their base lrs and re-step with the
    # stashed gradient (no extra rollouts)
    prev_loss, snap, g_prev = np.inf, None, None
    loss_log, epoch_seconds = [], []
    print("Optimizing Trajectory...")
    for epoch in range(args.epochs):
        timer = EpochTimer()
        timer.start("forward")
        acts = np.zeros((args.steps, 12))
        acts[:, :3] = torque_ctl.get_actions()
        acts[:, 3:6] = force_ctl.get_actions()
        total_frames = args.steps * env.substeps
        start = (2 * total_frames // 3) // 20 * 20   # 2000 at 3000 steps
        out = env.rollout_and_grad(acts, loss_start_frame=start,
                                   loss_stride=20, remat=args.remat)
        loss = float(out["loss"])
        timer.stop()

        timer.start("optimize")
        g = out["action_grad"].cpu().numpy()
        if args.safeguard:
            if loss > prev_loss and snap is not None:
                torque_ctl.restore(snap[0])
                force_ctl.restore(snap[1])
                torque_ctl.lr *= 0.5
                force_ctl.lr *= 0.5
                g = g_prev
                print(f"  [safeguard] overshoot ({loss:.1f} > "
                      f"{prev_loss:.1f}): rolled back, lr halved")
            else:
                prev_loss = loss
            snap = (torque_ctl.snapshot(), force_ctl.snapshot())
            g_prev = g
        torque_ctl.step(g[:, :3])
        force_ctl.step(g[:, 3:6])
        timer.stop()

        terms = {k: float(v) for k, v in out["terms"].items()}
        timer.report(epoch, force_ctl.latest_lr,
                     "Loss: {:.4f} chamfer: {:.4f} pose: {:.4f} vel: {:.4f}"
                     .format(loss, terms.get("chamfer_loss", 0),
                             terms.get("pose_loss", 0),
                             terms.get("vel_loss", 0)))
        print("Final chamfer: {:.4f} pose: {:.4f} vel: {:.4f}".format(
            terms.get("final_chamfer_loss", 0),
            terms.get("final_pose_loss", 0), terms.get("final_vel_loss", 0)))
        rigid = out["carry"][2].q.cpu().numpy()
        print("Rigid e: {} x: {}".format(rigid[:3], rigid[3:6]))
        loss_log.append(loss)
        epoch_seconds.append(sum(timer.times.values()))
        np.save(log_dir / "ckpt" / f"actions_{epoch}.npy", acts)
        np.save(log_dir / "losses.npy", np.asarray(loss_log))

        if args.render_interval > 0 and (
                (epoch + 1) % args.render_interval == 0 or epoch == 0):
            images = render(env, action=acts, n_steps=args.steps,
                            interval=args.steps // 50)
            make_gif_from_numpy(images, log_dir, f"epoch{epoch}")

    plot_loss_curve(log_dir, loss_log)
    return {"losses": loss_log, "epoch_seconds": epoch_seconds}


if __name__ == "__main__":
    main()
