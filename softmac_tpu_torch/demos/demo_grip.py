"""Grip demo: optimise the two prismatic fingers' force trajectory so that
they squeeze a plasticine block toward a target shape, by gradient descent
through ``SoftMacEnv.rollout_and_grad`` (``demos/demo_grip.py`` of the JAX
package, reference ``softmac/demo_grip.py``).

    python -m softmac_tpu_torch.demos.demo_grip [--device cpu] [--epochs N]
        [--steps T] [--remat step|none|window:K]
        [--init-actions ckpt/actions_K.npy] [--log-root DIR]

The palm's contact is off, as in the reference (demo_grip.py:117). The
fingers start from 0.3 N inward (the demo's choice 2); one Adam controller
(one action per 10 env steps, b1 = 0.5) steps on the action gradient every
epoch, whose loss frames are every 20th substep from three quarters of the
horizon on. Each epoch is one ``rollout_and_grad`` from the initial state
and writes ``<log-root>/<exp-name>/ckpt/actions_<epoch>.npy`` and
``losses.npy``. Runs on the card unless ``--device cpu``. Every
``--render-interval`` epochs (and after the first) the epoch's actions are
replayed through the facade and drawn to ``epoch<K>.gif``, with the target
shape overlaid; ``loss_curve.png`` at the end.
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
CONFIG = ROOT / "softmac_tpu_torch/config/demo_grip_config.py"
TARGET = ROOT / "envs/grip/grip_mpm_target_position.npy"


def get_init_actions(steps, choice=2):
    """The reference's initial finger forces: none (choice 0), or 1.2 N
    (choice 1) or 0.3 N (choice 2) on each finger, inward."""
    if choice == 0:
        return np.zeros((steps, 2))
    scale = 1.2 if choice == 1 else 0.3
    return np.ones((steps, 2)) * np.array([1.0, -1.0]) * scale


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--exp-name", "-n", type=str, default="grip")
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
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--steps", type=int, default=400)
    return parser.parse_args(argv)


def main(argv=None):
    """Run the optimisation; returns {"losses", "epoch_seconds"} per
    epoch."""
    args = parse_args(argv)
    log_dir, cfg = prepare(args, args.log_root)
    env = SoftMacEnv(cfg, device=args.device)
    try:
        env.set_render_target(np.load(TARGET))
    except FileNotFoundError:
        pass
    env.set_primitives_contact([False, True, True])     # palm contact off

    actions0 = get_init_actions(args.steps, choice=2)
    if args.init_actions:
        # resume from a saved per-epoch trajectory checkpoint
        actions0 = np.asarray(np.load(args.init_actions))[:args.steps]
    controller = Controller(
        num_actions=max(args.steps // 10, 1), action_dim=2, steps=args.steps,
        lr=1e-1, warmup=5, decay=0.99, betas=(0.5, 0.999),
        actions_init=actions0)

    loss_log, epoch_seconds = [], []
    print("Optimizing Trajectory...")
    for epoch in range(args.epochs):
        timer = EpochTimer()
        timer.start("forward")
        acts = controller.get_actions()
        total_frames = args.steps * env.substeps
        start = (3 * total_frames // 4) // 20 * 20   # 1500 at 400 steps
        out = env.rollout_and_grad(acts, loss_start_frame=start,
                                   loss_stride=20, remat=args.remat)
        loss = float(out["loss"])
        timer.stop()

        timer.start("optimize")
        controller.step(out["action_grad"].cpu().numpy())
        timer.stop()

        terms = {k: float(v) for k, v in out["terms"].items()}
        timer.report(epoch, controller.latest_lr,
                     "Loss: {:.4f} pose: {:.4f} vel: {:.4f} chamfer: {:.4f}"
                     .format(loss, terms.get("pose_loss", 0),
                             terms.get("vel_loss", 0),
                             terms.get("chamfer_loss", 0)))
        print("Final pose: {:.4f} vel: {:.4f} chamfer: {:.4f}".format(
            terms.get("final_pose_loss", 0), terms.get("final_vel_loss", 0),
            terms.get("final_chamfer_loss", 0)))
        rigid = out["carry"][2]
        print("Rigid x: {} v: {}".format(rigid.q.cpu().numpy(),
                                         rigid.qd.cpu().numpy()))
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
