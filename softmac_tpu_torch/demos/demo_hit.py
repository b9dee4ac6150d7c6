"""Hit demo: optimise the push of two MPM chopstick cylinders so that they
hit a hanging towel toward a rotated target pose, by gradient descent
through ``SoftMacEnv.rollout_and_grad`` (``demos/demo_hit.py`` of the JAX
package, reference ``soft_cloth/demo_hit.py``).

    python -m softmac_tpu_torch.demos.demo_hit [--device cpu] [--epochs N]
        [--steps T] [--remat step|none|window:K]
        [--init-actions ckpt/actions_K.npy] [--log-root DIR]

The particles of the first two shapes (the cylinders) follow the one
particle controller. The actions start from -8 on z; two Adam controllers
step on the action gradient, clipped to +-1, every epoch: xy at a tenth of
z's learning rate (demo_hit.py:44-54). The loss is the towel's distance to
``envs/mpm2towel/towel_target_45.npy`` at the final frame only. Each epoch
is one ``rollout_and_grad`` from the initial state and writes
``<log-root>/<exp-name>/ckpt/actions_<epoch>.npy`` and ``losses.npy``. Runs
on the card unless ``--device cpu``. Every ``--render-interval`` epochs (and
after the first) the epoch's actions are replayed through the facade and
drawn to ``epoch<K>.gif``, the target towel overlaid; ``loss_curve.png`` at
the end.
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
CONFIG = ROOT / "softmac_tpu_torch/config/demo_hit_config.py"
TARGET = ROOT / "envs/mpm2towel/towel_target_45.npy"


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--exp-name", "-n", type=str, default="hit")
    parser.add_argument("--config", type=str, default=str(CONFIG))
    parser.add_argument("--log-root", type=str, default="logs",
                        help="directory the experiment's log dir goes in")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--render-interval", type=int, default=5,
                        help="render a GIF every K epochs (0 disables)")
    parser.add_argument("--remat", type=str, default="step",
                        help="rollout remat policy: step | none | window:K")
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--init-actions", type=str, default=None,
                        help="resume from a saved ckpt/actions_*.npy")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the optimisation; returns {"losses", "epoch_seconds"} per
    epoch."""
    args = parse_args(argv)
    log_dir, cfg = prepare(args, args.log_root)
    env = SoftMacEnv(cfg, device=args.device)
    env.set_render_target(np.load(TARGET))
    # the two cylinders (4000 of the demo's 5000 particles) are controlled
    control_idx = np.full(env.n_particles, -1, np.int32)
    control_idx[:sum(int(s["n_particles"]) for s in cfg.SHAPES[:2])] = 0
    env.set_control_idx(control_idx)

    actions0 = np.zeros((args.steps, 3))
    actions0[:, 2] = -8.0
    if args.init_actions:
        actions0 = np.asarray(np.load(args.init_actions))[:args.steps]
        if actions0.shape != (args.steps, 3):
            raise ValueError(f"--init-actions holds {actions0.shape}, "
                             f"expected {(args.steps, 3)}")
    xy_ctl = Controller(args.steps, 2, args.steps, lr=0.8 * 0.1, warmup=5,
                        decay=0.99, actions_init=actions0[:, :2])
    z_ctl = Controller(args.steps, 1, args.steps, lr=0.8, warmup=5,
                       decay=0.99, actions_init=actions0[:, 2:])

    loss_log, epoch_seconds = [], []
    print("Optimizing Trajectory...")
    for epoch in range(args.epochs):
        timer = EpochTimer()
        timer.start("forward")
        acts = np.concatenate([xy_ctl.get_actions(), z_ctl.get_actions()],
                              axis=1)
        total_frames = args.steps * env.substeps
        out = env.rollout_and_grad(acts, loss_start_frame=total_frames,
                                   loss_stride=total_frames, remat=args.remat)
        loss = float(out["loss"])
        timer.stop()

        timer.start("optimize")
        g = np.clip(out["action_grad"].cpu().numpy(), -1.0, 1.0)
        xy_ctl.step(g[:, :2])
        z_ctl.step(g[:, 2:])
        timer.stop()

        terms = {k: float(v) for k, v in out["terms"].items()}
        timer.report(epoch, z_ctl.latest_lr,
                     "Loss: {:.4f} pose: {:.4f} penetrating: {}".format(
                         loss, terms.get("pose_loss", 0),
                         int(terms.get("n_penetration", 0))))
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
