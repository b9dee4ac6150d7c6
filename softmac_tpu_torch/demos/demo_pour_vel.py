"""Pour demo with velocity-controlled bodies: optimise the 12-dim velocity
command trajectory of the glass and the bowl so that the glass pours the
liquid into the bowl, by gradient descent through
``SoftMacEnv.rollout_and_grad`` (``demos/demo_pour_vel.py`` of the JAX
package, reference ``softmac/demo_pour_vel.py``).

    python -m softmac_tpu_torch.demos.demo_pour_vel [--device cpu]
        [--epochs N] [--steps T] [--remat step|none|window:K]
        [--init-actions ckpt/actions_K.npy] [--log-root DIR]

One Adam controller (at most 100 actions over the horizon, each held for
the same number of env steps) steps on the action gradient every epoch;
only the glass's wz, vx and vy move (the action scale, reference
demo_pour_vel.py:23-25). The loss frames are every 20th substep from 0,
and the gradient through time is cut every 300 env steps. Each epoch is
one ``rollout_and_grad`` from the initial state and writes
``<log-root>/<exp-name>/ckpt/actions_<epoch>.npy`` (the controller's
actions) and ``losses.npy``. Runs on the card unless ``--device cpu``.
Every ``--render-interval`` epochs (and after the first) the controller's
actions are replayed through the facade and drawn to ``epoch<K>.gif``;
``loss_curve.png`` at the end.
"""
from __future__ import annotations

import math
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from softmac_tpu_torch import SoftMacEnv
from softmac_tpu_torch.utils import (
    Controller, EpochTimer, make_gif_from_numpy, plot_loss_curve, prepare,
    render,
)

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "softmac_tpu_torch/config/demo_pour_vel_config.py"
TARGET = ROOT / "envs/pour/pour_mpm_target_position_corotated.npy"
# per primitive [w(3), v(3)]: the glass's wz, vx and vy
ACTION_SCALE = np.array([0., 0., 10., 0.5, 0.5, 0., 0., 0., 0., 0., 0., 0.])


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--exp-name", "-n", type=str, default="pour_vel")
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
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--steps", type=int, default=2000)
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

    # 100 actions at the reference's 2000 steps; fewer where the horizon
    # is not a multiple of 100, so that each holds for whole env steps
    controller = Controller(
        num_actions=math.gcd(100, args.steps), action_dim=12,
        steps=args.steps, lr=3e-2, warmup=5, decay=1.0,
        action_scale=ACTION_SCALE)
    if args.init_actions:
        controller.action = np.load(args.init_actions)

    loss_log, epoch_seconds = [], []
    print("Optimizing Trajectory...")
    for epoch in range(args.epochs):
        timer = EpochTimer()
        timer.start("forward")
        acts = controller.get_actions()
        # bptt_window: float32 gradients through more than ~500 chaotic
        # liquid steps are sign noise; a 300-step truncation keeps the
        # float64 gradient's structure (the JAX demo's finding)
        out = env.rollout_and_grad(acts, loss_start_frame=0, loss_stride=20,
                                   bptt_window=300, remat=args.remat)
        loss = float(out["loss"])
        timer.stop()

        timer.start("optimize")
        controller.step(out["action_grad"].cpu().numpy())
        timer.stop()

        terms = {k: float(v) for k, v in out["terms"].items()}
        timer.report(epoch, controller.latest_lr,
                     "Loss: {:.4f} chamfer: {:.4f} pose: {:.4f} vel: {:.4f}"
                     .format(loss, terms.get("chamfer_loss", 0),
                             terms.get("pose_loss", 0),
                             terms.get("vel_loss", 0)))
        print("Final chamfer: {:.4f} pose: {:.4f} vel: {:.4f}".format(
            terms.get("final_chamfer_loss", 0),
            terms.get("final_pose_loss", 0), terms.get("final_vel_loss", 0)))
        loss_log.append(loss)
        epoch_seconds.append(sum(timer.times.values()))
        np.save(log_dir / "ckpt" / f"actions_{epoch}.npy", controller.action)
        np.save(log_dir / "losses.npy", np.asarray(loss_log))

        if args.render_interval > 0 and (
                (epoch + 1) % args.render_interval == 0 or epoch == 0):
            images = render(env, action=controller.get_actions(),
                            n_steps=args.steps, interval=args.steps // 50)
            make_gif_from_numpy(images, log_dir, f"epoch{epoch}")

    plot_loss_curve(log_dir, loss_log)
    return {"losses": loss_log, "epoch_seconds": epoch_seconds}


if __name__ == "__main__":
    main()
