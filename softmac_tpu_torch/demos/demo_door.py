"""Door demo: MPM-controlled elastic boxes push a revolute door to a target
angle (pi/4, a pose loss on the door's quaternion), by a batched
backtracking line search through ``SoftMacEnv.batched_rollout`` and
``rollout_and_grad`` (``demos/demo_door.py`` of the JAX package, reference
``softmac/demo_door.py``).

    python -m softmac_tpu_torch.demos.demo_door [--device cpu] [--epochs N]
        [--steps T] [--remat step|none|window:K] [--replicas K]
        [--jitter SIGMA] [--init-actions ckpt/actions_K.npy]
        [--log-root DIR]

Every particle is on controller 0. Each epoch evaluates four candidate step
sizes along the current gradient (y-gradient zeroed, unit max component)
in one ``batched_rollout``, moves to the best candidate when it lowers the
loss and takes a fresh gradient there, and halves the step scale when none
does, so the logged loss never rises. ``--replicas K`` optimises the mean
loss over K jittered copies of the initial state (``jittered_carry``):
each candidate is rolled out on every replica. Each epoch writes
``<log-root>/<exp-name>/ckpt/actions_<epoch>.npy`` and ``losses.npy``.
Runs on the card unless ``--device cpu``. Every ``--render-interval``
epochs (and at the last) the best actions are replayed through the facade
and drawn to ``epoch<K>.gif``; ``loss_curve.png`` at the end.
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from softmac_tpu_torch import SoftMacEnv
from softmac_tpu_torch.engine.env import map_carry
from softmac_tpu_torch.utils import (
    EpochTimer, make_gif_from_numpy, plot_loss_curve, prepare, render,
    sanitize_grad,
)

CONFIG = Path(__file__).resolve().parents[1] / "config/demo_door_config.py"
LRS = np.array([3e-3, 1e-2, 3e-2, 1e-1])   # candidate step sizes


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--exp-name", "-n", type=str, default="door")
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
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--replicas", type=int, default=1,
                        help="optimize the mean loss over K jittered "
                             "replicas")
    parser.add_argument("--jitter", type=float, default=3e-4,
                        help="initial-position jitter sigma for --replicas")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the line search; returns {"losses", "epoch_seconds"} per
    epoch."""
    args = parse_args(argv)
    log_dir, cfg = prepare(args, args.log_root)
    env = SoftMacEnv(cfg, device=args.device)
    env.set_control_idx(np.zeros(env.n_particles, np.int32))

    total_frames = args.steps * env.substeps
    start = (2 * total_frames // 3) // 20 * 20   # 2000 at 3000 steps
    K = max(int(args.replicas), 1)
    carryK = env.jittered_carry(K, sigma=args.jitter) if K > 1 else None

    def grad_at(actions):
        """Loss, normalised descent direction and replica 0's rollout at
        ``actions``."""
        if K > 1:
            out = env.batched_rollout_and_grad(
                np.broadcast_to(actions, (K,) + actions.shape).copy(),
                carry0=carryK, loss_start_frame=start, loss_stride=20,
                grad_clip=1.0, remat=args.remat)
            loss = float(out["loss"].double().mean())
            g = out["action_grad"].double().mean(dim=0).cpu().numpy()
            out = {"terms": {k: v[0] for k, v in out["terms"].items()},
                   "carry": map_carry(lambda t: t[0], out["carry"])}
        else:
            out = env.rollout_and_grad(actions, loss_start_frame=start,
                                       loss_stride=20, grad_clip=1.0,
                                       remat=args.remat)
            loss = float(out["loss"])
            g = out["action_grad"].double().cpu().numpy()
        g = sanitize_grad(g)
        g[:, 1] = 0.0   # the reference zeroes the y-gradient
        g /= max(np.abs(g).max(), 1e-12)   # LRS are action-scale steps
        return loss, g, out

    best = np.zeros((args.steps, 3))
    best[:, 2] = 0.1
    if args.init_actions:
        best = np.asarray(np.load(args.init_actions), np.float64)[:args.steps]
    best_loss, g, out = grad_at(best)
    lr_scale = 1.0

    loss_log, epoch_seconds = [], []
    print("Optimizing Trajectory...")
    for epoch in range(args.epochs):
        timer = EpochTimer()
        timer.start("forward")
        cands = best[None] - (lr_scale * LRS)[:, None, None] * g[None]
        if K > 1:   # every candidate on every replica: B = C * K
            carry_t = map_carry(lambda t: torch.cat([t] * len(cands)), carryK)
            res = env.batched_rollout(np.repeat(cands, K, axis=0),
                                      carry0=carry_t, loss_start_frame=start,
                                      loss_stride=20)
            cand_losses = res["loss"].double().cpu().numpy() \
                .reshape(len(cands), K).mean(axis=1)
        else:
            res = env.batched_rollout(cands, loss_start_frame=start,
                                      loss_stride=20)
            cand_losses = res["loss"].double().cpu().numpy()
        timer.stop()

        timer.start("optimize")
        k = int(np.nanargmin(cand_losses))
        if np.isfinite(cand_losses[k]) and cand_losses[k] < best_loss:
            best = cands[k]
            best_loss = float(cand_losses[k])
            _, g, out = grad_at(best)    # a fresh gradient at the new center
            lr_scale = 1.0
        else:
            lr_scale *= 0.5              # every candidate worse: shrink
        timer.stop()

        terms = {kk: float(v) for kk, v in out["terms"].items()}
        timer.report(epoch, lr_scale,
                     "Loss: {:.4f} cands: {} pose: {:.4f}".format(
                         best_loss, np.array2string(cand_losses, precision=3),
                         terms.get("pose_loss", 0)))
        print("Door angle: {:.4f} rad".format(float(out["carry"][2].q[0])))
        loss_log.append(best_loss)
        epoch_seconds.append(sum(timer.times.values()))
        np.save(log_dir / "ckpt" / f"actions_{epoch}.npy", best)
        np.save(log_dir / "losses.npy", np.asarray(loss_log))

        if args.render_interval > 0 and (
                (epoch + 1) % args.render_interval == 0
                or epoch == args.epochs - 1):
            images = render(env, action=best, n_steps=args.steps,
                            interval=args.steps // 50)
            make_gif_from_numpy(images, log_dir, f"epoch{epoch}")

    plot_loss_curve(log_dir, loss_log)
    return {"losses": loss_log, "epoch_seconds": epoch_seconds}


if __name__ == "__main__":
    main()
