"""Taco demo: optimise the trajectories of the tortilla's attachment
vertices so that the cloth wraps the plasticine disk into a taco, by
gradient descent through ``SoftMacEnv.rollout_and_grad``
(``demos/demo_taco.py`` of the JAX package, reference
``soft_cloth/demo_taco.py``).

    python -m softmac_tpu_torch.demos.demo_taco [--device cpu] [--epochs N]
        [--steps T] [--line-search] [--replicas K] [--jitter SIGMA]
        [--safeguard] [--bptt-window W] [--cloth-damping D] [--lr LR]
        [--eval-scripted] [--remat step|none|window:K]
        [--init-actions ckpt/actions_K.npy] [--log-root DIR]

The env runs in the cloth control mode: an action is the 17 attachment
vertices' targets (51 numbers). The loss is the chamfer of the particles
against ``envs/taco/taco_mpm_target.npy`` at every tenth frame of the last
tenth of the horizon. Two optimisers:

- Adam (the default): ``DeltaController`` optimises the per-step deltas of
  the handles (only the first two handles' x and y move), clamped to
  +-0.01 a step and, summed, to the reachable arc; the gradient is
  truncated to ``--bptt-window`` env steps (20 by default) and its carry
  cotangent clipped to 10. ``--replicas K`` optimises the mean loss over K
  jittered copies of the initial state (``jittered_carry`` and
  ``batched_rollout_and_grad``); ``--safeguard`` rolls an epoch whose loss
  rose back and halves the learning rate.
- ``--line-search``: each epoch scores four sign steps in delta space
  along the full-horizon gradient in one ``batched_rollout`` and moves to
  the best when it lowers the loss, else halves the step.

``--eval-scripted`` scores the scripted fold that made the target, draws
it to ``scripted.gif`` and exits. Each epoch is a rollout from the initial
state and writes ``<log-root>/<exp-name>/ckpt/actions_<epoch>.npy`` and
``losses.npy``; every ``--render-interval`` epochs (and after the first;
the line search also at the last) its actions are replayed through the
facade and drawn to ``epoch<K>.gif`` with the target overlaid, and
``loss_curve.png`` at the end. Runs on the card unless ``--device cpu``.
Left out on purpose: the JAX demo's pin of ``TPU.tile_c`` under
``--line-search``, a workaround for the TPU compiler's memory budget.
"""
from __future__ import annotations

import copy
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from softmac_tpu_torch import SoftMacEnv
from softmac_tpu_torch.utils import (
    EpochTimer, make_gif_from_numpy, plot_loss_curve, prepare, render,
    sanitize_grad,
)

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "softmac_tpu_torch/config/demo_taco_config.py"
TARGET = ROOT / "envs/taco/taco_mpm_target.npy"
LRS = np.array([2.5e-3, 5e-3, 1e-2, 2e-2])   # delta-space step sizes (>=
                                             # 1e-2 saturates the clamp)
GRAD_CLIP = 10.0
LOSS_STRIDE = 10


def _mask_grad(g):
    """Only the first two handles' x and y are optimised (columns 0, 1, 3,
    4): z (2, 5) and every other handle (6 on) get no gradient."""
    g = np.array(g, np.float64)
    g[:, 6:] = 0.0
    g[:, 2] = 0.0
    g[:, 5] = 0.0
    return g


def _clamp_cumsum(delta, r):
    """The reference's clamps (demo_taco.py:62-73): each delta to +-0.01,
    the first to 0, and the summed handle displacement to the reachable
    arc of radius r. Returns (clamped delta, its cumulative sum)."""
    delta = np.clip(delta, -0.01, 0.01)
    delta[0] = 0.0
    cs = np.cumsum(delta, axis=0)
    cs[:, 1] = np.clip(cs[:, 1], -r, r)
    cs[:, 4] = np.clip(cs[:, 4], -r, r)
    cs[:, 0] = np.minimum(cs[:, 0],
                          np.sqrt(np.maximum(r ** 2 - cs[:, 1] ** 2, 0)) - r)
    cs[:, 3] = np.maximum(cs[:, 3],
                          r - np.sqrt(np.maximum(r ** 2 - cs[:, 4] ** 2, 0)))
    delta = delta.copy()
    delta[1:] = cs[1:] - cs[:-1]
    return delta, cs


class DeltaController:
    """Adam over the per-step handle deltas (reference demo_taco.py:16-77),
    ``torch.optim.Adam`` on a float64 CPU tensor with the learning rate set
    from the Adam step count before each step: the warmup/decay schedule
    read at update time (optax's callable learning rate in the JAX
    demo), so that a halved ``lr`` (``--safeguard``) reaches the
    optimiser. After each step the deltas are clamped (``_clamp_cumsum``)."""

    def __init__(self, actions_init, mpm_scale, lr=5e-4, warmup=5,
                 decay=0.95, betas=(0.9, 0.999)):
        self.actions_init = np.asarray(actions_init, np.float64)
        self.r_max = 0.3 * mpm_scale
        self.lr, self.warmup, self.decay = lr, warmup, decay
        self.epoch = 0
        self.latest_lr = lr
        self._param = torch.zeros(self.actions_init.shape,
                                  dtype=torch.float64, requires_grad=True)
        delta = np.zeros(self.actions_init.shape)
        delta[1:] = self.actions_init[1:] - self.actions_init[:-1]
        self.delta = delta
        self.optimizer = torch.optim.Adam([self._param], lr=lr,
                                          betas=tuple(betas), eps=1e-8,
                                          foreach=False)

    @property
    def delta(self) -> np.ndarray:
        return self._param.detach().numpy().copy()

    @delta.setter
    def delta(self, d):
        with torch.no_grad():
            self._param.copy_(torch.as_tensor(np.asarray(d, np.float64)))

    def _count(self) -> int:
        st = self.optimizer.state.get(self._param)
        return int(st["step"]) if st else 0

    def _lr_fn(self, count):
        if count < self.warmup:
            return self.lr * (count + 1) / max(self.warmup, 1)
        return self.lr * self.decay ** max(count - self.warmup, 0)

    def get_actions(self):
        return self.actions_init[0][None] + np.cumsum(self.delta, axis=0)

    def step(self, grad):
        self.latest_lr = (self.lr * (self.epoch + 1) / self.warmup
                          if self.epoch < self.warmup
                          else self.lr * self.decay ** (self.epoch
                                                        - self.warmup))
        g = _mask_grad(sanitize_grad(np.asarray(grad, np.float64)))
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr_fn(self._count())
        self._param.grad = torch.as_tensor(g)
        self.optimizer.step()
        self._param.grad = None
        self.delta = _clamp_cumsum(self.delta, self.r_max)[0]
        self.epoch += 1

    def snapshot(self):
        """Deltas, the optimiser's state_dict (moments and step count),
        the base lr and the epoch."""
        return (self.delta, copy.deepcopy(self.optimizer.state_dict()),
                self.lr, self.epoch)

    def restore(self, snap):
        self.delta = snap[0]
        self.optimizer.load_state_dict(copy.deepcopy(snap[1]))
        self.lr, self.epoch = snap[2], snap[3]


def get_init_actions(steps, env, choice=0):
    """(steps, action_dim) handle targets: at rest (choice 0) or the
    scripted fold that made the target (choice 1, demo_taco.py:84-96)."""
    a0 = env.cloth_model.attachment_rest_positions()
    actions = np.tile(a0, (steps, 1))
    if choice == 1:
        k = 4
        r = 0.3 / (np.pi / 2 + k - 1) * env.mpm_scale
        for i in range(steps):
            actions[i:, 1] += k * r / steps
            actions[i:, 4] += k * r / steps
            actions[i:, 0] -= (k - 2 + np.pi / 2) * r / steps
            actions[i:, 3] += (k - 2 + np.pi / 2) * r / steps
    return actions


def clamp_delta(delta, actions_init, mpm_scale):
    """The reference's delta clamps; returns (clamped delta, absolute
    trajectory)."""
    delta, cs = _clamp_cumsum(delta, 0.3 * mpm_scale)
    return delta, actions_init[0][None] + cs


def loss_start(env, steps):
    """The first loss frame: the last tenth of the horizon, on a multiple
    of ten frames (1800 of the demo's 2000)."""
    return (9 * steps * env.substeps // 10) // 10 * 10


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--exp-name", "-n", type=str, default="taco")
    parser.add_argument("--config", type=str, default=str(CONFIG))
    parser.add_argument("--log-root", type=str, default="logs",
                        help="directory the experiment's log dir goes in")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--render-interval", type=int, default=5,
                        help="render a GIF every K epochs (0 disables)")
    parser.add_argument("--remat", type=str, default="step",
                        help="rollout remat policy: step | none | window:K")
    parser.add_argument("--init-actions", type=str, default=None,
                        help="resume from a saved ckpt/actions_*.npy")
    parser.add_argument("--epochs", type=int, default=25)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--replicas", type=int, default=1,
                        help="optimize the mean loss over K jittered "
                             "replicas")
    parser.add_argument("--jitter", type=float, default=2e-4,
                        help="initial-position jitter sigma for --replicas")
    parser.add_argument("--lr", type=float, default=0.3,
                        help="Adam's base learning rate (its steps saturate "
                             "the +-0.01 delta clamp)")
    parser.add_argument("--cloth-damping", type=float, default=None,
                        help="override CLOTH.velocity_damping")
    parser.add_argument("--bptt-window", type=int, default=None,
                        help="truncated-BPTT window in env steps, 0 the "
                             "full horizon; default 20 with Adam, 0 with "
                             "--line-search")
    parser.add_argument("--line-search", action="store_true",
                        help="batched candidate-step line search instead "
                             "of Adam")
    parser.add_argument("--safeguard", action="store_true",
                        help="roll an epoch whose loss rose back and halve "
                             "the lr")
    parser.add_argument("--eval-scripted", action="store_true",
                        help="score the scripted fold that made the target, "
                             "then exit")
    args = parser.parse_args(argv)
    if args.bptt_window is None:
        args.bptt_window = 0 if args.line_search else 20
    return args


def _load_init(args):
    return np.asarray(np.load(args.init_actions), np.float64)[:args.steps]


def line_search_main(args, log_dir, env):
    """Per epoch, four sign steps in delta space along the full-horizon
    gradient (the reverse cumsum of the action gradient), clamped, in one
    ``batched_rollout``; move to the best when it lowers the loss (and take
    a fresh gradient there), else halve the step scale. The logged loss
    never rises. Returns {"losses", "epoch_seconds", "moved"}: "moved" per
    epoch, whether a candidate won."""
    start = loss_start(env, args.steps)
    bptt = args.bptt_window if args.bptt_window > 0 else None

    def grad_at(actions):
        out = env.rollout_and_grad(actions, loss_start_frame=start,
                                   loss_stride=LOSS_STRIDE, bptt_window=bptt,
                                   grad_clip=GRAD_CLIP, remat=args.remat)
        g = _mask_grad(sanitize_grad(out["action_grad"].double().cpu()
                                     .numpy()))
        g /= max(np.abs(g).max(), 1e-12)
        return float(out["loss"]), g

    actions_init = get_init_actions(args.steps, env, choice=0)
    best = actions_init.copy()
    delta_best = np.zeros_like(best)
    if args.init_actions:
        best = _load_init(args)
        delta_best[1:] = best[1:] - best[:-1]
    best_loss, g = grad_at(best)
    lr_scale = 1.0

    loss_log, epoch_seconds, moved = [], [], []
    print("Optimizing Trajectory (line search)...")
    for epoch in range(args.epochs):
        timer = EpochTimer()
        timer.start("forward")
        g_delta = np.cumsum(g[::-1], axis=0)[::-1]
        g_delta /= max(np.abs(g_delta).max(), 1e-12)
        big = np.abs(g_delta) > 0.01 * np.abs(g_delta).max()
        pairs = [clamp_delta(delta_best - lr_scale * s * np.sign(g_delta)
                             * big, actions_init, env.mpm_scale)
                 for s in LRS]
        cands = np.stack([p[1] for p in pairs])
        res = env.batched_rollout(cands, loss_start_frame=start,
                                  loss_stride=LOSS_STRIDE)
        cand_losses = res["loss"].double().cpu().numpy()
        timer.stop()

        timer.start("optimize")
        if np.isfinite(cand_losses).any():
            k = int(np.nanargmin(cand_losses))
        else:
            k = 0
            cand_losses = np.full_like(cand_losses, np.inf)
        if np.isfinite(cand_losses[k]) and cand_losses[k] < best_loss:
            delta_best, best = pairs[k]
            best_loss = float(cand_losses[k])
            _, g = grad_at(best)      # a fresh gradient at the new center
            lr_scale = 1.0
        else:
            lr_scale *= 0.5           # every candidate worse: shrink
        moved.append(lr_scale == 1.0)
        timer.stop()

        timer.report(epoch, lr_scale, "Loss: {:.4f} cands: {}".format(
            best_loss, np.array2string(cand_losses, precision=1)))
        loss_log.append(best_loss)
        epoch_seconds.append(sum(timer.times.values()))
        np.save(log_dir / "ckpt" / f"actions_{epoch}.npy", best)
        np.save(log_dir / "losses.npy", np.asarray(loss_log))

        if args.render_interval > 0 and (
                (epoch + 1) % args.render_interval == 0 or epoch == 0
                or epoch == args.epochs - 1):
            images = render(env, action=best, n_steps=args.steps,
                            interval=max(args.steps // 50, 1))
            make_gif_from_numpy(images, log_dir, f"epoch{epoch}")

    plot_loss_curve(log_dir, loss_log)
    return {"losses": loss_log, "epoch_seconds": epoch_seconds,
            "moved": moved}


def adam_main(args, log_dir, env):
    """Per epoch one ``rollout_and_grad`` (or, with ``--replicas K``, one
    ``batched_rollout_and_grad`` over K jittered replicas: the mean loss
    and gradient) and one ``DeltaController`` step."""
    actions0 = get_init_actions(args.steps, env, choice=0)
    if args.init_actions:
        actions0 = _load_init(args)
    controller = DeltaController(actions0, env.mpm_scale, lr=args.lr,
                                 warmup=5, decay=0.95)
    start = loss_start(env, args.steps)
    bptt = args.bptt_window if args.bptt_window > 0 else None
    K = max(int(args.replicas), 1)
    carryK = env.jittered_carry(K, sigma=args.jitter) if K > 1 else None
    kw = dict(loss_start_frame=start, loss_stride=LOSS_STRIDE,
              bptt_window=bptt, grad_clip=GRAD_CLIP, remat=args.remat)

    best_loss, snap, g_prev = np.inf, None, None
    loss_log, epoch_seconds = [], []
    print("Optimizing Trajectory...")
    for epoch in range(args.epochs):
        timer = EpochTimer()
        timer.start("forward")
        acts = controller.get_actions()
        if K > 1:
            out = env.batched_rollout_and_grad(
                np.broadcast_to(acts, (K,) + acts.shape).copy(),
                carry0=carryK, **kw)
            loss = float(out["loss"].double().mean())
            g = out["action_grad"].double().mean(dim=0).cpu().numpy()
            terms = {k: v[0] for k, v in out["terms"].items()}
        else:
            out = env.rollout_and_grad(acts, **kw)
            loss = float(out["loss"])
            g = out["action_grad"].double().cpu().numpy()
            terms = out["terms"]
        timer.stop()

        timer.start("optimize")
        if args.safeguard:
            if loss > best_loss and snap is not None:
                controller.restore(snap)
                controller.lr *= 0.5
                g = g_prev
                print(f"  [safeguard] overshoot ({loss:.1f} > "
                      f"{best_loss:.1f}): rolled back, lr halved")
            else:
                best_loss = loss
            snap = controller.snapshot()
            g_prev = g
        controller.step(g)
        timer.stop()

        timer.report(epoch, controller.latest_lr,
                     "Loss: {:.4f} chamfer: {:.4f} penetrating: {}".format(
                         loss, float(terms.get("chamfer_loss", 0)),
                         int(terms.get("n_penetration", 0))))
        loss_log.append(loss)
        epoch_seconds.append(sum(timer.times.values()))
        np.save(log_dir / "ckpt" / f"actions_{epoch}.npy", acts)
        np.save(log_dir / "losses.npy", np.asarray(loss_log))

        if args.render_interval > 0 and (
                (epoch + 1) % args.render_interval == 0 or epoch == 0):
            images = render(env, action=acts, n_steps=args.steps,
                            interval=max(args.steps // 50, 1))
            make_gif_from_numpy(images, log_dir, f"epoch{epoch}")

    plot_loss_curve(log_dir, loss_log)
    return {"losses": loss_log, "epoch_seconds": epoch_seconds}


def main(argv=None):
    """Run the optimisation; returns {"losses", "epoch_seconds"} per
    epoch ({"scripted_loss"} with ``--eval-scripted``)."""
    args = parse_args(argv)
    log_dir, cfg = prepare(args, args.log_root)
    if args.cloth_damping is not None:
        cfg.defrost()
        cfg.CLOTH.velocity_damping = args.cloth_damping
        cfg.freeze()
    env = SoftMacEnv(cfg, device=args.device)
    try:
        env.set_render_target(np.load(TARGET))
    except FileNotFoundError:
        pass
    env.set_control_mode("cloth")

    if args.eval_scripted:
        acts = get_init_actions(args.steps, env, choice=1)
        out = env.rollout(acts, loss_start_frame=loss_start(env, args.steps),
                          loss_stride=LOSS_STRIDE)
        loss = float(out["loss"])
        print(f"scripted-fold loss: {loss:.4f}")
        np.save(log_dir / "scripted_loss.npy", np.asarray([loss]))
        images = render(env, action=acts, n_steps=args.steps,
                        interval=max(args.steps // 50, 1))
        make_gif_from_numpy(images, log_dir, "scripted")
        return {"scripted_loss": loss}
    if args.line_search:
        return line_search_main(args, log_dir, env)
    return adam_main(args, log_dir, env)


if __name__ == "__main__":
    main()
