"""Demo utilities (``softmac_tpu/utils.py``): rendering a rollout, the GIF
writers and the loss curve, log-dir preparation, the trajectory controller
and the per-epoch timer.

``Controller`` optimises an action trajectory with ``torch.optim.Adam`` on
a float64 CPU tensor, the learning rate set before each step from the
reference's warmup/decay schedule (``_lr_fn``). torch's Adam and optax's
``adam`` make the same update (eps outside the root, bias correction,
``b1 = 0`` allowed), so the two agree to float64 rounding.

The GIFs and the loss curve's PNG are written by
``softmac_tpu_torch.images`` (NumPy and the standard library; the hosts have
neither imageio nor matplotlib): the GIF palette is a fixed colour cube,
and the loss curve is drawn in its box without axis text.
"""
from __future__ import annotations

import copy
import json
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from softmac_tpu_torch import images as image_files


# ===============================
# Rendering
# ===============================
def make_gif_from_numpy(images, logdir, name=None):
    """Write frames ((H, W, 3) uint8) as ``<logdir>/<name>.gif``
    (``movie.gif`` without a name), looping forever."""
    gif_name = "movie.gif" if name is None else name + ".gif"
    image_files.write_gif(Path(logdir) / gif_name, images)


def make_gif_from_files(picture_dir, logdir, name=None):
    """A GIF of every ``*.png`` / ``*.jpg`` under ``picture_dir`` in sorted
    filename order (reference ``softmac/utils.py:11-20``). The PNGs are
    read by ``images.read_png`` (those the port writes); a JPEG raises,
    since the port carries no JPEG decoder."""
    files = sorted(p for p in Path(picture_dir).iterdir()
                   if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    jpegs = [p.name for p in files if p.suffix.lower() != ".png"]
    if jpegs:
        raise ValueError(f"{jpegs}: the port reads PNG frames only (it "
                         "carries no JPEG decoder)")
    make_gif_from_numpy([image_files.read_png(f) for f in files], logdir,
                        name)


def render(env, action=None, n_steps=100, interval=10):
    """Frames of a rollout (``utils.py:29-47`` of the JAX package): with
    ``action``, reset and step the facade through ``n_steps`` of them,
    rendering after every ``interval``-th step; without, render the recorded
    history every ``interval`` env steps."""
    print("Rendering...")
    interval = max(int(interval), 1)   # demos pass steps//50; guard short runs
    image_list = []
    if action is not None:
        env.reset()
        for i in range(n_steps):
            env.step(action[i])
            if i % interval == 0:
                image_list.append(env.render(env.cur))
    else:
        for i in range(0, n_steps, interval):
            image_list.append(env.render(i * env.substeps))
    return image_list


def plot_loss_curve(log_dir, loss_log):
    """``losses.npy`` and ``loss_curve.png``: the curve in its box, without
    the axis labels and tick text of the JAX package's matplotlib plot."""
    image_files.write_png(Path(log_dir) / "loss_curve.png",
                          image_files.draw_curve(loss_log))
    np.save(Path(log_dir) / "losses.npy", np.array(loss_log))


def prepare(args, root="logs"):
    """Make ``<root>/<args.exp_name>/ckpt``, copy the config there, write
    the arguments to args.json, and load the config. Returns (log dir,
    config)."""
    from softmac_tpu_torch.config import load
    log_dir = Path(root) / args.exp_name
    (log_dir / "ckpt").mkdir(parents=True, exist_ok=True)
    cfg = load(args.config)
    try:
        shutil.copy(args.config, log_dir / "config.py")
    except (OSError, shutil.SameFileError):
        pass
    with open(log_dir / "args.json", "wt") as f:
        json.dump({k: str(v) for k, v in vars(args).items()}, f, indent=4)
    return log_dir, cfg


def sanitize_grad(g: np.ndarray) -> np.ndarray:
    """Zero non-finite gradient entries (and say how many): one epoch whose
    backward overflowed must not poison the Adam moments and every later
    action."""
    bad = ~np.isfinite(g)
    if bad.any():
        print(f"[controller] WARNING: {bad.sum()}/{g.size} non-finite "
              "gradient entries zeroed (backward overflow on a long "
              "horizon?)")
        g = np.where(bad, 0.0, g)
    return g


class Controller:
    """Action-trajectory optimiser: Adam over (num_actions, dim) with the
    reference's warmup/decay schedule and repeat-expansion to env steps."""

    def __init__(self, num_actions, action_dim, steps, lr=1e-2, warmup=5,
                 decay=1.0, betas=(0.9, 0.999), action_scale=None,
                 actions_init=None):
        self.num_actions = num_actions
        self.action_dim = action_dim
        self.steps = steps
        self.lr = lr
        self.warmup = warmup
        self.decay = decay
        self.epoch = 0
        self.latest_lr = lr

        self._param = torch.zeros((num_actions, action_dim),
                                  dtype=torch.float64, requires_grad=True)
        if actions_init is not None:
            a = np.asarray(actions_init, np.float64)
            if a.shape[0] > num_actions:
                a = a.reshape(num_actions, -1, a.shape[-1]).mean(axis=1)
            self.action = a
        self.action_scale = (np.ones(action_dim) if action_scale is None
                             else np.asarray(action_scale, np.float64))
        self.optimizer = torch.optim.Adam([self._param], lr=lr,
                                          betas=tuple(betas), eps=1e-8,
                                          foreach=False)

    @property
    def action(self) -> np.ndarray:
        return self._param.detach().numpy().copy()

    @action.setter
    def action(self, a):
        with torch.no_grad():
            self._param.copy_(torch.as_tensor(np.asarray(a, np.float64)))

    def _count(self) -> int:
        """Adam steps taken (the schedule's count, optax's ``count``)."""
        st = self.optimizer.state.get(self._param)
        return int(st["step"]) if st else 0

    def _lr_fn(self, count):
        if count < self.warmup:
            return self.lr * (count + 1) / max(self.warmup, 1)
        return self.lr * self.decay ** (count - self.warmup)

    def schedule_lr(self):
        self.latest_lr = self._lr_fn(self.epoch)

    def get_actions(self):
        acts = self.action * self.action_scale
        reps = self.steps // self.num_actions
        return np.repeat(acts, reps, axis=0)

    def step(self, grad):
        """grad: (steps, dim) gradient with respect to the expanded
        actions."""
        self.schedule_lr()
        g = sanitize_grad(np.asarray(grad, np.float64)) * self.action_scale
        g = g.reshape(self.num_actions, -1, self.action_dim).mean(axis=1)
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr_fn(self._count())
        self._param.grad = torch.as_tensor(g)
        self.optimizer.step()
        self._param.grad = None
        self.epoch += 1

    def snapshot(self):
        """Actions, the optimiser's state_dict (Adam moments and step
        count), the schedule epoch and the base lr (demo_pour
        --safeguard)."""
        return (self.action, copy.deepcopy(self.optimizer.state_dict()),
                self.epoch, self.lr)

    def restore(self, snap):
        self.action = snap[0]
        self.optimizer.load_state_dict(copy.deepcopy(snap[1]))
        self.epoch = snap[2]
        self.lr = snap[3]


class EpochTimer:
    """Per-epoch phase timing printout: the total and each timed phase
    (the trainer times "forward", the rollout with its gradient, and
    "optimize")."""

    def __init__(self):
        self.times = {}
        self._t0 = None
        self._phase = None

    def start(self, phase):
        self._t0 = time.time()
        self._phase = phase

    def stop(self):
        self.times[self._phase] = time.time() - self._t0

    def report(self, epoch, lr, loss_line=""):
        t = self.times
        total = sum(t.values())
        print(f"+============== Epoch {epoch} ==============+ lr: {lr:.4f}")
        print(f"Time: total {total:.2f}, " + ", ".join(
            f"{phase} {s:.2f}" for phase, s in t.items()))
        if loss_line:
            print(loss_line)
