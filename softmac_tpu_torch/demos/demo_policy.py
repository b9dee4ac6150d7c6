"""Closed-loop neural-policy demo: train an MLP (obs -> action) through the
differentiable rollout with analytic simulation gradients
(``demos/demo_policy.py`` of the JAX package).

    python -m softmac_tpu_torch.demos.demo_policy [--device cpu]
        [--epochs N] [--steps T] [--hidden 64,64] [--lr 3e-3]
        [--action-scale 1.0] [--seed 0]

On the pour_vel scene, at every env step the policy maps the observation
(``ENV.n_observed_particles`` subsampled particles' x and v, then the
bodies' state) to the 12-dim velocity command. Each epoch
(``train_epoch``) is one closed-loop rollout of ``--steps`` env steps and
its gradient, then one ``torch.optim.Adam`` step on the policy's
parameters; it writes ``logs/<exp-name>/ckpt/policy_<epoch>.pt`` (the
policy's ``state_dict``) and ``losses.npy``. Every ``--render-interval``
epochs (and at the last) the policy is deployed closed loop through the
facade (``reset``, ``get_observation``, ``step``), its actions saved to
``ckpt/actions_<epoch>.npy`` and the recorded history drawn to
``epoch<K>.gif``; ``loss_curve.png`` at the end. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from softmac_tpu_torch import SoftMacEnv
from softmac_tpu_torch.engine.policy import (
    MLPPolicy, make_closed_loop_rollout, observation,
)
from softmac_tpu_torch.utils import (
    EpochTimer, make_gif_from_numpy, plot_loss_curve, prepare, render,
)

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "softmac_tpu_torch/config/demo_pour_vel_config.py"
TARGET = ROOT / "envs/pour/pour_mpm_target_position_corotated.npy"


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--exp-name", "-n", type=str, default="policy")
    parser.add_argument("--config", type=str, default=str(CONFIG))
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--render-interval", type=int, default=10,
                        help="deploy and render every K epochs (0 "
                             "disables)")
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--hidden", type=str, default="64,64")
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--action-scale", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    return parser.parse_args(argv)


def make_policy(env, hidden, action_scale, n_observed, seed=0):
    """The MLP for ``env``'s observation and action sizes, in its dtype
    on its device, drawn from ``torch.Generator().manual_seed(seed)``."""
    obs_dim = observation(env, env._initial_carry(), n_observed).numel()
    return MLPPolicy(obs_dim, hidden, env.action_dim,
                     action_scale=action_scale, dtype=env.dtype,
                     device=env.device,
                     generator=torch.Generator().manual_seed(seed))


def train_epoch(loss_fn, optimizer):
    """One closed-loop rollout, its gradient and one optimiser step.
    Returns (loss, aux) as ``loss_fn`` gives them."""
    optimizer.zero_grad(set_to_none=True)
    loss, aux = loss_fn()
    loss.backward()
    optimizer.step()
    return loss.detach(), aux


@torch.no_grad()
def deploy(env, policy, n_steps):
    """Run ``policy`` closed loop through the facade for ``n_steps`` env
    steps from ``reset``; returns its actions (n_steps, action_dim)."""
    env.reset()
    acts = []
    for _ in range(n_steps):
        obs = torch.as_tensor(env.get_observation(), device=env.device)
        a = policy(obs)
        acts.append(a.cpu().numpy())
        env.step(a)
    return np.stack(acts)


def main(argv=None):
    """Train; returns {"losses", "epoch_seconds"} per epoch."""
    args = parse_args(argv)
    log_dir, cfg = prepare(args)
    env = SoftMacEnv(cfg, device=args.device)
    try:
        env.set_render_target(np.load(TARGET))
    except FileNotFoundError:
        pass

    hidden = tuple(int(h) for h in args.hidden.split(",") if h)
    # the observation layout is env.get_observation's, which reads
    # ENV.n_observed_particles from the config
    n_observed = int(cfg.ENV.n_observed_particles)
    policy = make_policy(env, hidden, args.action_scale, n_observed,
                         args.seed)
    loss_fn, _ = make_closed_loop_rollout(env, policy, n_steps=args.steps,
                                          n_observed=n_observed)
    optimizer = torch.optim.Adam(policy.parameters(), lr=args.lr)

    loss_log, epoch_seconds = [], []
    print("Training policy...")
    for epoch in range(args.epochs):
        timer = EpochTimer()
        timer.start("forward")
        loss, _ = train_epoch(loss_fn, optimizer)
        loss = float(loss)
        timer.stop()
        timer.report(epoch, args.lr, "Loss: {:.4f}".format(loss))
        loss_log.append(loss)
        epoch_seconds.append(sum(timer.times.values()))
        torch.save(policy.state_dict(),
                   log_dir / "ckpt" / f"policy_{epoch}.pt")
        np.save(log_dir / "losses.npy", np.asarray(loss_log))

        if args.render_interval > 0 and (
                (epoch + 1) % args.render_interval == 0
                or epoch == args.epochs - 1):
            acts = deploy(env, policy, args.steps)
            np.save(log_dir / "ckpt" / f"actions_{epoch}.npy", acts)
            # the frames are the deployment's recorded history (action
            # None replays nothing)
            images = render(env, action=None, n_steps=args.steps,
                            interval=max(args.steps // 50, 1))
            make_gif_from_numpy(images, log_dir, f"epoch{epoch}")

    plot_loss_curve(log_dir, loss_log)
    return {"losses": loss_log, "epoch_seconds": epoch_seconds}


if __name__ == "__main__":
    main()
