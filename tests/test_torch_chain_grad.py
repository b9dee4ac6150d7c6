"""PyTorch port: the gradient through an articulated tree
(softmac_tpu_torch.engine.chain) against the JAX package's, in float64 on
the CPU: a loss of q and qd after 20 steps of tests/test_torch_chain.py's
floating tree (a floating base carrying a damped revolute arm and a
limited slider), with respect to the actions and the wrenches, through the
tree's mass matrix, its bias forces and its chart re-centring: autograd
against jax.grad, within 1e-8.

Most of this file's time is JAX tracing the gradient of a step that takes
its own Hessian (third-order AD), ~50 s however short the horizon; the
port's side takes ~30 s.
"""
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_chain import _close, _states, _t, _tree  # noqa: E402
from test_torch_chain import jchain, tchain  # noqa: E402

torch.set_num_threads(1)


def test_tree_gradient_matches_jax():
    """d loss / d (actions, wrenches) over 20 steps of the floating tree,
    through its Hessian and its chart re-centring: autograd against
    jax.grad."""
    name = "floating"
    jt, tt = _tree(jchain, name, dt=1e-3), _tree(tchain, name, dt=1e-3)
    q0, qd0, tau0, wr0 = _states(jt, 7)[1]
    steps = 20

    def jloss(tau, wr):
        def body(c, _):
            return jt.step(c[0], c[1], tau, wr), None
        (q, qd), _ = jax.lax.scan(body, (jnp.asarray(q0), jnp.asarray(qd0)),
                                  None, length=steps)
        return jnp.sum(q ** 2) + 0.1 * jnp.sum(qd ** 2)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(tau0),
                                                   jnp.asarray(wr0))
    tau, wr = _t(tau0).requires_grad_(), _t(wr0).requires_grad_()
    q, qd = _t(q0), _t(qd0)
    for _ in range(steps):
        q, qd = tt.step(q, qd, tau, wr)
    g = torch.autograd.grad((q ** 2).sum() + 0.1 * (qd ** 2).sum(),
                            (tau, wr))
    for got, ref in zip(g, jg):
        assert np.abs(np.asarray(ref)).max() > 0
        _close(got, ref, 1e-8)
