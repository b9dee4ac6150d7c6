"""PyTorch port: the articulated trees (softmac_tpu_torch.engine.chain and
the tree members of engine.rigid.RigidModel) against the JAX package, in
float64 on the CPU.

- ArticulatedTree: the serial double pendulum, a prismatic slider on a
  revolute arm, a branching Y-tree and a floating base carrying a
  revolute arm and a limited slider (tests/test_chain.py's trees), at
  seeded states, q = 0 among them (w2quat's zero angle under the
  Hessian): the mass matrix (the Hessian of the kinetic energy over qd),
  the energies, the generalized wrench forces, one step with seeded
  actions and wrenches, and body_states within 1e-10.

The gradient through a tree: tests/test_torch_chain_grad.py.
RigidModel's trees and the chain env: tests/test_torch_chain_env.py.
Each JAX reference is one jitted call (tracing the Hessian-based step
takes seconds; op by op it takes tens).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softmac_tpu.engine import chain as jchain

from softmac_tpu_torch.engine import chain as tchain

torch.set_num_threads(1)

G = 9.8
Z = np.array([0.0, 0.0, 1.0])


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _joint(mod, jtype, pos, mass, com, inertia=None, axis=Z, **kw):
    return mod.ChainJoint(
        jtype=jtype, origin_pos=np.asarray(pos, np.float64),
        origin_rot=np.eye(3), axis=np.asarray(axis, np.float64), mass=mass,
        inertia=np.zeros((3, 3)) if inertia is None else inertia,
        com=np.asarray(com, np.float64), **kw)


def _tree(mod, name, dt=1e-4):
    """tests/test_chain.py's trees, from either package."""
    if name == "serial":
        js = [_joint(mod, "revolute", [0, 0, 0], 0.7, [0, -0.5, 0]),
              _joint(mod, "revolute", [0, -0.5, 0], 1.3, [0, -0.8, 0])]
        parents = None
    elif name == "prismatic":
        js = [_joint(mod, "revolute", [0, 0, 0], 0.5, [0, -0.3, 0],
                     np.eye(3) * 1e-2),
              _joint(mod, "prismatic", [0, -0.6, 0], 0.2, [0, 0, 0],
                     axis=[0.0, -1.0, 0.0])]
        parents = None
    elif name == "branching":
        js = [_joint(mod, "revolute", [0, 0, 0], 0.7, [0, -0.5, 0]),
              _joint(mod, "revolute", [0, -0.5, 0], 1.3, [0, -0.8, 0],
                     damping=0.02),
              _joint(mod, "revolute", [0, -0.5, 0], 0.4, [0, -0.35, 0])]
        parents = [-1, 0, 0]
    else:   # a floating base carrying an arm and a limited slider
        js = [_joint(mod, "floating", [0, 0, 0], 0.5, [0.02, 0.0, 0.01],
                     np.diag([1e-3, 2e-3, 3e-3])),
              _joint(mod, "revolute", [0.1, 0, 0], 0.2, [0, -0.3, 0],
                     np.diag([1e-4] * 3), damping=0.01),
              _joint(mod, "prismatic", [0, -0.2, 0], 0.1, [0, 0, 0],
                     np.diag([1e-5] * 3), axis=[0.0, -1.0, 0.0],
                     limit_lower=-0.1, limit_upper=0.1,
                     limit_velocity=2.0)]
        parents = [-1, 0, 1]
    kw = ({"dtype": jnp.float64} if mod is jchain
          else {"dtype": torch.float64})
    return mod.ArticulatedTree(js, np.zeros(3), np.eye(3), (0.0, -G, 0.0),
                               dt, parents=parents, **kw)


TREES = ("serial", "prismatic", "branching", "floating")


def _states(tree, seed):
    """Seeded (q, qd, tau, wrenches); the first with q = 0."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(3):
        q = np.zeros(tree.n_dof) if k == 0 else rng.uniform(-1.5, 1.5,
                                                            tree.n_dof)
        if tree.joints[-1].jtype == "prismatic" and k:
            q[-1] = rng.uniform(-0.09, 0.09)   # inside the slider's limits
        out.append((q, rng.uniform(-2.0, 2.0, tree.n_dof),
                    rng.randn(tree.n_dof) * 0.1, rng.randn(tree.n, 6) * 0.1))
    return out


@pytest.mark.parametrize("name", TREES)
def test_tree_matches_jax(name):
    jt, tt = _tree(jchain, name), _tree(tchain, name)
    assert tt.n_dof == jt.n_dof and tt.parents == jt.parents
    states = _states(jt, TREES.index(name))

    def quantities(q, qd, tau, wr):
        return (jax.hessian(jt.kinetic, argnums=1)(q, qd), jt.kinetic(q, qd),
                jt.potential(q), jt.generalized_ext(q, qd, wr),
                *jt.step(q, qd, tau, wr), *jt.body_states(q, qd))

    # one compilation for every state
    refs = jax.jit(jax.vmap(quantities))(
        *(jnp.asarray(np.stack([s[i] for s in states])) for i in range(4)))
    for k, (q, qd, tau, wr) in enumerate(states):
        M = torch.autograd.functional.hessian(
            lambda v: tt.kinetic(_t(q), v), _t(qd))
        step = tt.step(_t(q), _t(qd), _t(tau), _t(wr))
        assert not any(g.requires_grad for g in step)
        got = (M, tt.kinetic(_t(q), _t(qd)), tt.potential(_t(q)),
               tt.generalized_ext(_t(q), _t(qd), _t(wr)), *step,
               *tt.body_states(_t(q), _t(qd)))
        for g, r in zip(got, refs):
            _close(g, r[k], 1e-10)
