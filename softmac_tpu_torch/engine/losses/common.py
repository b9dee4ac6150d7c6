"""Shared loss building blocks (``softmac_tpu/engine/losses/common.py``)."""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from softmac_tpu_torch.engine.types import BodyState

# elements of the (rows, M) distance block the chamfer holds at once
_CHAMFER_BLOCK_ELEMS = 1 << 25


@dataclasses.dataclass
class FrameSample:
    """What a loss sees at one sampled frame of the rollout."""
    x: torch.Tensor                  # (N, 3) particle positions
    bodies: Optional[BodyState]      # rigid primitive states (or None)


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,3) x (M,3) -> (N,M) squared distances via a matmul."""
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    return a2[:, None] + b2[None, :] - 2.0 * (a @ b.T)


def _chamfer_min(a, b):
    """(row min, row argmin (N,), column min, column argmin (M,)) of the
    clamped squared distances, a block of rows at a time. Both argmins keep
    the first index on ties, as ``jnp.argmin`` does: within a block through
    ``torch.min``, across blocks by replacing a column's argmin only where
    a later block is strictly closer."""
    rows = max(1, _CHAMFER_BLOCK_ELEMS // max(b.shape[0], 1))
    row_min, row_arg = [], []
    col_min = col_arg = None
    for s in range(0, a.shape[0], rows):
        d2 = torch.clamp(pairwise_sqdist(a[s:s + rows], b), min=0.0)
        m, i = d2.min(dim=1)
        row_min.append(m)
        row_arg.append(i)
        m, i = d2.min(dim=0)
        if col_min is None:
            col_min, col_arg = m, i
        else:
            closer = m < col_min
            col_min = torch.where(closer, m, col_min)
            col_arg = torch.where(closer, i + s, col_arg)
    return torch.cat(row_min), torch.cat(row_arg), col_min, col_arg


class Chamfer(torch.autograd.Function):
    """The chamfer with the frozen-argmin backward of the JAX package's
    ``custom_vjp`` (``_chamfer_bwd``): gradients flow only through the
    argmin pairings. It saves the argmin indices, not the (N, M) distance
    blocks (2 GB per loss frame in float32 at 1e5 x 5000)."""

    @staticmethod
    def forward(ctx, a, b):
        row_min, ic, col_min, it = _chamfer_min(a, b)
        ctx.save_for_backward(a, b, ic, it)
        return torch.sum(row_min) + torch.sum(col_min)

    @staticmethod
    def backward(ctx, g):
        a, b, ic, it = ctx.saved_tensors
        # d/da sum_i |a_i - b_ic(i)|^2 plus the per-target terms, scattered
        da = 2.0 * (a - b[ic])
        da = da.index_add(0, it, 2.0 * (a[it] - b))
        db = 2.0 * (b - a[it])
        db = db.index_add(0, ic, 2.0 * (b[ic] - a))
        return g * da, g * db


def chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bidirectional sum-of-squared-closest-distance chamfer
    (reference loss_pour.py:48-68).

    The (N, M) distance matrix is built a block of rows at a time (2 GB in
    float32 at 1e5 particles x 5000 targets otherwise). Each row's min and
    the running column min are exact, and the two sums run over the full
    min vectors, so blocking changes nothing in the result. Under autograd
    it is ``Chamfer``, whose backward uses the frozen argmins."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return Chamfer.apply(a, b)
    row_min, _, col_min, _ = _chamfer_min(a, b)
    return torch.sum(row_min) + torch.sum(col_min)


def load_target(path: str, search_dirs) -> np.ndarray:
    for d in [".", *search_dirs]:
        cand = os.path.join(d, path)
        if os.path.exists(cand):
            return np.load(cand)
    raise FileNotFoundError(path)
