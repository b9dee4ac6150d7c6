"""Shared loss building blocks (``softmac_tpu/engine/losses/common.py``),
forward only."""
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


def chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bidirectional sum-of-squared-closest-distance chamfer
    (reference loss_pour.py:48-68).

    The (N, M) distance matrix is built a block of rows at a time (2 GB in
    float32 at 1e5 particles x 5000 targets otherwise). Each row's min and
    the running column min are exact, and the two sums run over the full
    min vectors, so blocking changes nothing in the result."""
    rows = max(1, _CHAMFER_BLOCK_ELEMS // max(b.shape[0], 1))
    row_min = []
    col_min = None
    for s in range(0, a.shape[0], rows):
        d2 = torch.clamp(pairwise_sqdist(a[s:s + rows], b), min=0.0)
        row_min.append(d2.min(dim=1).values)
        blk = d2.min(dim=0).values
        col_min = blk if col_min is None else torch.minimum(col_min, blk)
    return torch.sum(torch.cat(row_min)) + torch.sum(col_min)


def load_target(path: str, search_dirs) -> np.ndarray:
    for d in [".", *search_dirs]:
        cand = os.path.join(d, path)
        if os.path.exists(cand):
            return np.load(cand)
    raise FileNotFoundError(path)
