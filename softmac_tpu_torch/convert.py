"""Carry state from NumPy arrays into the port's containers.

Each function takes a mapping from field name to array (for example the
fields of a JAX ``MPMState`` passed through ``np.asarray``) and returns the
port's container on ``device`` in ``dtype``. Floating arrays take ``dtype``;
integer arrays keep their type. The tests hand both packages the same bytes
this way. ``mlp_policy_state_dict`` carries a flax policy's weights into the
port's ``MLPPolicy``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from softmac_tpu_torch.engine import sdf as sdf_mod
from softmac_tpu_torch.engine.cloth import ClothState
from softmac_tpu_torch.engine.cloth_contact import PenetrationState
from softmac_tpu_torch.engine.rigid import RigidState
from softmac_tpu_torch.engine.types import (
    BodyState, MPMParams, MPMState, SDFParams,
)


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.array(a)   # a writable, contiguous copy
    t = torch.as_tensor(a, device=device)
    return t.to(dtype) if a.dtype.kind == "f" else t


def _fields(cls, arrays: Mapping[str, np.ndarray], device, dtype):
    names = cls.__dataclass_fields__
    return cls(**{k: _tensor(arrays[k], device, dtype) for k in names})


def mpm_state(arrays, device="cpu", dtype=torch.float64) -> MPMState:
    """x (3, N), v (3, N), C (3, 3, N), F (3, 3, N)."""
    return _fields(MPMState, arrays, device, dtype)


def body_state(arrays, device="cpu", dtype=torch.float64) -> BodyState:
    """pos (B, 3), quat (B, 4) wxyz, v (B, 3), w (B, 3)."""
    return _fields(BodyState, arrays, device, dtype)


def rigid_state(arrays, device="cpu", dtype=torch.float64) -> RigidState:
    """q (D,), qd (D,): per floating body [exp(3), pos(3)] and
    [w(3), v(3)]."""
    return _fields(RigidState, arrays, device, dtype)


def mpm_params(arrays, device="cpu", dtype=torch.float64) -> MPMParams:
    """mu, lam, yield_stress, control_idx (N,), gravity (3,), friction,
    softness (B,)."""
    return _fields(MPMParams, arrays, device, dtype)


def cloth_state(arrays, device="cpu", dtype=torch.float64) -> ClothState:
    """x (V, 3), v (V, 3) cloth vertices."""
    return _fields(ClothState, arrays, device, dtype)


def penetration_state(arrays, device="cpu",
                      dtype=torch.float64) -> PenetrationState:
    """contact_id (N,) int32, penetration (N,) int8: integer, so they keep
    their type."""
    return _fields(PenetrationState, arrays, device, dtype)


def sdf_params(arrays, device="cpu", dtype=torch.float64) -> SDFParams:
    """neighborhood (M, 32), lower, upper (3,), inv_dx (), res (3 ints)."""
    return sdf_mod.sdf_params(
        np.asarray(arrays["neighborhood"]), np.asarray(arrays["lower"]),
        np.asarray(arrays["upper"]), float(np.asarray(arrays["inv_dx"])),
        tuple(int(r) for r in arrays["res"]), dtype, device)


def mlp_policy_state_dict(params, device="cpu",
                          dtype=torch.float64) -> dict:
    """The ``state_dict`` of ``engine.policy.MLPPolicy`` from flax
    ``MLPPolicy`` params as numpy arrays ({"params": {"Dense_k": {"kernel"
    (in, out), "bias" (out,)}}}, or the inner mapping): Dense_k is
    ``layers.k``, its kernel transposed into the weight (out, in)."""
    params = params.get("params", params)
    out = {}
    for k in range(len(params)):
        dense = params[f"Dense_{k}"]
        out[f"layers.{k}.weight"] = _tensor(np.asarray(dense["kernel"]).T,
                                            device, dtype)
        out[f"layers.{k}.bias"] = _tensor(dense["bias"], device, dtype)
    return out
