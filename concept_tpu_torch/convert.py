"""Carry particle states between the JAX package and the port as numpy
arrays, field for field (ParticleState: pos, mom, ids, rungs; RungState:
pos, mom, valid, rungs, ids), so that both can start from one state."""

from __future__ import annotations

import numpy as np
import torch

from concept_tpu_torch.components import ParticleState
from concept_tpu_torch.p3mrungs import RungState

_RUNG_FIELDS = ("pos", "mom", "valid", "rungs", "ids")
_INT_DTYPES = {"valid": torch.bool, "rungs": torch.int8, "ids": torch.int32}


def from_jax_state(arrays: dict, device="cpu"):
    """{field: numpy array} of a JAX ``RungState`` (all five fields) or
    ``ParticleState`` (pos, mom, optional ids/rungs) → the port's state
    on ``device``.  Floating fields keep their dtype."""
    def conv(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=device,
                               dtype=dtype)

    if "valid" in arrays:
        return RungState(**{k: conv(arrays[k], _INT_DTYPES.get(k))
                            for k in _RUNG_FIELDS})
    return ParticleState(**{k: conv(arrays[k]) for k in
                            ("pos", "mom", "ids", "rungs")
                            if arrays.get(k) is not None})


def to_numpy(state) -> dict:
    """The port's RungState or ParticleState → {field: numpy array}
    (fields that are None are left out)."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()
            if v is not None}
