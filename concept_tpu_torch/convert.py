"""Carry states between the JAX package and the port as numpy arrays,
field for field (ParticleState: pos, mom, ids, rungs; RungState: pos,
mom, valid, rungs, ids; P3MState and BucketState: pos, mom, valid;
FluidState: varrho, J, P, sigma; MultiState: {'particles': {name:
fields}, 'fluids': {name: fields}}), so that both can start from one
state."""

from __future__ import annotations

import numpy as np
import torch

from concept_tpu_torch.bucketsim import BucketState
from concept_tpu_torch.components import FluidState, ParticleState
from concept_tpu_torch.p3mrungs import RungState
from concept_tpu_torch.p3msim import P3MState

_RUNG_FIELDS = ("pos", "mom", "valid", "rungs", "ids")
_INT_DTYPES = {"valid": torch.bool, "rungs": torch.int8, "ids": torch.int32}


def from_jax_state(arrays: dict, device="cpu"):
    """{field: numpy array} of a JAX ``RungState`` (all five fields),
    ``P3MState`` (pos, mom, valid), ``ParticleState`` (pos, mom,
    optional ids/rungs) or ``FluidState`` (varrho, optional J, P, sigma;
    a field that is None stays None), or {'particles': {...}, 'fluids':
    {...}} of a ``MultiState`` → the port's state on ``device``.
    Floating fields keep their dtype."""
    def conv(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=device,
                               dtype=dtype)

    if "particles" in arrays:
        from concept_tpu_torch.sim_multi import MultiState

        return MultiState(
            particles={k: from_jax_state(v, device) for k, v in arrays["particles"].items()},
            fluids={k: from_jax_state(v, device) for k, v in arrays["fluids"].items()})
    if "varrho" in arrays:
        return FluidState(*(None if arrays.get(k) is None else conv(arrays[k])
                            for k in FluidState._fields))

    if "valid" in arrays and "rungs" in arrays:
        return RungState(**{k: conv(arrays[k], _INT_DTYPES.get(k))
                            for k in _RUNG_FIELDS})
    if "valid" in arrays:
        return P3MState(pos=conv(arrays["pos"]), mom=conv(arrays["mom"]),
                        valid=conv(arrays["valid"], torch.bool))
    return ParticleState(**{k: conv(arrays[k]) for k in
                            ("pos", "mom", "ids", "rungs")
                            if arrays.get(k) is not None})


def from_jax_multi(state, device="cpu"):
    """The JAX package's ``MultiState`` (each ``ParticleState`` and
    ``FluidState`` with numpy or JAX arrays) → the port's MultiState on
    ``device``, field for field (:func:`from_jax_state`)."""
    def arrays(t):
        return {k: None if v is None else np.asarray(v) for k, v in t._asdict().items()}

    return from_jax_state({"particles": {k: arrays(v) for k, v in state.particles.items()},
                           "fluids": {k: arrays(v) for k, v in state.fluids.items()}}, device)


def to_numpy(state) -> dict:
    """The port's RungState, P3MState, ParticleState or FluidState →
    {field: numpy array} (fields that are None are left out); a
    MultiState → {'particles': {name: ...}, 'fluids': {name: ...}}."""
    if hasattr(state, "fluids"):
        return {"particles": {k: to_numpy(v) for k, v in state.particles.items()},
                "fluids": {k: to_numpy(v) for k, v in state.fluids.items()}}
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()
            if v is not None}


def bucket_state_from_jax(arrays: dict, gridsize: int, device="cpu") -> BucketState:
    """{pos, mom: (3, K, Cp), valid: (K, Cp)} numpy arrays of a JAX
    ``BucketState``, whose block axis is padded to a multiple of 128
    lanes, → the port's BucketState with C = (gridsize/2)³ columns.  The
    padding columns must be empty (the JAX package's spill may fill them;
    rebucket such a state in the port instead)."""
    C = (gridsize // 2) ** 3
    valid = np.asarray(arrays["valid"])
    if valid[:, C:].any():
        raise ValueError("the JAX state holds particles in its padding columns")

    def conv(a, dtype=None):
        return torch.as_tensor(np.array(np.asarray(a)[..., :C]),
                               device=device, dtype=dtype)

    return BucketState(pos=conv(arrays["pos"]), mom=conv(arrays["mom"]),
                       valid=conv(valid, torch.bool))
