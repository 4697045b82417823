"""The 2³-mesh-cell block geometry of the global stepper's PM layout
(port of ``B`` and ``_block_count``, concept_tpu/grid/bucketed.py)."""

B = 2  # mesh cells per block per dimension


def _block_count(n: int) -> int:
    if n % B:
        raise ValueError(f"gridsize {n} must be divisible by block size {B}")
    return n // B
