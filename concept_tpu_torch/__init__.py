"""concept_tpu_torch — the PyTorch/CUDA port of concept_tpu.

The default P³M-with-rungs run (one matter component, EH transfer, 1LPT
'simple' noise, the unified 8-mesh-cell slot layout) runs end to end on
an NVIDIA Hopper card.  Plain tensor code is PyTorch; the particle work
that concept_tpu does in Pallas kernels is done by hand-written CUDA
kernels (``csrc/``), each with a plain PyTorch version beside it that
the CPU runs.  The JAX package ``concept_tpu`` is the reference the port
is tested against; this package imports nothing of it.
"""

__version__ = "0.1.0"
