"""Device and dtype policy of the PyTorch port.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``cuda``, and a missing card is an error, never a
silent fall-back.  Arrays are float32, or float64 under
``enable_float64`` on either device: every CUDA kernel has a double
instantiation.
"""

from __future__ import annotations

import torch

def resolve_device(device=None) -> torch.device:
    """``None``/``'cuda'`` → the current CUDA device (raises when CUDA is
    absent); ``'cpu'`` → the CPU."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (CLI: --device cpu)"
                " to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_dtype(device: torch.device, enable_float64: bool = False):
    """float64 under ``enable_float64``, else float32, on either device."""
    return torch.float64 if enable_float64 else torch.float32
