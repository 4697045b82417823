"""Device and dtype policy of the PyTorch port.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``cuda``, and a missing card is an error, never a
silent fall-back.  Arrays are float32; float64 (``enable_float64``) is
honoured on the CPU only, because the hand-written kernels are float32.
"""

from __future__ import annotations

import torch

FLOAT64_ITEM = "ROADMAP Queue 1 item 1: float64 kernels"


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
    """float32, or float64 on the CPU under ``enable_float64``."""
    if not enable_float64:
        return torch.float32
    if device.type == "cuda":
        raise NotImplementedError(
            f"enable_float64 on the GPU: the kernels are float32 ({FLOAT64_ITEM})"
        )
    return torch.float64
