"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. Without a CUDA device they raise
instead of running on the CPU quietly; the plain PyTorch path on the CPU
has to be asked for with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def model_device(who: str, model, device, where: str = "the computation") -> torch.device:
    """``resolve_device`` (a bare "cuda" made the current card), for an
    entry point that computes on ``model``, which must lie on it. ``who``
    names the model in the error, ``where`` what runs on the device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if model.device != dev:
        raise ValueError(f"{who} is on {model.device}, {where} on {dev}")
    return dev
