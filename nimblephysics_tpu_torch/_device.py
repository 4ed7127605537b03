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
