"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a torch.device; None means the first CUDA card.

    Without a card, None raises rather than running on the CPU: the CPU
    path computes the kernels' plain versions and is only taken when the
    caller asks for it with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
