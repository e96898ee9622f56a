"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it raises when CUDA is unavailable rather
    than carrying on quietly on the CPU.  Pass ``"cpu"`` (as the tests
    do) to run every kernel wrapper's plain PyTorch version.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda")
    return torch.device(device)
