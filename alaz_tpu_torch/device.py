"""Device selection for the package's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else ``cuda``.
    With no card, a ``cuda`` request raises rather than running on the
    CPU: a silent CPU run would be read as the card's result."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "alaz_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev
