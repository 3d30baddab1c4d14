"""Where an entry point of the port runs: ``cuda`` unless the caller names
another device (`SelectionEngine`, `models.model.init`,
`models.model.params_from_reference`)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises if CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on cuda unless "
            "the caller passes device='cpu'")
    return dev
