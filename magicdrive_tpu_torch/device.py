"""The device of the port's entry points.

The entry points build on the card unless the caller asks for the CPU
(``device="cpu"``, as the CPU tests do). Asking for a CUDA device where
there is no card raises: nothing falls back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must be visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: no CUDA card is visible (torch.cuda.is_available() "
            "is False); pass device='cpu' to build on the CPU")
    return dev
