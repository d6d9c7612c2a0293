"""The device rule of the port: work runs where the caller says, never
silently elsewhere.

``"cuda"`` (the default everywhere) requires a CUDA device and raises when
there is none; ``"cpu"`` must be asked for, as the CPU tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceSpec = Union[str, torch.device]


def resolve_device(device: DeviceSpec) -> torch.device:
    """The ``torch.device`` for ``device``; raises ``RuntimeError`` for a
    CUDA device on a machine without CUDA (there is no fallback to CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
