"""Device selection for the package's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    The default is the GPU.  A CUDA device that is not present raises: the
    CPU is used only when the caller names it, never as a silent fallback.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available "
            "(pass device='cpu' to run on the host)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
