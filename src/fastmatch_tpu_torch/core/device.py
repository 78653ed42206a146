"""Device selection for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Raises when CUDA is asked for (explicitly or by default)
    and is not available: the port never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def as_f32(a, device=None) -> torch.Tensor:
    """``a`` (a tensor, or an array or list, copied: PyTorch takes no
    read-only array) as a float32 tensor on ``device``, resolved by
    ``resolve_device``."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(device=resolve_device(device), dtype=torch.float32)
