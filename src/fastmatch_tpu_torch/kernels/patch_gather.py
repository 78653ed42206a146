"""Per-keypoint square patch gather (K3).

Port of ``fastmatch_tpu/kernels/patch_gather.py``: ``gather_patches``
launches ``csrc/patch_gather.cu`` on a CUDA tensor and takes
``gather_patches_plain`` on a CPU tensor. Both return
``stack[l, y:y+P, x:x+P]`` per (l, y, x) row, with starts clamped so each
patch lies inside the stack as given.
"""

from __future__ import annotations

import ctypes

import torch

from fastmatch_tpu_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


def gather_patches_plain(stack: torch.Tensor, lyx: torch.Tensor, patch: int):
    """Plain PyTorch version: (L, H, W) stack, (K, 3) int (level, y, x)
    starts -> (K, patch, patch)."""
    L, H, W = stack.shape
    lv = lyx[:, 0].clamp(0, L - 1).long()
    y = lyx[:, 1].clamp(0, H - patch).long()
    x = lyx[:, 2].clamp(0, W - patch).long()
    r = torch.arange(patch, device=stack.device)
    return stack[lv[:, None, None], (y[:, None] + r)[:, :, None],
                 (x[:, None] + r)[:, None, :]]


def gather_patches(stack: torch.Tensor, lyx: torch.Tensor, patch: int):
    """Kernel entry: (L, H, W) float32 stack + (K, 3) int32 starts ->
    (K, patch, patch) float32."""
    L, H, W = stack.shape
    if patch > H or patch > W:
        raise ValueError(f"patch {patch} larger than stack {tuple(stack.shape)}")
    if stack.device.type == "cpu":
        return gather_patches_plain(stack, lyx, patch)
    if stack.device.type != "cuda":
        raise ValueError(f"unsupported device {stack.device}")
    if stack.dtype != torch.float32 or not stack.is_contiguous():
        raise ValueError("stack must be contiguous float32")
    if (lyx.dtype != torch.int32 or lyx.dim() != 2 or lyx.shape[1] != 3
            or not lyx.is_contiguous() or lyx.device != stack.device):
        raise ValueError(f"lyx must be contiguous (K, 3) int32 on {stack.device}")
    K = lyx.shape[0]
    out = torch.empty((K, patch, patch), dtype=torch.float32, device=stack.device)
    fn = _build.entry("patch_gather", "fm_gather_patches", _ARGTYPES)
    P = _build.ptr
    rc = fn(P(stack), P(lyx), K, L, H, W, patch, P(out), _build.stream_of(stack))
    _build.check(rc, "gather_patches")
    gather_patches.launches += 1
    return out


gather_patches.launches = 0
