"""Per-keypoint square patch gather (K3).

Port of ``fastmatch_tpu/kernels/patch_gather.py`` together with the
``jnp.pad(..., "edge")`` its callers put in front of it. A *patch set* (a
segment) is a contiguous (L, H, W) float32 stack, (K, 3) int32 (level, y, x)
starts, a patch size P and a virtual replicate pad; its patches are the
(K, P, P) windows of the stack padded by ``pad`` on each side (edge values
repeated), with starts clamped so each window lies inside the padded stack.

``gather_patch_sets`` gathers many sets, of different stacks and sizes, in
one launch of ``csrc/patch_gather.cu`` on CUDA tensors (``MAX_SEGMENTS`` a
launch; more take further launches) and takes ``gather_patch_sets_plain`` on
CPU tensors. The padding is folded into the reads: no padded copy of a stack
is made. ``gather_patches`` is the one-set, ``pad = 0`` case.
"""

from __future__ import annotations

import array
import ctypes
from typing import NamedTuple

import torch

from fastmatch_tpu_torch.kernels import _build

# Shared with csrc/patch_gather.cu.
MAX_SEGMENTS = 32        # segments one launch takes
BLOCK_FLOATS = 4096      # output floats one block writes (256 threads x 16)
ALIGN_FLOATS = 128       # a segment's output starts on a 512-byte boundary
TABLE_FIELDS = 10        # int64s a segment: stack, lyx, offset, first block, K, L, H, W, P, pad

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


class PatchSet(NamedTuple):
    """One segment: (L, H, W) stack, (K, 3) (level, y, x) starts into the
    stack padded by ``pad``, patch size ``patch``."""
    stack: torch.Tensor
    lyx: torch.Tensor
    patch: int
    pad: int = 0


def plan_patch_sets(sizes):
    """Layout of the one output buffer for segments of ``sizes`` [(K, P)]:
    (offsets, first_blocks, total, launches). Each segment's (K*P*P) output
    starts at ``offsets[i]`` floats, a multiple of ``ALIGN_FLOATS``, so every
    view is aligned like a fresh allocation; ``total`` floats in all.
    Segments go ``MAX_SEGMENTS`` to a launch: ``launches`` is a list of
    (first segment, end segment, blocks), and ``first_blocks[i]`` is segment
    i's first block within its launch."""
    offsets, first_blocks, launches = [], [], []
    total = 0
    for start in range(0, len(sizes), MAX_SEGMENTS):
        end = min(start + MAX_SEGMENTS, len(sizes))
        blocks = 0
        for K, P in sizes[start:end]:
            n = K * P * P
            offsets.append(total)
            first_blocks.append(blocks)
            total += -(-n // ALIGN_FLOATS) * ALIGN_FLOATS
            blocks += -(-n // BLOCK_FLOATS)
        launches.append((start, end, blocks))
    return offsets, first_blocks, total, launches


def _window_index(stack: torch.Tensor, lyx: torch.Tensor, patch: int, pad: int):
    """Clamped (level (K,1,1), row (K,P,1), col (K,1,P)) indices of each
    window into the unpadded stack."""
    L, H, W = stack.shape
    lv = lyx[:, 0].clamp(0, L - 1).long()
    y = lyx[:, 1].clamp(0, H + 2 * pad - patch).long() - pad
    x = lyx[:, 2].clamp(0, W + 2 * pad - patch).long() - pad
    r = torch.arange(patch, device=stack.device)
    rows = (y[:, None] + r).clamp(0, H - 1)
    cols = (x[:, None] + r).clamp(0, W - 1)
    return lv[:, None, None], rows[:, :, None], cols[:, None, :]


def gather_patch_sets_plain(segments):
    """Plain PyTorch version: a list of (K, P, P) tensors, one a segment,
    gathered with the clamped indices written out."""
    return [seg.stack[_window_index(seg.stack, seg.lyx, seg.patch, seg.pad)]
            for seg in map(PatchSet._make, segments)]


def gather_patches_plain(stack: torch.Tensor, lyx: torch.Tensor, patch: int):
    """Plain PyTorch version of the one-set, unpadded case: (L, H, W) stack,
    (K, 3) int (level, y, x) starts -> (K, patch, patch)."""
    L, H, W = stack.shape
    lv = lyx[:, 0].clamp(0, L - 1).long()
    y = lyx[:, 1].clamp(0, H - patch).long()
    x = lyx[:, 2].clamp(0, W - patch).long()
    r = torch.arange(patch, device=stack.device)
    return stack[lv[:, None, None], (y[:, None] + r)[:, :, None],
                 (x[:, None] + r)[:, None, :]]


def _checked(segments):
    """(segments as ``PatchSet``s, their (K, L, H, W)), validated: raises
    ValueError on a patch larger than its padded stack, a wrong shape, type,
    device or contiguity."""
    sets, dims, dev = [], [], None
    for s in segments:
        s = s if type(s) is PatchSet else PatchSet._make(s)
        stack, lyx, P, pad = s
        if dev is None:
            dev = stack.device
            if dev.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported device {dev}")
        if stack.dim() != 3:
            raise ValueError(f"stack must be (L, H, W), got {tuple(stack.shape)}")
        L, H, W = stack.shape
        if P < 1 or pad < 0:
            raise ValueError(f"patch {P} must be >= 1 and pad {pad} >= 0")
        if P > H + 2 * pad or P > W + 2 * pad:
            raise ValueError(f"patch {P} larger than stack {tuple(stack.shape)} padded by {pad}")
        if stack.device != dev or lyx.device != dev:
            raise ValueError(f"every stack and lyx must be on {dev}")
        if stack.dtype != torch.float32 or not stack.is_contiguous():
            raise ValueError("stack must be contiguous float32")
        if (lyx.dtype != torch.int32 or lyx.dim() != 2 or lyx.shape[1] != 3
                or not lyx.is_contiguous()):
            raise ValueError("lyx must be contiguous (K, 3) int32")
        K = lyx.shape[0]
        if K * P * P >= 2 ** 31 - BLOCK_FLOATS or L * H * W >= 2 ** 31:
            raise ValueError("a segment's stack and output must hold fewer than 2^31 floats")
        sets.append(s)
        dims.append((K, L, H, W))
    return sets, dims


def _table(sets, dims, offsets, first_blocks, start, end):
    """The C entry's segment table for segments [start, end): TABLE_FIELDS
    int64s each, in an ``array.array`` whose address the call passes."""
    fields = []
    for i in range(start, end):
        s = sets[i]
        fields += [s.stack.data_ptr(), s.lyx.data_ptr(), offsets[i], first_blocks[i],
                   *dims[i], s.patch, s.pad]
    return array.array("q", fields)


def _gather(segments):
    """(list of (K, P, P) tensors, kernel launches made). On CUDA: one
    output buffer, one launch per ``MAX_SEGMENTS`` segments that have
    work."""
    sets, dims = _checked(segments)
    if not sets or sets[0].stack.device.type == "cpu":
        return gather_patch_sets_plain(sets), 0
    sizes = [(K, s.patch) for s, (K, _, _, _) in zip(sets, dims)]
    offsets, first_blocks, total, launches = plan_patch_sets(sizes)
    buf = torch.empty(total, dtype=torch.float32, device=sets[0].stack.device)
    fn = _build.entry("patch_gather", "fm_gather_patch_sets", _ARGTYPES)
    stream = _build.stream_of(buf)
    made = 0
    for start, end, blocks in launches:
        if blocks == 0:
            continue
        table = _table(sets, dims, offsets, first_blocks, start, end)
        _build.check(fn(table.buffer_info()[0], end - start, blocks, buf.data_ptr(), stream),
                     "gather_patch_sets")
        made += 1
    outs = [buf.as_strided((K, P, P), (P * P, P, 1), off)
            for off, (K, P) in zip(offsets, sizes)]
    return outs, made


def gather_patch_sets(segments):
    """Kernel entry: a list of ``PatchSet`` (or (stack, lyx, patch, pad)
    tuples) -> a list of contiguous (K, patch, patch) float32 tensors, views
    of one buffer, in the segments' order."""
    outs, made = _gather(segments)
    gather_patch_sets.launches += made
    return outs


def gather_patches(stack: torch.Tensor, lyx: torch.Tensor, patch: int):
    """Kernel entry of the one-set, unpadded case: (L, H, W) float32 stack +
    (K, 3) int32 starts -> (K, patch, patch) float32."""
    outs, made = _gather([PatchSet(stack, lyx, patch, 0)])
    gather_patches.launches += made
    return outs[0]


gather_patch_sets.launches = 0
gather_patches.launches = 0
