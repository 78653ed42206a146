"""Covisibility-driven map-block partition for distributed BA.

Port of ``fastmatch_tpu/dist/partition.py``: the same numpy (and scipy)
code; ``partition_problem`` takes the port's ``BAProblem``, works on its
tables through numpy and returns tensors on the problem's device.

Distributed BA (dist_ba.py) shards the observation table across the
``bank`` axis. WHICH observations land together is a free choice — any
partition all-reduces to the same normal equations — but it is the lever
for locality: a covisibility block keeps each device's observations on a
small set of cameras and points, which (a) tightens the per-rank sorted
segment windows the segment kernels walk, and (b) is exactly the separator
structure a future point-sharded BA needs (points interior to one block
never cross devices; only separator cameras would).

The partition is built host-side from the covisibility graph (frames ~
edges weighted by co-observed landmarks): greedy balanced growth — seed
each block with the highest-degree unassigned frame, then repeatedly
attach the unassigned frame with the largest covisibility to the lightest
open block (weights = observation counts). Observation rows follow their
FRAME's block; dead rows pad block 0.

Rarely executed (once per BA epoch at most) and O(F^2) at 10k keyframes:
host numpy/scipy is the right tool, not a kernel.
"""

from __future__ import annotations

import numpy as np

import torch

from fastmatch_tpu_torch.ba.problem import Observations


def _np(x) -> np.ndarray:
    """A tensor or an array as a numpy array (read back from its device)."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def covisibility_matrix(obs_cam, obs_pt, obs_mask, n_frames: int,
                        n_points: int) -> np.ndarray:
    """(F, F) symmetric covisibility counts: C[i, j] = number of landmarks
    observed by both frame i and frame j (diagonal = per-frame counts).

    Built through a sparse incidence matrix: memory is O(nnz + F^2), never
    the dense (F, P) grid — at config-5 scale (10k frames x 1M landmarks)
    the dense intermediate would be 40 GB while the result is 100 MB."""
    from scipy import sparse

    cam = _np(obs_cam)
    pt = _np(obs_pt)
    msk = _np(obs_mask)
    A = sparse.csr_matrix(
        (np.ones(int(msk.sum()), np.int64), (cam[msk], pt[msk])),
        shape=(n_frames, n_points))
    A.data[:] = 1  # duplicate (cam, pt) rows collapse to one observation
    return np.asarray((A @ A.T).todense(), np.int64)


def partition_frames(C: np.ndarray, n_blocks: int,
                     weights: np.ndarray | None = None) -> np.ndarray:
    """Greedy balanced covisibility clustering. Returns block_of_frame
    (F,) int32 in [0, n_blocks). Frames with zero observations go to the
    lightest block at the end."""
    F = C.shape[0]
    deg = C.sum(1) - np.diag(C)
    w = np.asarray(weights) if weights is not None else np.diag(C).copy()
    block_of = np.full(F, -1, np.int32)
    block_w = np.zeros(n_blocks, np.float64)
    live = np.diag(C) > 0
    # Seed blocks with the highest-degree frames, pairwise far apart.
    order = np.argsort(-deg)
    seeds = []
    for f in order:
        if not live[f]:
            continue
        if all(C[f, s] * 4 < min(C[f, f], C[s, s]) + 1 for s in seeds):
            seeds.append(int(f))
        if len(seeds) == n_blocks:
            break
    for f in order:  # top up if the spread test found too few
        if len(seeds) == n_blocks:
            break
        if live[f] and int(f) not in seeds:
            seeds.append(int(f))
    for b, s in enumerate(seeds):
        block_of[s] = b
        block_w[b] += w[s]
    target = w[live].sum() / max(n_blocks, 1)
    # Grow: attach the (frame, block) pair with max covisibility into a
    # block that is not overweight. Scores are maintained INCREMENTALLY:
    # score[f, b] = C[f, members(b)].sum(), updated with one C-row add per
    # assignment — O(F) per frame, O(F^2) total (the naive recompute is
    # O(F^3) and takes hours at 10k keyframes; this takes seconds).
    score = np.zeros((F, n_blocks), np.int64)
    for b, s in enumerate(seeds):
        score[:, b] += C[:, s]
    unassigned = live & (block_of < 0)
    for s in seeds:
        unassigned[s] = False
    masked = np.where(unassigned[:, None], score, -1)
    while unassigned.any():
        open_b = block_w < 1.5 * target
        if not open_b.any():
            open_b[:] = True
        cand = np.where(open_b[None, :], masked, -1)
        flat = int(np.argmax(cand))
        f, b = divmod(flat, n_blocks)
        if cand[f, b] <= 0:  # no covisible frame left: fill the lightest
            f = int(np.argmax(unassigned))
            b = int(np.argmin(np.where(open_b, block_w, np.inf)))
        block_of[f] = b
        block_w[b] += w[f]
        unassigned[f] = False
        masked[f, :] = -1
        score[:, b] += C[:, f]
        masked[:, b] = np.where(unassigned, score[:, b], -1)
    block_of[block_of < 0] = int(np.argmin(block_w))  # obs-free frames
    return block_of


def partition_problem(problem, n_blocks: int, bucket: int = 1024):
    """Host-side relayout of a BAProblem for ``ba_solve_sharded(...,
    presorted=True)``: each of the ``n_blocks`` equal observation shards IS
    one covisibility map block, internally pt-sorted (dead padding first
    with pt_idx 0, exactly like ba/lm.sort_obs_by_point's invariant).

    ba_solve_sharded's default path globally pt-sorts the table, which
    scatters every frame's rows across all devices; this layout instead
    keeps each device's rows on its block's small camera/point working set
    — the per-chunk [first, last] point windows the segment kernels
    walk shrink from the full map to one block's span, and the separator
    structure (cameras covisible across blocks) is exactly what the
    all-reduce pays for. Shard capacity is padded to a ``bucket`` multiple
    so repeated global BAs at slowly-growing map sizes reuse the compile.

    Returns (problem', block_of_frame)."""
    obs = problem.obs
    cam = _np(obs.cam_idx)
    pt = _np(obs.pt_idx)
    msk = _np(obs.mask)
    F = int(problem.cam_mask.shape[0])
    P = int(problem.pt_mask.shape[0])
    C = covisibility_matrix(cam[msk], pt[msk], np.ones(int(msk.sum()), bool),
                            F, P)
    blocks = partition_frames(C, n_blocks)
    blk = np.where(msk, blocks[cam].astype(np.int64), n_blocks)
    order = np.lexsort((pt, blk))          # primary block, secondary point
    order = order[blk[order] < n_blocks]   # live rows only, (blk, pt)-sorted
    sizes = np.bincount(blk[blk < n_blocks], minlength=n_blocks)
    S = max(int(sizes.max()), 8)
    S = -(-S // bucket) * bucket
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    b_of = blk[order]
    rank = np.arange(len(order)) - starts[b_of]
    # Live rows at the END of their slice; dead padding (pt 0) in front.
    dest = b_of * S + (S - sizes[b_of]) + rank
    total = n_blocks * S
    new = {
        "cam_idx": np.zeros(total, cam.dtype),
        "pt_idx": np.zeros(total, pt.dtype),
        "uv": np.zeros((total, 2), np.float32),
        "mask": np.zeros(total, bool),
    }
    new["cam_idx"][dest] = cam[order]
    new["pt_idx"][dest] = pt[order]
    new["uv"][dest] = _np(obs.uv)[order]
    new["mask"][dest] = True
    dev = obs.cam_idx.device
    return problem._replace(obs=Observations(
        *(torch.from_numpy(new[k]).to(dev) for k in ("cam_idx", "pt_idx", "uv", "mask")),
    )), blocks


def order_observations_by_block(obs: Observations, block_of_frame,
                                n_blocks: int):
    """Stable-reorder observation rows so rows of block b are contiguous
    (dead rows last). Returns (permutation (O,), block_sizes (n_blocks,)).
    Apply with ``Observations(*(x[perm] for x in obs))`` — the BA result
    is invariant (sums), but each rank's shard becomes one covisibility
    block."""
    cam = _np(obs.cam_idx)
    msk = _np(obs.mask)
    blk = np.asarray(block_of_frame)[cam].astype(np.int64)
    blk = np.where(msk, blk, n_blocks)  # dead rows sort after every block
    perm = np.argsort(blk, kind="stable")
    sizes = np.bincount(blk[blk < n_blocks], minlength=n_blocks)
    return perm.astype(np.int32), sizes.astype(np.int64)
