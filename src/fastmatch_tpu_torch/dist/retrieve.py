"""Sharded frame-level retrieval: the VLAD keyframe DB over the mesh.

Port of ``fastmatch_tpu/dist/retrieve.py`` on ``torch.distributed``. The
keyframe DB lies on the same ``bank`` axis as the descriptor banks and map
blocks (dist/mesh.py): each rank scores the query VLADs against ITS row
shard of the (F, K*D) database (``q @ db_sh.T``: a plain product outside
any kernel of the JAX package), takes a local top-k, and one all-gather of
(value, global index) candidates (topk a query from each rank, not the
F-row score matrix) feeds a final top-k on every rank.

Order: both top-k's sort stably by descending score, as
``matching/vlad.retrieve`` does; the gathered candidates are shard-major
and each shard's are (value desc, index asc), so equal scores resolve
toward the lower global frame index, as in the unsharded route. Where
every score is finite the result equals ``vlad.retrieve``'s bit for bit,
given equal per-row scores (a product that sums in the same order, or
scores whose sums are exact); among dead rows (score -inf) ties may pick
other indices than the unsharded route.
"""

from __future__ import annotations

import torch

from fastmatch_tpu_torch.dist.bootstrap import rank_device
from fastmatch_tpu_torch.dist.mesh import all_gather_rows, axis_rank, axis_size


def _top(s: torch.Tensor, k: int):
    """The ``k`` highest scores of each row and their columns, stably
    sorted: equal scores keep the lower column first."""
    vals, ids = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def retrieve_local(q: torch.Tensor, db_sh: torch.Tensor, mask_sh: torch.Tensor, base: int,
                   topk: int):
    """One shard's candidates: the ``topk`` best scores of the queries
    against the DB rows ``db_sh`` (live where ``mask_sh``), and their global
    indices (the shard's first row is ``base``)."""
    s = q @ db_sh.T  # (Q, F/n) — full contraction, exact per row
    s = torch.where(mask_sh[None, :], s, -torch.inf)
    v, idx = _top(s, topk)
    return v, idx + base


def retrieve_merge(vals: torch.Tensor, ids: torch.Tensor, topk: int):
    """The final top-k of (Q, n * topk) candidates laid out shard-major."""
    v, sel = _top(vals, topk)
    return v, torch.gather(ids, 1, sel)


def retrieve_sharded(q: torch.Tensor, db: torch.Tensor, db_mask: torch.Tensor,
                     mesh, topk: int = 5, axis: str = "bank"):
    """Score (Q, K*D) queries against an (F, K*D) DB split in rows over
    ``axis``, on this rank's device. Every rank passes the same inputs and
    gets the same (scores (Q, topk), ids (Q, topk)).

    F must divide by the axis size, and each shard must hold >= topk rows
    (F/n >= topk) so no candidate can be lost to a local cut.
    """
    n = axis_size(mesh, axis)
    f = db.shape[0]
    if f % n:
        raise ValueError(f"DB rows {f} not divisible by mesh axis {n}")
    if f // n < topk:
        raise ValueError(f"shard rows {f // n} < topk {topk}")
    dev = rank_device(mesh.device_type)
    i = axis_rank(mesh, axis)
    rows = f // n
    qr = q.to(dev)
    v, gidx = retrieve_local(qr, db[i * rows:(i + 1) * rows].to(dev),
                             db_mask[i * rows:(i + 1) * rows].to(dev), i * rows, topk)
    # (n, Q, topk) gathered, then shard-major columns (Q, n * topk).
    group = mesh.get_group(axis)
    va = all_gather_rows(v[None], group).permute(1, 0, 2).reshape(qr.shape[0], -1)
    ia = all_gather_rows(gidx[None], group).permute(1, 0, 2).reshape(qr.shape[0], -1)
    return retrieve_merge(va, ia, topk)
