"""Sharded matching: descriptor-bank parallelism.

Port of ``fastmatch_tpu/dist/sharded_match.py`` on ``torch.distributed``.
Two kinds of parallelism over the (N, M) distance problem:

- ``match_batch_dp``: independent pairs split over the ``data`` axis; each
  rank matches its slice of the pairs with ``matching.matcher.match_batch``
  (K1 on the card) and one all-gather restores the batch.
- ``match_pair_sharded``: ONE large bank split in rows over the ``bank``
  axis. Each rank keeps every query and one bank shard; the shards travel
  round the axis' ring (paired ``isend``/``irecv``, the JAX package's
  ``ppermute``) while a running top-2 is merged at each step
  (``ring_step``: K2, ``kernels/distance_topk.distance_topk``, on the shard
  the rank holds, then the merge). The merge is (value, index)
  lexicographic, so the result is the same on every rank whatever the order
  the shards arrive in, and equals the unsharded matcher's.

The cross-check needs no ring: every rank holds all queries, so the first
step's column argmin is exact for the rank's home shard, and one
all-gather puts the whole ``nnb`` together.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fastmatch_tpu_torch.core.containers import Descriptors, Matches
from fastmatch_tpu_torch.dist.bootstrap import rank_device
from fastmatch_tpu_torch.dist.mesh import (all_gather_rows, axis_rank, axis_size,
                                           batch_sharding)
from fastmatch_tpu_torch.kernels.distance_topk import distance_topk
from fastmatch_tpu_torch.matching.matcher import BIG, match_batch, ratio_sq


def _lex_merge(v1, i1, v2, i2, m1, j1, m2, j2):
    """Merge two sorted (value, index) pairs; global tie-break = lower index
    (order-independent, unlike 'running wins ties')."""

    def lt(va, ia, vb, ib):
        return (va < vb) | ((va == vb) & (ia < ib))

    take = lt(m1, j1, v1, i1)
    nv1 = torch.where(take, m1, v1)
    ni1 = torch.where(take, j1, i1)
    # Loser of the first slot competes for the second.
    lv = torch.where(take, v1, m1)
    li = torch.where(take, i1, j1)
    ov = torch.where(take, m2, v2)
    oi = torch.where(take, j2, i2)
    use_l = lt(lv, li, ov, oi)
    nv2 = torch.where(use_l, lv, ov)
    ni2 = torch.where(use_l, li, oi)
    return nv1, ni1, nv2, ni2


def ring_start(n: int, device) -> tuple:
    """The empty running top-2 of ``n`` queries: (v1, i1, v2, i2)."""
    big = torch.full((n,), BIG, dtype=torch.float32, device=device)
    zero = torch.zeros((n,), dtype=torch.int32, device=device)
    return big, zero, big.clone(), zero.clone()


def ring_step(acc, a, a2m, b_cur, b2_cur, owner: int):
    """One ring step: K2 of the queries ``a`` (masked norms ``a2m``) against
    the bank shard ``b_cur`` (masked norms ``b2_cur``) of shard index
    ``owner``, merged into the running top-2 ``acc``. Returns (acc, the
    shard's column argmin ``nnb``)."""
    ms = b_cur.shape[0]
    ci1, cd1, cd2, cnnb = distance_topk(a, b_cur, b2_cur, a2m)
    g1 = ci1 + owner * ms
    # Second-best index within the shard is not returned by the
    # kernel; it is only needed for merging, where its value cd2
    # dominates — use the shard base as a deterministic stand-in
    # ordered consistently with cd2's shard.
    g2 = torch.full_like(g1, owner * ms + ms - 1)
    return _lex_merge(*acc, cd1, g1, cd2, g2), cnnb


def _ring(a, a2m, shard, ms: int, group, me: int, n_shards: int):
    """The ring over the ``bank`` group: ``shard`` is this rank's bank rows
    and their masked norms in one flat buffer (ms * D values, then ms).
    Returns (d1, idx1, d2nd, nnb (M,))."""
    d = a.shape[1]
    nxt = dist.get_global_rank(group, (me + 1) % n_shards)
    prv = dist.get_global_rank(group, (me - 1) % n_shards)
    acc = ring_start(a.shape[0], a.device)
    nnb_local = None
    buf = shard
    for s in range(n_shards):
        owner = (me - s) % n_shards
        works, nxt_buf = (), None
        if s != n_shards - 1:
            # The next shard travels while this one is matched: the receive
            # is posted with the send, the shard and its norms in one buffer.
            nxt_buf = torch.empty_like(buf)
            works = dist.batch_isend_irecv([dist.P2POp(dist.irecv, nxt_buf, prv, group),
                                            dist.P2POp(dist.isend, buf, nxt, group)])
        acc, cnnb = ring_step(acc, a, a2m, buf[:ms * d].view(ms, d), buf[ms * d:], owner)
        if s == 0:
            # Home-shard pass doubles as the cross-check column argmin
            # (exact: A is replicated, these are this shard's columns).
            nnb_local = cnnb
        for w in works:
            w.wait()
        if nxt_buf is not None:
            buf = nxt_buf
    v1, i1, v2, _ = acc
    return v1, i1, v2, all_gather_rows(nnb_local, group)


def match_pair_sharded(
    desc_a: Descriptors,
    desc_b: Descriptors,
    mesh,
    ratio: float = 0.8,
    cross_check: bool = True,
) -> Matches:
    """Match queries A against a bank B split over mesh axis ``bank``, on
    this rank's device (K2 on the card, its plain version under gloo).

    Every rank passes the same A and B (the bank's capacity must divide by
    the axis size) and gets the same Matches back."""
    n_shards = axis_size(mesh, "bank")
    me = axis_rank(mesh, "bank")
    n = desc_a.data.shape[0]
    m = desc_b.data.shape[0]
    if m % n_shards:
        raise ValueError(f"bank capacity {m} must divide by {n_shards} shards")
    dev = rank_device(mesh.device_type)
    a = desc_a.data.to(dev, torch.float32).contiguous()
    mask_a = desc_a.mask.to(dev)
    ms = m // n_shards
    b = desc_b.data[me * ms:(me + 1) * ms].to(dev, torch.float32)
    mask_b = desc_b.mask[me * ms:(me + 1) * ms].to(dev)
    a2m = torch.where(mask_a, (a * a).sum(-1), BIG).contiguous()
    b2m = torch.where(mask_b, (b * b).sum(-1), BIG)
    shard = torch.cat([b.reshape(-1), b2m])
    d1, idx1, d2nd, nnb = _ring(a, a2m, shard, ms, mesh.get_group("bank"), me, n_shards)
    ok = mask_a & (d1 < ratio_sq(ratio) * d2nd) & (d2nd < BIG)
    if cross_check:
        mutual = nnb[idx1.long()] == torch.arange(n, dtype=torch.int32, device=dev)
        ok = ok & mutual
    return Matches(idx=idx1.to(torch.int32), dist=torch.where(ok, d1, BIG), valid=ok)


def match_batch_dp(
    desc_a: Descriptors,
    desc_b: Descriptors,
    mesh,
    ratio: float = 0.8,
    cross_check: bool = True,
    backend: str = "auto",
    precision: str = "exact",
) -> Matches:
    """Data-parallel batched matching: the leading batch axis (which must
    divide by the ``data`` axis size) split over ``data``. Each rank
    matches its slice with ``match_batch`` on its device ("auto": K1 on the
    card, the plain version under gloo; the JAX package's "jnp" default
    names the plain version, as in ``match_batch``) and one all-gather
    restores the batch."""
    sh = batch_sharding(mesh)
    dev = rank_device(mesh.device_type)
    da = Descriptors(sh.shard(desc_a.data), sh.shard(desc_a.mask))
    db = Descriptors(sh.shard(desc_b.data), sh.shard(desc_b.mask))
    got = match_batch(da, db, ratio=ratio, cross_check=cross_check, backend=backend,
                      precision=precision, device=dev)
    # One gather of the three outputs as int32 words.
    packed = torch.stack([got.idx.to(torch.int32), got.dist.view(torch.int32),
                          got.valid.to(torch.int32)], 1)
    full = sh.gather(packed)
    return Matches(idx=full[:, 0].contiguous(), dist=full[:, 1].contiguous().view(torch.float32),
                   valid=full[:, 2] != 0)
