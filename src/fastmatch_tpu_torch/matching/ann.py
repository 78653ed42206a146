"""Approximate nearest-neighbour search: a k-means coarse quantizer (IVF).

Port of ``fastmatch_tpu/matching/ann.py``:

1. **Train**: masked Lloyd k-means over the bank's descriptors.
2. **Query**: queries score every centroid, keep their ``n_probe`` nearest
   clusters, and the exact matcher (``matching.matcher.match_pair``: K2 on
   the card) runs on the probed rows only: by masking (``match_pair_ann``)
   or on a compact bank of ``budget`` rows gathered from a cluster-sorted
   index (``match_pair_ann_big``, the city-scale path).

Differences from the JAX package, each for the card:

- Cluster sums go through K4 (``kernels/segment_ops.sorted_segment_sum``)
  over the keys sorted stably once per Lloyd iteration, and the counts are
  the sorted keys' segment lengths: no float atomics, so two index builds
  on the card are bit-identical and a served map answers alike after every
  restart.
- The assignment is computed in slabs of ``ASSIGN_SLAB`` rows: the (M, K)
  distance matrix of a 4,000,000-row bank at 2048 clusters would be
  32 GiB. Argmin is per row (the first index on ties, ``jnp.argmin``'s
  rule), so the slab size does not change the result.
- The Gumbel draws of the initialization cannot replay JAX's: sampling
  (``kmeans_init_idx``) and the iterations (``kmeans_from_init``) are
  split, so a test can feed the JAX package's own ``init_idx``.
- Orders on ties follow ``lax.top_k`` and ``jnp.argsort``: the lower index
  first, through stable sorts (``torch.topk``'s order on ties is not
  defined). Cluster votes are summed from integer (cluster, rank) counts,
  so two clusters probed alike tie exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastmatch_tpu_torch.core.containers import Descriptors, Matches
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.kernels.segment_ops import segment_offsets, sorted_segment_sum
from fastmatch_tpu_torch.matching.matcher import BIG, match_pair

# Rows per slab of the k-means assignment: a (262,144 x 2048) float32 slab
# of distances is 2 GiB.
ASSIGN_SLAB = 262_144


class IVFIndex(NamedTuple):
    centroids: torch.Tensor  # (K, D)
    assign: torch.Tensor     # (M,) int32 cluster of each bank row
    desc: Descriptors        # the bank itself


class IVFIndexSorted(NamedTuple):
    """Cluster-sorted IVF index: each cluster's rows are contiguous, so a
    probe admits whole clusters and one ``budget``-row gather builds the
    compact candidate bank."""

    centroids: torch.Tensor  # (K, D)
    desc: Descriptors        # bank rows sorted by cluster
    perm: torch.Tensor       # (M,) int32 original bank row of each sorted row
    starts: torch.Tensor     # (K + 1,) int32 cluster row ranges in the sorted bank
    assign: torch.Tensor     # (M,) int32 cluster of each sorted row (K for dead rows)


def _sq_dist(x: torch.Tensor, c: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """|x|^2 - 2 x.c + |c|^2, the JAX package's expansion."""
    return (x * x).sum(1, keepdim=True) - 2.0 * (x @ c.T) + c2[None, :]


def assign_clusters(data: torch.Tensor, mask: torch.Tensor, cent: torch.Tensor,
                    slab: int = ASSIGN_SLAB) -> torch.Tensor:
    """(M,) int64 nearest centroid of each row, ``slab`` rows at a time;
    masked rows score BIG everywhere and take cluster 0."""
    c2 = (cent * cent).sum(1)
    out = torch.empty(data.shape[0], dtype=torch.int64, device=data.device)
    for s in range(0, data.shape[0], slab):
        d2 = _sq_dist(data[s:s + slab], cent, c2)
        out[s:s + slab] = torch.where(mask[s:s + slab, None], d2, BIG).argmin(dim=1)
    return out


def _cluster_sums(data: torch.Tensor, mask: torch.Tensor, assign: torch.Tensor, k: int):
    """(sums (K, D), counts (K,)) of the live rows by cluster: K4 over the
    keys sorted stably (dead rows keyed K, which K4 drops); the counts are
    the segment lengths."""
    keys = torch.where(mask, assign, k).to(torch.int32)
    order = torch.argsort(keys, stable=True)
    sk = keys[order].contiguous()
    off = segment_offsets(sk, k)
    sums = sorted_segment_sum(data[order].contiguous(), sk, k, offsets=off)
    return sums, (off[1:] - off[:-1]).to(data.dtype)


def kmeans_init_idx(mask: torch.Tensor, n_clusters: int,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """(K,) rows drawn without replacement among the live ones (Gumbel
    top-k over the mask, ties to the lower index), on ``mask``'s device."""
    gen_dev = generator.device if generator is not None else torch.device("cpu")
    u = torch.rand(mask.shape[0], generator=generator, device=gen_dev).to(mask.device)
    g = -torch.log(-torch.log(u))
    g = torch.where(mask, g, -torch.inf)
    return torch.sort(g, descending=True, stable=True).indices[:n_clusters]


def kmeans_from_init(data: torch.Tensor, mask: torch.Tensor, init_idx: torch.Tensor,
                     iters: int = 10, slab: int = ASSIGN_SLAB):
    """Masked Lloyd's k-means from the centroids ``data[init_idx]``;
    returns (centroids (K, D), assign (M,) int32). Empty clusters keep
    their previous centroid."""
    data = data.float()
    cent = data[init_idx.to(data.device).long()]
    k = cent.shape[0]
    for _ in range(iters):
        assign = assign_clusters(data, mask, cent, slab)
        sums, counts = _cluster_sums(data, mask, assign, k)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        cent = torch.where((counts > 0)[:, None], new, cent)
    return cent, assign_clusters(data, mask, cent, slab).to(torch.int32)


def kmeans(data: torch.Tensor, mask: torch.Tensor, n_clusters: int, iters: int = 10,
           generator: torch.Generator | None = None, slab: int = ASSIGN_SLAB):
    """Masked Lloyd's k-means; returns (centroids (K, D), assign (M,))."""
    init_idx = kmeans_init_idx(mask, n_clusters, generator)
    return kmeans_from_init(data, mask, init_idx, iters, slab)


def _train(desc: Descriptors, n_clusters, iters, generator, init_idx):
    data = desc.data.float()
    if init_idx is None:
        init_idx = kmeans_init_idx(desc.mask, n_clusters, generator)
    return kmeans_from_init(data, desc.mask, init_idx, iters)


def build_index(desc: Descriptors, n_clusters: int = 64, iters: int = 10,
                generator: torch.Generator | None = None, init_idx=None) -> IVFIndex:
    """IVF index over a bank; ``init_idx`` replaces the sampling step."""
    cent, assign = _train(desc, n_clusters, iters, generator, init_idx)
    return IVFIndex(centroids=cent, assign=assign, desc=desc)


def build_index_sorted(desc: Descriptors, n_clusters: int = 64, iters: int = 10,
                       generator: torch.Generator | None = None,
                       init_idx=None) -> IVFIndexSorted:
    """K-means, then the cluster sort (one-time, index build): a stable
    sort of the keys, dead rows keyed K (they stay unmatched: their mask
    stays False after the sort)."""
    cent, assign = _train(desc, n_clusters, iters, generator, init_idx)
    k = cent.shape[0]
    keys = torch.where(desc.mask, assign.long(), k)
    perm = torch.argsort(keys, stable=True)
    sorted_keys = keys[perm]
    starts = torch.searchsorted(sorted_keys,
                                torch.arange(k + 1, device=keys.device, dtype=keys.dtype))
    return IVFIndexSorted(centroids=cent, desc=Descriptors(desc.data[perm], desc.mask[perm]),
                          perm=perm.to(torch.int32), starts=starts.to(torch.int32),
                          assign=sorted_keys.to(torch.int32))


def _probes(a: torch.Tensor, cent: torch.Tensor, n_probe: int, mask=None) -> torch.Tensor:
    """(N, P) nearest clusters of each query, in ``lax.top_k(-dq)``'s order
    (ties to the lower index); masked queries score BIG everywhere."""
    dq = _sq_dist(a, cent, (cent * cent).sum(1))
    if mask is not None:
        dq = torch.where(mask[:, None], dq, BIG)
    return torch.sort(dq, dim=1, stable=True).indices[:, :n_probe]


def match_pair_ann(desc_a: Descriptors, index: IVFIndex, n_probe: int = 8, ratio: float = 0.8,
                   cross_check: bool = True, device=None) -> Matches:
    """Approximate matcher: the union of every query's ``n_probe`` nearest
    clusters is live, the rest of the bank is masked, and one exact match
    (K2 on the card) runs over the bank."""
    dev = resolve_device(device)
    a = desc_a.data.float().to(dev)
    cent = index.centroids.to(dev)
    probe = _probes(a, cent, n_probe)
    probed = torch.zeros(cent.shape[0], dtype=torch.bool, device=dev)
    probed[probe.reshape(-1)] = True
    cand = index.desc.mask.to(dev) & probed[index.assign.to(dev).long()]
    return match_pair(Descriptors(a, desc_a.mask.to(dev)), Descriptors(index.desc.data, cand),
                      ratio=ratio, cross_check=cross_check, device=dev)


def cluster_votes(probe: torch.Tensor, qmask: torch.Tensor, k: int) -> torch.Tensor:
    """(K,) rank-weighted probe votes: a query's r-th probe counts
    1 / (1 + r). Summed from integer (cluster, rank) counts, so the sums
    are deterministic and equal profiles tie exactly."""
    n_probe = probe.shape[1]
    rank = torch.arange(n_probe, device=probe.device)
    keys = torch.where(qmask[:, None], probe * n_probe + rank[None, :], k * n_probe)
    cnt = torch.bincount(keys.reshape(-1), minlength=k * n_probe + 1)[:k * n_probe]
    rank_w = 1.0 / (1.0 + rank.to(torch.float32))
    return (cnt.reshape(k, n_probe).to(torch.float32) * rank_w[None, :]).sum(1)


def match_pair_ann_big(desc_a: Descriptors, index: IVFIndexSorted, budget: int = 4096,
                       n_probe: int = 8, ratio: float = 0.8, cross_check: bool = True,
                       backend: str = "auto", device=None) -> Matches:
    """IVF search with a compact candidate bank of ``budget`` rows.

    1. Queries score all centroids; each probes its ``n_probe`` nearest.
    2. Clusters are ranked by rank-weighted votes and whole clusters are
       admitted in rank order while they fit the budget (a prefix-admit
       and two repair passes, each dropping clusters larger than what is
       left first).
    3. One gather builds the compact bank, the exact matcher (K2 on the
       card) runs on it, and indices map back through the sort
       permutation. No readback: every step stays on the device."""
    dev = resolve_device(device)
    bank = index.desc
    m_rows = bank.data.shape[0]
    k = index.centroids.shape[0]
    budget = min(budget, m_rows)  # a budget covering the whole bank is exact search
    a = desc_a.data.float().to(dev)
    qmask = desc_a.mask.to(dev)
    probe = _probes(a, index.centroids, n_probe, qmask)
    votes = cluster_votes(probe, qmask, k)

    sizes = (index.starts[1:] - index.starts[:-1]).long()
    order = torch.argsort(-votes, stable=True)  # clusters by weighted popularity
    sz_ord = sizes[order]
    v_ord = votes[order]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    admit = torch.zeros(k, dtype=torch.bool, device=dev)
    for _ in range(3):
        left = budget - torch.where(admit, sz_ord, zero).sum()
        elig = ~admit & (v_ord > 0) & (sz_ord <= left)
        cum = torch.cumsum(torch.where(elig, sz_ord, zero), 0)
        admit = admit | (elig & (cum <= left))
    adm_sz = torch.where(admit, sz_ord, zero)
    end_ord = torch.cumsum(adm_sz, 0)
    off_ord = end_ord - adm_sz

    # Compact slot -> sorted-bank row, built from the admitted side.
    slots = torch.arange(budget, device=dev)
    k_of_slot = torch.searchsorted(end_ord, slots, right=True).clamp(0, k - 1)
    tbl = index.starts[order[k_of_slot]].long() + (slots - off_ord[k_of_slot])
    valid_row = slots < end_ord[-1]
    tbl = torch.where(valid_row, tbl, zero)
    compact = Descriptors(torch.where(valid_row[:, None], bank.data[tbl], 0.0),
                          valid_row & bank.mask[tbl])
    m = match_pair(Descriptors(a, qmask), compact, ratio=ratio, cross_check=cross_check,
                   backend=backend, device=dev)
    orig = index.perm[tbl].to(torch.int32)
    return Matches(idx=torch.where(m.valid, orig[m.idx.long().clamp(0, budget - 1)], m.idx),
                   dist=m.dist, valid=m.valid)
