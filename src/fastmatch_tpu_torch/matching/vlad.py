"""Frame-level place recognition: VLAD descriptors.

Port of ``fastmatch_tpu/matching/vlad.py``. Every frame's descriptor set
compresses to one (K*D,) vector, so "which keyframes look like this
view?" is one product against a (F, K*D) database:

* assignment: (M, D) x (D, K) product and row argmin -> one-hot (M, K);
* aggregation: V = one_hot^T desc - counts[:, None] * vocab (two products
  in place of the per-word residual scatter);
* normalization: per-word L2 (intra-normalization), signed square root,
  global L2.

The vocabulary is the masked Lloyd k-means of ``matching/ann.py``. These
are plain products outside any kernel of the JAX package, so they stay
``torch.matmul`` (full float32: the package pins TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.matching.ann import kmeans_from_init, kmeans_init_idx


class Vocabulary(NamedTuple):
    """Visual vocabulary: k-means centroids over descriptor space."""

    words: torch.Tensor  # (K, D) f32


def train_vocabulary(desc, mask, n_words: int = 64, iters: int = 12,
                     generator: torch.Generator | None = None, init_idx=None,
                     device=None) -> Vocabulary:
    """Train a K-word vocabulary over a masked (M, D) descriptor sample on
    ``device``; ``init_idx`` replaces the sampling step."""
    dev = resolve_device(device)
    x = torch.as_tensor(desc, dtype=torch.float32).to(dev)
    m = torch.as_tensor(mask, dtype=torch.bool).to(dev)
    if init_idx is None:
        init_idx = kmeans_init_idx(m, n_words, generator)
    cent, _ = kmeans_from_init(x, m, torch.as_tensor(init_idx), iters)
    return Vocabulary(words=cent)


def vlad_encode_batch(desc: torch.Tensor, mask: torch.Tensor, vocab: Vocabulary) -> torch.Tensor:
    """(F, M, D) descriptor sets with (F, M) masks -> (F, K*D) unit VLADs.
    Hard assignment to the nearest word, residual aggregation per word,
    intra-normalization, signed square root, global L2. An all-masked set
    encodes to zeros (it scores 0 against everything: a safe "no place")."""
    x = desc.float()
    c = vocab.words.to(x.device)
    d2 = ((x * x).sum(-1, keepdim=True) - 2.0 * (x @ c.T)
          + (c * c).sum(1)[None, None, :])  # (F, M, K)
    onehot = torch.nn.functional.one_hot(d2.argmin(-1), c.shape[0]).to(torch.float32)
    onehot = onehot * mask.to(x.device)[..., None].to(torch.float32)
    counts = onehot.sum(1)  # (F, K)
    V = onehot.transpose(1, 2) @ x - counts[..., None] * c[None]  # (F, K, D)
    V = V / torch.clamp(torch.linalg.vector_norm(V, dim=-1, keepdim=True), min=1e-12)
    v = V.reshape(V.shape[0], -1)
    v = torch.sign(v) * torch.sqrt(torch.abs(v))
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(n > 1e-12, v / torch.clamp(n, min=1e-12), torch.zeros_like(v))


def vlad_encode(desc: torch.Tensor, mask: torch.Tensor, vocab: Vocabulary) -> torch.Tensor:
    """Encode one frame's (M, D) masked descriptor set -> (K*D,) VLAD."""
    return vlad_encode_batch(desc[None], mask[None], vocab)[0]


def retrieve(q: torch.Tensor, db: torch.Tensor, db_mask: torch.Tensor, topk: int = 5):
    """Score (Q, K*D) query VLADs against an (F, K*D) database: cosine
    similarity is the dot product (both sides unit-norm). Dead database
    rows score -inf. Returns (scores (Q, topk), ids (Q, topk)), ordered as
    ``lax.top_k`` orders them: ties to the lower index."""
    s = q @ db.T
    s = torch.where(db_mask[None, :], s, -torch.inf)
    vals, ids = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :topk], ids[:, :topk]
