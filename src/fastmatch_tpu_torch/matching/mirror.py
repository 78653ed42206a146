"""Mirror matching: reliable matches without the Lowe ratio test.

Port of ``fastmatch_tpu/matching/mirror.py`` (the Mirror Match line of
work, Arnfred & Winkler): a candidate a_i -> b_j is judged by a_i's
distinctiveness against the joint set ``(A \\ {a_i}) u B``:

- cross nearest neighbours both ways (squared L2, ties to the lower index);
- the mirror test ``d2(a_i, b_j) < tau^2 * self_a[i]``, with ``self_a[i]``
  a_i's nearest other live row of A (query-side distractors only: a
  gallery duplicate would zero its own self-distance and reintroduce the
  ratio test's failure on repeated structure);
- mutuality ``nn_ba[j] == i``.

Two Gram products and row minima, computed outside any kernel in the JAX
package too, so plain PyTorch here.
"""

from __future__ import annotations

import torch

from fastmatch_tpu_torch.core.containers import Descriptors, Matches
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.matching.matcher import BIG, ratio_sq


def squared_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) squared L2 distances, clamped at 0 (the JAX package's
    ``squared_distance_matrix``)."""
    a2 = (a * a).sum(-1)
    b2 = (b * b).sum(-1)
    return torch.clamp(a2[:, None] + b2[None, :] - 2.0 * (a @ b.T), min=0.0)


def _masked_self_min(d2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row minimum over live columns, the diagonal (self) excluded."""
    eye = torch.eye(d2.shape[0], dtype=torch.bool, device=d2.device)
    return torch.where(mask[None, :] & ~eye, d2, BIG).min(dim=1).values


def match_pair_mirror(desc_a: Descriptors, desc_b: Descriptors, tau: float = 1.0,
                      device=None) -> Matches:
    """Mirror matcher on ``device`` (``cuda`` unless ``device="cpu"``):
    mutual cross nearest neighbours gated by joint-set distinctiveness.
    ``tau`` scales the self-distance gate (1.0: strictly closer to the
    match than to anything else in A). Returns ``Matches``: ``idx[i]`` is
    a_i's match in B, ``dist`` the squared L2, ``valid`` the acceptance."""
    dev = resolve_device(device)
    a = desc_a.data.to(dev).float()
    b = desc_b.data.to(dev).float()
    ma, mb = desc_a.mask.to(dev), desc_b.mask.to(dev)
    d_ab = squared_distance_matrix(a, b)
    d_ab = torch.where(mb[None, :], d_ab, BIG)
    d_ab = torch.where(ma[:, None], d_ab, BIG)
    d1_ab, nn_ab = d_ab.min(dim=1)   # torch.min returns the first minimum's index
    nn_ba = d_ab.argmin(dim=0)
    self_a = _masked_self_min(squared_distance_matrix(a, a), ma)
    mutual = nn_ba[nn_ab] == torch.arange(a.shape[0], device=dev)
    ok = ma & mutual & (d1_ab < ratio_sq(tau) * self_a) & (d1_ab < BIG)
    return Matches(idx=nn_ab.to(torch.int32), dist=torch.where(ok, d1_ab, BIG), valid=ok)
