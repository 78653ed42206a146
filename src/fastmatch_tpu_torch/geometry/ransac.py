"""Batched-hypothesis RANSAC for the essential matrix (8- or 5-point solver).

Port of ``fastmatch_tpu/geometry/ransac.py``. Each estimator is split into
sampling (``_sample_minimal_sets``, Gumbel top-k from a ``torch.Generator``)
and a private ``*_from_samples`` function that takes the (K, s) indices, so
tests can feed the port the indices JAX drew and expect JAX's result.
``solver="5pt"`` scores the up to 32 candidates of each 5-point sample
(``geometry/five_point.py``) as one batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.geometry.epipolar import (
    decompose_essential,
    eight_point_essential,
    sampson_error,
    triangulate_midpoint,
)


class RansacResult(NamedTuple):
    R: torch.Tensor          # (3, 3) relative rotation (x2 = R x1 + t)
    t: torch.Tensor          # (3,) unit translation
    E: torch.Tensor          # (3, 3) refined essential
    inliers: torch.Tensor    # (P,) bool
    n_inliers: torch.Tensor  # scalar int
    ok: torch.Tensor         # scalar bool


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor without reading it back (indexing
    with a 0-dim tensor converts it to a Python int)."""
    return x.index_select(0, i.reshape(1))[0]


def argmax_first(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """argmax with the lowest index among equal maxima (jnp.argmax's rule)."""
    mx = x.max(dim=dim, keepdim=True).values
    ar = torch.arange(x.shape[dim], device=x.device)
    shape = [1] * x.dim()
    shape[dim] = -1
    return torch.where(x == mx, ar.view(shape), x.shape[dim]).min(dim=dim).values


def _sample_minimal_sets(generator: torch.Generator, mask: torch.Tensor,
                         n_hyp: int, sample_size: int) -> torch.Tensor:
    """(n_hyp, sample_size) indices drawn without replacement from valid
    entries: Gumbel noise on the masked scores, then top-k."""
    p = mask.shape[0]
    u = torch.rand((n_hyp, p), generator=generator, device=mask.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    g = torch.where(mask[None, :], g, -torch.inf)
    return torch.topk(g, sample_size, dim=1).indices


def _ransac_essential_from_samples(idx, x1, x2, mask, thr, min_inliers):
    """The rest of ``ransac_essential`` from (K, 8) or (K, 5) sample
    indices: the sample size picks the solver."""
    if idx.shape[-1] == 5:
        from fastmatch_tpu_torch.geometry.five_point import five_point_essential

        Es, cand_ok = five_point_essential(x1[idx], x2[idx])
        Es, cand_ok = Es.reshape(-1, 3, 3), cand_ok.reshape(-1)
    else:
        Es = eight_point_essential(x1[idx], x2[idx])
        cand_ok = torch.ones(Es.shape[0], dtype=torch.bool, device=Es.device)
    inl = (sampson_error(Es, x1[None], x2[None]) < thr) & mask[None, :] & cand_ok[:, None]
    counts = inl.sum(1)
    best = argmax_first(counts)
    E, inliers = take(Es, best), take(inl, best)
    # Iterated weighted 8-point refit, kept only when support does not drop.
    for _ in range(3):
        E1 = eight_point_essential(x1, x2, w=inliers.float())
        inl1 = (sampson_error(E1, x1, x2) < thr) & mask
        better = inl1.sum() >= inliers.sum()
        E = torch.where(better, E1, E)
        inliers = torch.where(better, inl1, inliers)
    Rs, ts = decompose_essential(E)
    d1, d2 = triangulate_midpoint(Rs, ts, x1[None], x2[None])
    votes = ((d1 > 0) & (d2 > 0) & inliers[None, :]).sum(1)
    b = argmax_first(votes)
    n_in = inliers.sum()
    return RansacResult(R=take(Rs, b), t=take(ts, b), E=E, inliers=inliers, n_inliers=n_in,
                        ok=(n_in >= min_inliers)
                        & (take(votes, b) > 0.6 * torch.clamp(n_in, min=1)))


def ransac_essential(x1, x2, mask, thr: float = 1e-4, n_hyp: int = 512,
                     min_inliers: int = 15, generator: torch.Generator | None = None,
                     device=None, solver: str = "8pt") -> RansacResult:
    """Relative pose from normalized correspondences x1, x2 (P, 2) with
    validity mask (P,) on ``device`` (``cuda`` unless ``device="cpu"``).
    ``thr`` is the squared Sampson threshold in normalized units.
    ``solver``: "8pt" or "5pt" (the minimal sample: n_hyp samples of up to
    32 candidates each, for low inlier ratios)."""
    if solver not in ("8pt", "5pt"):
        raise ValueError(f"unknown solver {solver!r}")
    sample = 5 if solver == "5pt" else 8
    dev = resolve_device(device)
    x1, x2, mask = x1.to(dev), x2.to(dev), mask.to(dev)
    p_count = mask.shape[0]
    if p_count < sample:
        return RansacResult(
            R=torch.eye(3, device=dev), t=torch.zeros(3, device=dev),
            E=torch.zeros((3, 3), device=dev),
            inliers=torch.zeros(p_count, dtype=torch.bool, device=dev),
            n_inliers=torch.tensor(0, device=dev),
            ok=torch.tensor(False, device=dev))
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    idx = _sample_minimal_sets(generator, mask, n_hyp, sample)
    return _ransac_essential_from_samples(idx, x1, x2, mask, thr, min_inliers)
