"""Descriptor matching: distance matrix, top-2, Lowe ratio, cross-check.

Port of ``fastmatch_tpu/matching/matcher.py``. ``match_pair_plain`` mirrors
``match_pair_jnp`` op for op and is the parity anchor of the port;
``match_pair`` dispatches by device: on ``cuda`` to the fused kernel
(``kernels/distance_topk.py``), on ``cpu`` to the plain version.
``match_batch`` matches B pairs at once: banks of up to ``MAX_RESIDENT_M``
rows go to the batched kernel (``kernels/batch_match.py``), larger ones to a
loop of ``match_pair``, the JAX package's dispatch rule.

Conventions: distances are squared L2; the ratio test is
``d1 < ratio^2 * d2`` with a real second neighbour required (``d2 < BIG``);
masked entries carry the finite ``BIG`` (never ``inf``); ties break toward
the lower index.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from fastmatch_tpu_torch.core.containers import Descriptors, Matches
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.utils.guards import maybe_checked

# Large-but-finite stand-in for +inf, exactly representable in f32 (the JAX
# package's value: inf - inf would poison the ratio test).
BIG = float(np.float32(3.0e38))

# The JAX package's backend names and the port's routes they name: a config
# carried across keeps its name (and its config_hash) and its meaning.
BACKEND_ALIASES = {"jnp": "plain", "pallas": "kernel"}


def ratio_sq(ratio: float) -> float:
    """ratio^2 rounded as float32 arithmetic rounds it, as a host scalar: a
    device scalar built from the host would cost a synchronizing copy."""
    return float(np.float32(ratio) * np.float32(ratio))


def resolve_backend(backend: str, dev: torch.device) -> str:
    """"plain" or "kernel" for a backend name of either package ("auto":
    the kernel on cuda, the plain version on cpu)."""
    backend = BACKEND_ALIASES.get(backend, backend)
    if backend == "auto":
        backend = "kernel" if dev.type == "cuda" else "plain"
    if backend not in ("plain", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def match_pair_plain(desc_a: Descriptors, desc_b: Descriptors, ratio: float = 0.8,
                     cross_check: bool = True) -> Matches:
    """Reference matcher, op for op ``match_pair_jnp``: rows ordered by
    ``-2 a.b + |b|^2(masked)``, columns by ``-2 a.b + |a|^2(masked)``;
    |a|^2 is added only when materializing distances."""
    a = desc_a.data.float()
    b = desc_b.data.float()
    a2 = (a * a).sum(-1)
    b2 = (b * b).sum(-1)
    a2m = torch.where(desc_a.mask, a2, BIG)
    b2m = torch.where(desc_b.mask, b2, BIG)
    neg2 = -2.0 * (a @ b.T)
    srow = neg2 + b2m[None, :]
    # lax.top_k(-srow, 2): the two smallest, ties to the lower index. argmin
    # returns the first minimum; the runner-up is the minimum of the rest.
    idx1 = srow.argmin(dim=1)
    s1 = srow.gather(1, idx1[:, None])[:, 0]
    s2 = srow.scatter_(1, idx1[:, None], torch.inf).min(dim=1).values
    d1 = torch.clamp(s1 + a2, min=0.0)
    d2nd = torch.clamp(s2 + a2, min=0.0)
    ok = desc_a.mask & (d1 < ratio_sq(ratio) * d2nd) & (d2nd < BIG)
    if cross_check:
        scol = neg2 + a2m[:, None]
        cm = scol.min(dim=0, keepdim=True).values
        row = torch.arange(a.shape[0], device=a.device)[:, None]
        nn_b = torch.where(scol == cm, row, a.shape[0]).min(dim=0).values
        mutual = nn_b[idx1] == torch.arange(a.shape[0], device=a.device)
        ok = ok & mutual
    return Matches(idx=idx1.to(torch.int32), dist=torch.where(ok, d1, BIG), valid=ok)


def match_pair(desc_a: Descriptors, desc_b: Descriptors, ratio: float = 0.8,
               cross_check: bool = True, backend: str = "auto",
               precision: str = "exact", device=None) -> Matches:
    """Match one descriptor set against another on ``device`` (``cuda``
    unless ``device="cpu"``).

    backend: "auto" (the fused kernel on cuda, the plain version on cpu),
    "plain" (or the JAX package's "jnp"), or "kernel" (or "pallas": the
    kernel wrapper, which takes its own plain version on a CPU tensor).
    precision (kernel backend only): "exact" or "fast" (bf16 inputs, fp32
    accumulation).
    """
    dev = resolve_device(device)
    desc_a, desc_b = _to(desc_a, dev), _to(desc_b, dev)
    if resolve_backend(backend, dev) == "plain":
        fn = partial(match_pair_plain, ratio=ratio, cross_check=cross_check)
    else:
        from fastmatch_tpu_torch.kernels.distance_topk import match_pair_fused

        fn = partial(match_pair_fused, ratio=ratio, cross_check=cross_check,
                     precision=precision)
    # FASTMATCH_CHECKIFY=1 sweeps the matcher for NaNs and non-finite
    # outputs (utils/guards.py); free when unset.
    return maybe_checked(fn)(desc_a, desc_b)


def _to(desc: Descriptors, dev) -> Descriptors:
    return Descriptors(desc.data.to(dev), desc.mask.to(dev))


def stack_matches(ms) -> Matches:
    return Matches(*(torch.stack(f) for f in zip(*ms)))


def match_batch(desc_a: Descriptors, desc_b: Descriptors, ratio: float = 0.8,
                cross_check: bool = True, backend: str = "auto",
                precision: str = "exact", device=None) -> Matches:
    """Batched matcher: containers carry a leading batch axis (B, C, ...).

    backend: "auto" (the kernels on cuda, the plain version on cpu; the JAX
    package's default is its plain "jnp"), "plain" or "jnp" (a loop of
    ``match_pair_plain``), or "kernel" or "pallas": banks of at most ``MAX_RESIDENT_M``
    rows go to the batched kernel K1 in one launch, larger banks to a loop
    of ``match_pair`` on the per-pair kernel K2. precision (kernel backend
    only): "exact" or "fast" (bf16 operands, value-based mutual check in K1).
    """
    from fastmatch_tpu_torch.kernels.batch_match import MAX_RESIDENT_M, match_batch_fused

    if precision not in ("exact", "fast"):
        raise ValueError(f"precision must be 'exact' or 'fast', got {precision!r}")
    dev = resolve_device(device)
    desc_a, desc_b = _to(desc_a, dev), _to(desc_b, dev)
    backend = resolve_backend(backend, dev)
    if backend == "kernel" and desc_b.data.shape[-2] <= MAX_RESIDENT_M:
        return match_batch_fused(desc_a, desc_b, ratio=ratio, cross_check=cross_check,
                                 fast=precision == "fast")
    return stack_matches(
        match_pair(Descriptors(da, ma), Descriptors(db, mb), ratio=ratio,
                   cross_check=cross_check, backend=backend, precision=precision,
                   device=dev)
        for da, ma, db, mb in zip(desc_a.data, desc_a.mask, desc_b.data, desc_b.mask))
