"""Keyframe retrieval DB and hierarchical localization (place recognition).

Port of ``fastmatch_tpu/pipeline/retrieval.py``: every keyframe of a built
map compresses to one VLAD vector (``matching/vlad.py``); a query view
retrieves candidate keyframes with one product, then matches only the
landmarks those keyframes observe (K2 on the card, on the bucket-padded
union) and solves the pose with the same RANSAC PnP as the flat localizer.

* Frame descriptor sets come from the map's observation table
  (``obs_cam``/``obs_pt`` -> ``pt_desc`` rows), so a DB builds from any
  saved map.
* The DB is encoded in slabs of ``slab`` frames (512 by default), not in
  one (F_cap, L, D) batch: the result is the same and the memory is one
  slab's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fastmatch_tpu_torch.core.camera import normalize_np
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.matching.matcher import match_pair
from fastmatch_tpu_torch.matching.vlad import (Vocabulary, retrieve, train_vocabulary,
                                               vlad_encode, vlad_encode_batch)
from fastmatch_tpu_torch.pipeline.localize import LocalizeResult, pnp_from_matches
from fastmatch_tpu_torch.pipeline.serve import _bucket

ENCODE_SLAB = 512


class KeyframeDB(NamedTuple):
    """Frame-granular retrieval index over a built map."""

    vocab: Vocabulary
    vlads: torch.Tensor       # (F_cap, K*D) unit VLAD per keyframe
    frame_mask: torch.Tensor  # (F_cap,) keyframe has >= min_obs observations
    frame_pts: np.ndarray     # (F_cap, L) landmark ids per frame, -1 padded
    frame_npts: np.ndarray    # (F_cap,) live count per row of frame_pts


def frame_landmarks(rec):
    """(frame_pts (F_cap, L) -1 padded, counts (F_cap,)) of a map's
    observation table, each frame's landmarks in table order."""
    f_cap = rec.pose_mask.shape[0]
    obs_ok = np.asarray(rec.obs_mask, bool)
    cams = np.asarray(rec.obs_cam, np.int64)[obs_ok]
    pts = np.asarray(rec.obs_pt, np.int64)[obs_ok]
    counts = np.bincount(cams, minlength=f_cap)
    L = max(int(counts.max()) if counts.size else 1, 1)
    order = np.argsort(cams, kind="stable")
    cs, ps = cams[order], pts[order]
    starts = np.zeros(f_cap + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    frame_pts = np.full((f_cap, L), -1, np.int64)
    col = np.arange(cs.size) - starts[cs]
    frame_pts[cs, col] = ps
    return frame_pts, counts.astype(np.int32)


def build_keyframe_db(rec, n_words: int = 64, vocab_sample: int = 16384, min_obs: int = 8,
                      seed: int = 0, vocab: Vocabulary | None = None, slab: int = ENCODE_SLAB,
                      device=None) -> KeyframeDB:
    """A KeyframeDB of a map (a Reconstruction or ``map_from_checkpoint``'s
    record: pt_desc, pt_mask, obs_cam, obs_pt, obs_mask, pose_mask) on
    ``device``. ``vocab`` reuses a codebook instead of training one; the
    training sample is the JAX package's (numpy, ``seed``) and the k-means
    draws come from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    frame_pts, frame_npts = frame_landmarks(rec)
    frame_mask = frame_npts >= min_obs
    bank = np.asarray(rec.pt_desc, np.float32)
    if vocab is None:
        idx = np.flatnonzero(np.asarray(rec.pt_mask, bool))
        if idx.size > vocab_sample:
            idx = np.random.default_rng(seed).choice(idx, size=vocab_sample, replace=False)
        sample = bank[idx]
        vocab = train_vocabulary(sample, np.ones(sample.shape[0], bool), n_words=n_words,
                                 generator=torch.Generator(dev).manual_seed(seed), device=dev)
    bank_t = torch.from_numpy(bank).to(dev)
    fp = torch.from_numpy(frame_pts).to(dev)
    parts = []
    for s in range(0, fp.shape[0], slab):
        rows = fp[s:s + slab]
        desc = bank_t[rows.clamp(0, bank.shape[0] - 1)]
        parts.append(vlad_encode_batch(desc, rows >= 0, vocab))
    fmask = torch.from_numpy(frame_mask).to(dev)
    vlads = torch.where(fmask[:, None], torch.cat(parts), 0.0)
    return KeyframeDB(vocab=vocab, vlads=vlads, frame_mask=fmask, frame_pts=frame_pts,
                      frame_npts=frame_npts)


def query_frames(db: KeyframeDB, desc, mask, topk: int = 5):
    """The top-k keyframes of one query view: (scores (topk,), frame ids
    (topk,)); dead DB rows score -inf."""
    dev = db.vlads.device
    q = vlad_encode(torch.as_tensor(np.asarray(desc, np.float32)).to(dev),
                    torch.as_tensor(np.asarray(mask, bool)).to(dev), db.vocab)
    s, ids = retrieve(q[None], db.vlads, db.frame_mask, topk=topk)
    return s[0], ids[0]


def candidate_bank(rec, db: KeyframeDB, ids: np.ndarray):
    """(landmark ids, bank (cap, D), mask, points (cap, 3)) of the union of
    the landmarks observed by keyframes ``ids``, padded to a power-of-two
    bucket."""
    cand = np.unique(db.frame_pts[ids][db.frame_pts[ids] >= 0])
    cap = _bucket(max(cand.size, 1))
    bank = np.zeros((cap, rec.pt_desc.shape[1]), np.float32)
    bmask = np.zeros(cap, bool)
    pts3 = np.zeros((cap, 3), np.float32)
    if cand.size:
        bank[:cand.size] = np.asarray(rec.pt_desc, np.float32)[cand]
        bmask[:cand.size] = np.asarray(rec.pt_mask, bool)[cand]
        pts3[:cand.size] = np.asarray(rec.points, np.float32)[cand]
    return cand, bank, bmask, pts3


def localize_hierarchical_normalized(rec, db: KeyframeDB, xn: np.ndarray, desc: np.ndarray,
                                     mask: np.ndarray, thr_n: float, topk: int = 4,
                                     ratio: float = 0.8, n_hyp: int = 512,
                                     min_inliers: int = 12, seed: int = 0) -> LocalizeResult:
    """``localize_hierarchical`` on normalized image coordinates ``xn``
    (``thr_n`` a squared normalized-plane threshold): the entry map merging
    uses, since observation tables store normalized coordinates."""
    dev = db.vlads.device
    _, ids = query_frames(db, desc, mask, topk=topk)
    _, bank, bmask, pts3 = candidate_bank(rec, db, ids.cpu().numpy())
    q = Descriptors(torch.from_numpy(np.asarray(desc, np.float32)).to(dev),
                    torch.from_numpy(np.asarray(mask, bool)).to(dev))
    m = match_pair(q, Descriptors(torch.from_numpy(bank).to(dev), torch.from_numpy(bmask).to(dev)),
                   ratio=ratio, cross_check=False, device=dev)
    return pnp_from_matches(torch.from_numpy(pts3).to(dev), m, xn,
                            float(np.float32(thr_n)), n_hyp, min_inliers, seed)


def localize_hierarchical(rec, db: KeyframeDB, xy: np.ndarray, desc: np.ndarray,
                          mask: np.ndarray, camera, topk: int = 4, thr_px: float = 2.0,
                          ratio: float = 0.8, n_hyp: int = 512, min_inliers: int = 12,
                          seed: int = 0) -> LocalizeResult:
    """Retrieve the top-k keyframes, match their landmark union, RANSAC PnP."""
    xn = normalize_np(np.asarray(xy, np.float32), camera).astype(np.float32)
    thr_n = (thr_px / float(camera.fx)) ** 2
    return localize_hierarchical_normalized(rec, db, xn, desc, mask, thr_n, topk=topk,
                                            ratio=ratio, n_hyp=n_hyp, min_inliers=min_inliers,
                                            seed=seed)


def map_from_checkpoint(path: str):
    """A ``checkpoint.save_map`` directory as the record that
    ``build_keyframe_db`` and ``localize_hierarchical`` read."""
    from types import SimpleNamespace

    from fastmatch_tpu_torch.pipeline.checkpoint import load_map_arrays

    tree = load_map_arrays(path)
    return SimpleNamespace(**{k: tree[k] for k in (
        "points", "pt_mask", "pt_desc", "obs_cam", "obs_pt", "obs_mask", "pose_mask")})
