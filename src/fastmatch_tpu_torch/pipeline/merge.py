"""Multi-session map merging: align two maps into one reconstruction.

Port of ``fastmatch_tpu/pipeline/merge.py``:

1. **Cross-localization.** Each of map B's keyframes is localized against
   map A through the hierarchical retrieval stack (``pipeline/
   retrieval.py``: VLAD retrieval, K2 on the retrieved keyframes' landmark
   union, RANSAC PnP), on normalized coordinates.
2. **Gauge alignment.** The localized frames give B's camera centres in
   A's world; a trimmed Umeyama fit (``georegister.trimmed_umeyama``)
   recovers the Sim(3) B -> A and ``apply_sim3`` moves all of B.
3. **Landmark dedup.** B's landmark bank is matched against A's (ratio and
   mutual check: K2 at bank-by-bank size); pairs within a 3D gate merge,
   B's observations re-pointing at A's landmark. The rest are appended.
4. **Joint BA** (``refine=True``, K4 and K5) over the merged map.

The merged map lives in A's frame with A's camera; both sessions share
intrinsics. CLI: ``merge <map A> <map B> --out DIR --focal F``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.matching.matcher import match_pair
from fastmatch_tpu_torch.pipeline.georegister import apply_sim3, trimmed_umeyama
from fastmatch_tpu_torch.pipeline.retrieval import (KeyframeDB, build_keyframe_db,
                                                    localize_hierarchical_normalized)
from fastmatch_tpu_torch.pipeline.serve import _bucket


def _frame_obs(rec, f: int):
    """Frame f's observations: (normalized uv, landmark descriptors)."""
    sel = np.asarray(rec.obs_mask, bool) & (np.asarray(rec.obs_cam) == f)
    pts = np.asarray(rec.obs_pt, np.int64)[sel]
    return np.asarray(rec.obs_uv, np.float32)[sel], np.asarray(rec.pt_desc, np.float32)[pts]


def localize_frames(rec_a, db: KeyframeDB, rec_b, frames, thr_n: float, topk: int = 4,
                    min_inliers: int = 12, seed: int = 0):
    """Localize map B's ``frames`` against map A. Returns (ok (F,), R (F, 3,
    3), t (F, 3), n_inliers (F,)) in A's world; frame k draws with seed
    ``seed + k``."""
    ok = np.zeros(len(frames), bool)
    Rs = np.zeros((len(frames), 3, 3), np.float32)
    ts = np.zeros((len(frames), 3), np.float32)
    ninl = np.zeros(len(frames), np.int32)
    for k, f in enumerate(frames):
        uv, desc = _frame_obs(rec_b, f)
        if uv.shape[0] < min_inliers:
            continue
        cap = _bucket(uv.shape[0], floor=256)
        xn = np.zeros((cap, 2), np.float32)
        dq = np.zeros((cap, desc.shape[1]), np.float32)
        mq = np.zeros(cap, bool)
        xn[:uv.shape[0]] = uv
        dq[:desc.shape[0]] = desc
        mq[:uv.shape[0]] = True
        r = localize_hierarchical_normalized(rec_a, db, xn, dq, mq, thr_n, topk=topk,
                                             min_inliers=min_inliers, seed=seed + k)
        v = torch.cat([r.ok.reshape(1).double(), r.n_inliers.reshape(1).double(),
                       r.R.reshape(-1).double(), r.t.double()]).cpu().numpy()
        ok[k] = bool(v[0])
        if ok[k]:
            ninl[k] = int(v[1])
            Rs[k] = v[2:11].reshape(3, 3)
            ts[k] = v[11:14]
    return ok, Rs, ts, ninl


def _padded(desc, mask, cap, dev) -> Descriptors:
    d = np.zeros((cap, desc.shape[1]), np.float32)
    m = np.zeros(cap, bool)
    d[:desc.shape[0]] = desc
    m[:mask.shape[0]] = mask
    return Descriptors(torch.from_numpy(d).to(dev), torch.from_numpy(m).to(dev))


def merge_maps(rec_a, rec_b, thr_px: float = 2.0, topk: int = 4, stride: int = 1,
               min_localized: int = 3, min_inliers: int = 12, n_words: int = 64,
               dedup_ratio: float = 0.8, dedup_thr: float | None = None, refine: bool = True,
               seed: int = 0):
    """Merge map B into map A's frame, on ``rec_a.device``. Returns
    (merged, summary dict).

    ``dedup_thr``: the largest 3D distance (A's units) at which two
    mutually matched landmarks merge; None takes the JAX package's default,
    2% of A's landmark-cloud diameter. Raises ValueError when fewer than
    ``min_localized`` of B's sampled frames localize in A."""
    from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction

    dev = rec_a.device
    thr_n = (thr_px / float(rec_a.camera.fx)) ** 2
    db = build_keyframe_db(rec_a, n_words=n_words, seed=seed, device=dev)
    frames = [f for f in range(0, rec_b.n_frames, stride) if rec_b.pose_mask[f]]
    ok, Rw, tw, _ = localize_frames(rec_a, db, rec_b, frames, thr_n, topk=topk,
                                    min_inliers=min_inliers, seed=seed)
    n_loc = int(ok.sum())
    if n_loc < min_localized:
        raise ValueError(f"maps do not overlap: only {n_loc}/{len(frames)} of B's frames "
                         f"localized in A (need {min_localized})")

    # Trimmed Umeyama Sim(3) from B-gauge centres to their A-gauge centres.
    fb = np.asarray(frames)[ok]
    Cb = -np.einsum("fji,fj->fi", rec_b.R[fb], rec_b.t[fb])
    Ca = -np.einsum("fji,fj->fi", Rw[ok], tw[ok])
    s, Rs3, ts3, aligned, mask = trimmed_umeyama(Cb, Ca)
    align_rmse = float(np.sqrt(np.mean(np.sum((aligned[mask] - Ca[mask]) ** 2, -1))))
    b = copy.deepcopy(rec_b)
    apply_sim3(b, s, Rs3, ts3)

    # Landmark dedup: mutual descriptor match (K2, bank by bank) + 3D gate.
    if dedup_thr is None:
        pa = rec_a.points[rec_a.pt_mask]
        dedup_thr = 0.02 * float(np.linalg.norm(pa.max(0) - pa.min(0))) if pa.shape[0] else 0.0
    nb = b.pt_desc.shape[0]
    mm = match_pair(_padded(b.pt_desc, b.pt_mask, _bucket(nb), dev),
                    _padded(rec_a.pt_desc, rec_a.pt_mask, _bucket(rec_a.pt_desc.shape[0]), dev),
                    ratio=dedup_ratio, cross_check=True, device=dev)
    mvalid = mm.valid.cpu().numpy()[:nb]
    midx = mm.idx.cpu().numpy()[:nb].astype(np.int64)
    pmap = np.full(nb, -1, np.int64)  # B id -> A id
    cand = np.flatnonzero(mvalid & b.pt_mask)
    if cand.size:
        d3 = np.linalg.norm(b.points[cand] - rec_a.points[midx[cand]], axis=-1)
        hit = cand[d3 <= dedup_thr]
        pmap[hit] = midx[hit]
    n_dedup = int((pmap >= 0).sum())

    # The merged reconstruction: A's config family, summed capacities, A's camera.
    nA_f, nB_f, nA_p = rec_a.n_frames, b.n_frames, rec_a.n_points
    new_b = np.flatnonzero((pmap < 0) & b.pt_mask[:nb])
    mcfg = dataclasses.replace(rec_a.cfg.map, max_frames=nA_f + nB_f,
                               max_points=nA_p + int(new_b.size),
                               max_obs=int(rec_a.n_obs + int(b.obs_mask.sum())))
    merged = Reconstruction(cfg=dataclasses.replace(rec_a.cfg, map=mcfg), camera=rec_a.camera,
                            device=dev)
    # A verbatim.
    merged.R[:nA_f] = rec_a.R[:nA_f]
    merged.t[:nA_f] = rec_a.t[:nA_f]
    merged.pose_mask[:nA_f] = rec_a.pose_mask[:nA_f]
    merged.points[:nA_p] = rec_a.points[:nA_p]
    merged.pt_mask[:nA_p] = rec_a.pt_mask[:nA_p]
    merged.pt_desc[:nA_p] = rec_a.pt_desc[:nA_p]
    merged.n_points = nA_p
    a_obs = np.flatnonzero(rec_a.obs_mask)
    merged.obs_cam[:a_obs.size] = rec_a.obs_cam[a_obs]
    merged.obs_pt[:a_obs.size] = rec_a.obs_pt[a_obs]
    merged.obs_uv[:a_obs.size] = rec_a.obs_uv[a_obs]
    merged.obs_mask[:a_obs.size] = True
    merged.n_obs = a_obs.size
    # B's frames, offset.
    merged.R[nA_f:nA_f + nB_f] = b.R[:nB_f]
    merged.t[nA_f:nA_f + nB_f] = b.t[:nB_f]
    merged.pose_mask[nA_f:nA_f + nB_f] = b.pose_mask[:nB_f]
    merged.n_frames = nA_f + nB_f
    # B's surviving landmarks; pmap gains the appended ids.
    pmap[new_b] = merged.add_points(b.points[new_b], b.pt_desc[new_b])
    # B's observations, remapped (frames offset, landmarks through pmap).
    b_obs = np.flatnonzero(b.obs_mask)
    b_obs = b_obs[pmap[b.obs_pt[b_obs]] >= 0]
    for f in range(nB_f):
        sel = b_obs[b.obs_cam[b_obs] == f]
        if sel.size:
            merged.add_observations(nA_f + f, pmap[b.obs_pt[sel]], b.obs_uv[sel])

    summary = {"n_localized": n_loc, "of": len(frames), "scale": float(s),
               "align_rmse": align_rmse, "n_dedup": n_dedup, "n_new_points": int(new_b.size),
               "dedup_thr": float(dedup_thr)}
    if refine:
        c0, c1 = merged.run_ba()
        summary["ba_cost"] = [c0, c1]
    return merged, summary


def rec_from_checkpoint(path: str, camera, device=None):
    """A ``checkpoint.save_map`` directory as a full Reconstruction on
    ``device``, its capacities sized from the saved arrays; the config hash
    is not enforced (a merge legitimately crosses sessions and configs)."""
    from fastmatch_tpu_torch.core.device import resolve_device
    from fastmatch_tpu_torch.pipeline.checkpoint import load_map_arrays, restore_map
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction

    tree = load_map_arrays(path)
    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, max_frames=int(tree["pose_mask"].shape[0]),
        max_points=int(tree["pt_mask"].shape[0]), max_obs=int(tree["obs_mask"].shape[0]),
        desc_dim=int(tree["pt_desc"].shape[1])))
    rec = Reconstruction(cfg=cfg, camera=camera, device=resolve_device(device))
    return restore_map(rec, path, strict_config=False)
