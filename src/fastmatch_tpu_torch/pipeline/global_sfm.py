"""Global SfM: averaging instead of incremental chaining, on PyTorch.

Port of ``fastmatch_tpu/pipeline/global_sfm.py``, the second
reconstruction family beside ``pipeline/reconstruct.py``: estimate every
rotation at once from pairwise relative rotations, then every camera centre
from pairwise translation directions, then triangulate whole tracks in one
multiview DLT batch and run one global bundle adjustment. No drift
accumulates (loop edges constrain the solution from the start), but the
whole sequence is needed up front.

Stages (``Reconstruction.stage_seconds``):
  sift         detection, with ``images=`` (K3, one launch a frame),
  match        pairwise matching over a window of frame pairs (K2 a pair),
  ransac       per-pair essential RANSAC -> view-graph edges,
  tracks       union-find over the pairwise inlier matches (host),
  averaging    rotation averaging -> edge filter -> translation averaging
               (``geometry/averaging.py``; every sum through K4),
  triangulate  one (F, T) DLT batch, then a reprojection gate (host),
  ba           one global BA with camera 0 fixed (K4, K5).

Randomness: one CPU generator seeded with ``seed`` hands each RANSAC call
a fresh generator on the run's device (``reconstruct._Run.split``); the two
packages' draws differ, so only the outcomes of a run are comparable.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fastmatch_tpu_torch.core.camera import Pinhole, normalize_np
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.geometry.averaging import (
    ViewGraph,
    edge_keys,
    filter_edges_by_rotation,
    rotation_averaging,
    spanning_tree_rotations,
    translation_averaging,
)
from fastmatch_tpu_torch.geometry.ransac import ransac_essential
from fastmatch_tpu_torch.geometry.triangulation import triangulate_dlt
from fastmatch_tpu_torch.pipeline.config import PipelineConfig
from fastmatch_tpu_torch.pipeline.reconstruct import (
    Reconstruction,
    _match,
    _Run,
    detect_features,
)

# Global SfM's stages beside reconstruct's in ``stage_seconds``.
GLOBAL_STAGES = ("sift", "match", "ransac", "tracks", "averaging", "triangulate", "ba")


class _UnionFind:
    """Plain array union-find for track building."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, a: int) -> int:
        p = self.parent
        root = a
        while p[root] != root:
            root = p[root]
        while p[a] != root:          # path compression
            p[a], a = root, p[a]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_view_graph(features: list, camera: Pinhole, cfg: PipelineConfig, run: _Run,
                     window: int = 8, min_inliers: int = 24):
    """Match and RANSAC every frame pair within ``window`` on ``run``'s
    device; returns (ViewGraph, pair_matches) where pair_matches[(i, j)] is
    the (K, 2) int array of inlier keypoint index pairs used for track
    building. RANSAC sees the live matches only (no bucket padding: eager
    PyTorch has no per-shape compile)."""
    F = len(features)
    thr_n = (cfg.ransac.thr_px / float(camera.fx)) ** 2
    for stage in ("match", "ransac"):
        run.rec.stage_seconds.setdefault(stage, 0.0)
    ei, ej, R_ij, t_ij, weight = [], [], [], [], []
    pair_matches = {}
    for i in range(F):
        xy_i, d_i, m_i = features[i]
        for j in range(i + 1, min(i + 1 + window, F)):
            xy_j, d_j, m_j = features[j]
            valid, idx, _ = _match(run, d_i, m_i, d_j, m_j, cfg)
            q = np.where(valid)[0]
            if len(q) < 8:
                continue
            t0 = time.perf_counter()
            x1 = normalize_np(xy_i[q], camera).astype(np.float32)
            # The matched keypoint of frame j, not the q-th one.
            x2 = normalize_np(xy_j[idx[q]], camera).astype(np.float32)
            res = ransac_essential(
                run.tensor(x1), run.tensor(x2), run.tensor(np.ones(len(q), bool)),
                thr=thr_n, n_hyp=cfg.ransac.n_hyp,
                min_inliers=max(min_inliers, cfg.ransac.min_inliers),
                generator=run.split(), device=run.device)
            ok, n_in = torch.stack([res.ok.to(torch.int64), res.n_inliers.to(torch.int64)]).tolist()
            if not ok or n_in < min_inliers:
                run.stage("ransac", t0)
                continue
            inl = res.inliers.cpu().numpy()
            ei.append(i)
            ej.append(j)
            R_ij.append(res.R.cpu().numpy())
            t_ij.append(res.t.cpu().numpy())
            weight.append(float(n_in))
            pair_matches[(i, j)] = np.stack([q[inl], idx[q][inl]], axis=1).astype(np.int64)
            run.stage("ransac", t0)
    E = len(ei)
    if E == 0:
        raise RuntimeError("view graph is empty: no pair had enough inliers")
    g = ViewGraph(
        edge_i=run.tensor(np.asarray(ei, np.int32)),
        edge_j=run.tensor(np.asarray(ej, np.int32)),
        R_ij=run.tensor(np.stack(R_ij).astype(np.float32)),
        t_ij=run.tensor(np.stack(t_ij).astype(np.float32)),
        weight=run.tensor(np.asarray(weight, np.float32)),
        mask=run.tensor(np.ones(E, bool)),
    )
    return g, pair_matches


def build_tracks(pair_matches: dict, n_kps: list, min_len: int = 2,
                 max_tracks: int | None = None):
    """Union-find over pairwise inlier matches -> tracks.

    n_kps[f] = keypoint capacity of frame f. Returns (track_frame,
    track_kp, track_id, n_tracks): parallel int arrays, one row per
    observation, tracks sorted by length (longest first). A track
    contributes at most one observation per frame (the first seen wins: a
    same-frame collision means one of the merges was wrong).
    """
    offs = np.cumsum([0] + list(n_kps))
    uf = _UnionFind(int(offs[-1]))
    for (i, j), m in pair_matches.items():
        a = offs[i] + m[:, 0]
        b = offs[j] + m[:, 1]
        for x, y in zip(a, b):
            uf.union(int(x), int(y))
    obs_f, obs_k, obs_t = [], [], []
    members: dict[int, dict] = {}
    for (i, j), m in pair_matches.items():
        for row in m:
            for f, k in ((i, int(row[0])), (j, int(row[1]))):
                gid = int(offs[f] + k)
                members.setdefault(uf.find(gid), {})[gid] = (f, k)
    tracks = [list(mem.values()) for mem in members.values() if len(mem) >= min_len]
    tracks.sort(key=len, reverse=True)
    if max_tracks is not None:
        tracks = tracks[:max_tracks]
    for tid, tr in enumerate(tracks):
        seen_frames = set()
        for f, k in tr:
            if f in seen_frames:
                continue
            seen_frames.add(f)
            obs_f.append(f)
            obs_k.append(k)
            obs_t.append(tid)
    return (np.asarray(obs_f, np.int32), np.asarray(obs_k, np.int32),
            np.asarray(obs_t, np.int32), len(tracks))


def global_reconstruct(
    features: list,
    camera: Pinhole,
    cfg: PipelineConfig = PipelineConfig(),
    images=None,
    window: int = 8,
    min_inliers: int = 24,
    seed: int = 0,
    rot_iters: int = 15,
    trans_irls_iters: int = 5,
    metrics=None,
    device=None,
) -> Reconstruction:
    """Run global SfM over a sequence on ``device`` (``cuda`` unless
    ``device="cpu"``); returns a Reconstruction.

    features: list of (xy_px (N, 2), desc (N, D), mask (N,)) per frame, or
    None with ``images`` given (detection then runs here). ``window``:
    match each frame against the next ``window`` frames; the view graph
    must stay parallel-rigid, so keep it >= 4. metrics: optional
    ``utils.metrics.MetricsLogger``, given the JAX package's events
    ("view_graph", "global_ba").
    """
    dev = resolve_device(device)
    rec = Reconstruction(cfg=cfg, camera=camera, device=dev)
    rec.stage_seconds = dict.fromkeys(GLOBAL_STAGES, 0.0)
    if features is None:
        features = detect_features(images, cfg, dev, rec.stage_seconds)
    F = len(features)
    if F > rec.pose_mask.shape[0]:
        raise RuntimeError("sequence longer than map.max_frames")
    run = _Run(rec, seed)

    # 1-2. view graph
    g, pair_matches = build_view_graph(features, camera, cfg, run, window=window,
                                       min_inliers=min_inliers)
    n_edges = len(pair_matches)

    # 3. tracks
    t0 = time.perf_counter()
    obs_f, obs_k, obs_t, n_tracks = build_tracks(
        pair_matches, [f[0].shape[0] for f in features], max_tracks=cfg.map.max_points)
    run.stage("tracks", t0)
    if metrics is not None:
        metrics.log("view_graph", edges=n_edges, tracks=n_tracks, obs=len(obs_f))

    # 4. averaging: one key set for every edge sum of both solves.
    t0 = time.perf_counter()
    keys = edge_keys(g, F)
    R0 = spanning_tree_rotations(g.edge_i, g.edge_j, g.R_ij, g.weight, g.mask, F)
    R = rotation_averaging(g, F, run.tensor(R0), iters=rot_iters, keys=keys)
    gf = filter_edges_by_rotation(g, R)
    # Never filter below a spanning tree: if the filter ate too much
    # (wrong-but-consistent subgraphs), fall back to the unfiltered graph.
    if int(gf.mask.sum()) < F - 1:
        gf = g
    C = translation_averaging(gf, R, F, irls_iters=trans_irls_iters, keys=keys)
    R_np = R.cpu().numpy()
    t_np = -np.einsum("fab,fb->fa", R_np, C.cpu().numpy())
    run.stage("averaging", t0)

    # 5. triangulate all tracks in one (F, T) DLT batch
    t0 = time.perf_counter()
    uv_kp = [normalize_np(f[0], camera).astype(np.float32) for f in features]
    uv_grid = np.zeros((F, n_tracks, 2), np.float32)
    vis = np.zeros((F, n_tracks), bool)
    for f, k, t in zip(obs_f, obs_k, obs_t):
        uv_grid[f, t] = uv_kp[f][k]
        vis[f, t] = True
    pts, ok = triangulate_dlt(run.tensor(R_np), run.tensor(t_np), run.tensor(uv_grid),
                              run.tensor(vis))
    pts, ok = pts.cpu().numpy(), ok.cpu().numpy()
    # Reprojection + cheirality gate per observation; drop tracks whose
    # surviving support falls under two views.
    cam_pts = np.einsum("fab,tb->fta", R_np, pts) + t_np[:, None, :]
    z = cam_pts[..., 2]
    proj = cam_pts[..., :2] / np.clip(z[..., None], 1e-9, None)
    err2 = np.sum((proj - uv_grid) ** 2, -1)
    thr_n2 = (2.0 * cfg.ransac.thr_px / float(camera.fx)) ** 2
    good_obs = vis & ok[None, :] & (z > 1e-3) & (err2 < thr_n2)
    good_track = good_obs.sum(0) >= 2
    run.stage("triangulate", t0)

    # 6. pack into the Reconstruction and run one global BA
    rec.R[:F] = R_np
    rec.t[:F] = t_np
    rec.pose_mask[:F] = True
    rec.n_frames = F
    tids = np.where(good_track)[0]
    remap = -np.ones(n_tracks, np.int64)
    remap[tids] = np.arange(len(tids))
    pt_ids = rec.add_points(pts[tids], np.zeros((len(tids), features[0][1].shape[1]),
                                                np.float32))
    # A track's descriptor: its first surviving observation's descriptor.
    for f, k, t in zip(obs_f, obs_k, obs_t):
        if remap[t] < 0 or not good_obs[f, t]:
            continue
        pid = pt_ids[remap[t]]
        if not rec.pt_desc[pid].any():
            rec.pt_desc[pid] = features[f][1][k]
        rec.add_observations(f, np.asarray([pid]), uv_kp[f][k][None])
    # Gauge: camera 0 alone (free_second_cam); freezing camera 1 too would
    # bake in its averaging error. |t1| = 1 restores the monocular scale.
    cost0, cost = rec.run_ba(free_second_cam=True)
    rec.frame_stats.append(dict(stage="global", edges=n_edges, tracks=int(good_track.sum()),
                                obs=rec.n_obs, ba_cost0=cost0, ba_cost=cost))
    if metrics is not None:
        metrics.log("global_ba", cost0=cost0, cost=cost, points=int(rec.n_points),
                    obs=int(rec.n_obs))
    return rec
