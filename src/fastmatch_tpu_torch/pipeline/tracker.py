"""Device-resident SLAM tracking: one ``track_step`` a frame against a map
that stays on the device.

Port of ``fastmatch_tpu/pipeline/tracker.py``. The map is a ``TrackState``
of fixed-capacity tensors on one device; ``track_step`` runs the whole
per-frame pipeline (local-window 2D-3D matching, RANSAC PnP, keyframe
decision, observation append and descriptor refresh, full-bank dedup match,
new-landmark triangulation, covisibility loop-closure votes) without a
readback, and returns a ``TrackInfo`` that ``read_info`` brings to the host
in one transfer. Its three ``match_pair`` calls are K2 on the card.

Differences from the JAX package, none of them in what is computed:

- There is no ``jax.jit``. A step builds a new state out of place; every
  write is gated exactly as in the JAX step, so a frame that fails PnP
  returns a state bit-equal to its input (the driver then re-runs it with
  ``FULL_WINDOW``).
- ``.at[i].set(v, mode="drop")`` becomes ``_put``: the rows go into a copy
  with one scratch row at the capacity index (the drop sentinel), which is
  then cut off, so no index is ever out of range and no row count is read
  back. The descriptor refresh keeps the lowest-index keypoint where two
  track one landmark (possible only without cross-check), so the result
  does not depend on the order of a CUDA scatter.
- ``jax.ops.segment_sum`` over the observation table (votes, covisibility)
  counts in int64 with ``index_add_``: integer sums are exact in any order.
- ``lax.top_k`` puts the lower index first among equal votes; the port takes
  the top 4 of the unique key ``votes * F + (F - 1 - frame)``, which orders
  the same way (``torch.topk`` promises no order among ties).
- RANSAC draws from a ``torch.Generator`` (``frame_generator``): a pure
  function of (seed, frame, purpose), as the JAX package folds its key, so
  the draws differ from JAX's but every engine of the port draws alike.

``compact_obs`` compacts a BA problem to its live rows: eager PyTorch has no
per-shape compile, so the port's host-level solves use the live count where
the JAX package pads to ``obs_bucket``'s power of two.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from fastmatch_tpu_torch.ba.problem import BAProblem, Observations
from fastmatch_tpu_torch.core.camera import normalize_pixels
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.core.lie import SE3
from fastmatch_tpu_torch.geometry.pnp import ransac_pnp
from fastmatch_tpu_torch.geometry.ransac import take
from fastmatch_tpu_torch.geometry.triangulation import triangulate_dlt
from fastmatch_tpu_torch.matching.matcher import match_pair

# Window meaning "match against the whole map" (relocalization).
FULL_WINDOW = 1 << 30
DESC_DIM = 128


@dataclasses.dataclass(frozen=True)
class TrackerStatic:
    """Tracker configuration: capacities and the matching, PnP, map and
    keyframe parameters ``track_step`` reads."""

    cap: int = 2048              # per-frame keypoint capacity
    max_frames: int = 64
    max_points: int = 8192
    max_obs: int = 65536
    ratio: float = 0.8
    cross_check: bool = True
    backend: str = "auto"
    precision: str = "exact"
    n_hyp: int = 256             # PnP hypotheses
    min_inliers: int = 6
    min_parallax_deg: float = 1.0
    dedup_desc_d2: float = 0.35  # re-observation gate (MapConfig)
    vote_desc_d2: float = 0.35   # retrieval vote gate (absolute d^2)
    loop_gap: int = 12           # min frame separation for loop candidates
    kf_tracked_thresh: int = 0   # 0 = every tracked frame is a keyframe
    kf_max_gap: int = 5
    cam_model: str = "pinhole"   # "pinhole" (Brown-Conrady) | "fisheye"


class TrackState(NamedTuple):
    """Fixed-capacity map and tracking context, every tensor on one device."""

    # Trajectory
    R: torch.Tensor             # (F, 3, 3) world->cam
    t: torch.Tensor             # (F, 3)
    pose_mask: torch.Tensor     # (F,) bool
    # Landmarks
    points: torch.Tensor        # (P, 3)
    pt_mask: torch.Tensor       # (P,) bool
    pt_desc: torch.Tensor       # (P, 128)
    pt_last_seen: torch.Tensor  # (P,) i32: frame of the last PnP-inlier observation
    # Observation table (normalized image coordinates)
    obs_cam: torch.Tensor       # (O,) i32
    obs_pt: torch.Tensor        # (O,) i32
    obs_uv: torch.Tensor        # (O, 2)
    obs_mask: torch.Tensor      # (O,) bool
    # Counters (0-dim i32)
    n_frames: torch.Tensor      # next frame index to assign
    n_points: torch.Tensor
    n_obs: torch.Tensor
    last_kf: torch.Tensor
    # Previous-frame context for two-view triangulation
    prev_f: torch.Tensor        # i32 frame index of the context
    prev_xn: torch.Tensor       # (C, 2) normalized keypoints
    prev_desc: torch.Tensor     # (C, 128)
    prev_mask: torch.Tensor     # (C,) bool
    prev_lm: torch.Tensor       # (C,) i32 landmark id or -1
    # Packed intrinsics (core/camera.intrinsics_vector); the model is
    # TrackerStatic.cam_model.
    cam: torch.Tensor           # (9,) f32


class TrackInfo(NamedTuple):
    """Per-frame outcome of ``track_step``, on the device until ``read_info``."""

    ok: torch.Tensor            # bool: PnP succeeded, frame accepted
    n_candidates: torch.Tensor  # i32: 2D-3D match candidates
    n_inliers: torch.Tensor     # i32: PnP inliers
    is_kf: torch.Tensor         # bool
    R: torch.Tensor             # (3, 3) PnP pose (undefined unless ok)
    t: torch.Tensor             # (3,)
    votes: torch.Tensor         # (4,) top loop-closure vote counts
    cands: torch.Tensor         # (4,) i32 their frame indices
    n_new_points: torch.Tensor  # i32
    n_points: torch.Tensor      # i32
    n_obs: torch.Tensor         # i32
    overflow: torch.Tensor      # bool: a capacity append dropped rows
    covis: torch.Tensor         # (F,) i32: PnP-inlier landmarks shared with each frame


# Widths of TrackInfo's fields but the last (covis, F wide) in its packed
# float64 form, which holds every float32 and every int32 exactly.
_INFO_WIDTHS = (1, 1, 1, 1, 9, 3, 4, 4, 1, 1, 1, 1)


def pack_info(info: TrackInfo) -> torch.Tensor:
    """TrackInfo as one (28 + F,) float64 tensor on its device."""
    return torch.cat([f.reshape(-1).to(torch.float64) for f in info])


def unpack_info(row: np.ndarray) -> TrackInfo:
    """The host TrackInfo (numpy fields) of one ``pack_info`` row."""
    parts = np.split(row, np.cumsum(_INFO_WIDTHS))
    fields = {}
    for name, v in zip(TrackInfo._fields, parts):
        if name in ("ok", "is_kf", "overflow"):
            fields[name] = bool(v[0])
        elif name in ("R", "t"):
            fields[name] = v.astype(np.float32).reshape((3, 3) if name == "R" else (3,))
        elif name in ("votes", "cands", "covis"):
            fields[name] = v.astype(np.int32)
        else:
            fields[name] = np.int32(v[0])
    return TrackInfo(**fields)


def read_info(info: TrackInfo) -> TrackInfo:
    """Bring one TrackInfo to the host in a single transfer."""
    return unpack_info(pack_info(info).cpu().numpy())


def frame_generator(seed: int, *path: int, device=None) -> torch.Generator:
    """A generator on ``device`` seeded by (seed, *path) alone: the port's
    ``fold_in(fold_in(PRNGKey(seed), frame), purpose)``. The engines draw
    frame ``fi``'s tracking with path (fi, 0), its relocalization with
    (fi, 1), its loop verification with (fi, 2), and the bootstrap with
    (1,)."""
    s = int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0])
    return torch.Generator(device if device is not None else "cpu").manual_seed(s)


def normalize_points(xy: torch.Tensor, cam: torch.Tensor, model: str = "pinhole"):
    """Pixels -> normalized camera coordinates over the packed (9,)
    intrinsics vector (``core/camera.normalize_pixels``)."""
    return normalize_pixels(xy, cam, model)


def _match(da, ma, db, mb, cfg: TrackerStatic, ratio=None, cross_check=None):
    return match_pair(
        Descriptors(da, ma), Descriptors(db, mb),
        ratio=cfg.ratio if ratio is None else ratio,
        cross_check=cfg.cross_check if cross_check is None else cross_check,
        backend=cfg.backend, precision=cfg.precision, device=da.device)


def _put(a: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``a.at[idx].set(vals, mode="drop")`` out of place, for indices in
    [0, len(a)]: index len(a) (the drop sentinel) lands in a scratch row
    that is cut off. The caller keeps the other indices distinct, or
    writes one value to all of a duplicate index's rows."""
    out = torch.cat([a, a[:1]])
    if not torch.is_tensor(vals):  # a host scalar would be copied over, synchronizing
        vals = torch.full((), vals, dtype=a.dtype, device=a.device)
    out[idx.long()] = vals
    return out[:-1]


def _flags(n: int, idx: torch.Tensor, device) -> torch.Tensor:
    """(n,) bool, True at ``idx`` (index n dropped)."""
    return _put(torch.zeros(n, dtype=torch.bool, device=device), idx, True)


def _segment_count(flags: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment count of true ``flags`` (``jax.ops.segment_sum`` of
    the int32 flags), exact in int64 and returned as int32."""
    out = torch.zeros(n, dtype=torch.int64, device=flags.device)
    return out.index_add_(0, seg.long(), flags.long()).to(torch.int32)


def _first_writers(sel: torch.Tensor, n: int) -> torch.Tensor:
    """``sel`` (C,) with values in [0, n] (n = dropped), each index other
    than n kept only at its lowest position and dropped (set to n)
    elsewhere: a scatter of these rows has no duplicate index."""
    c = sel.shape[0]
    pos = torch.arange(c, device=sel.device)
    first = torch.full((n + 1,), c, dtype=torch.int64, device=sel.device)
    first.scatter_reduce_(0, sel.long(), pos, reduce="amin")
    return torch.where(first[sel.long()] == pos, sel, torch.full_like(sel, n))


def _top4(votes: torch.Tensor):
    """``lax.top_k(votes, 4)``: the four largest, the lower index first
    among equals."""
    F = votes.shape[0]
    idx = torch.arange(F, dtype=torch.int64, device=votes.device)
    _, pick = torch.topk(votes.long() * F + (F - 1 - idx), 4)
    return votes[pick], pick.to(torch.int32)


def _append_rows(arrays, sel, rows, count):
    """Scatter-append ``rows[sel]`` into the fixed-capacity ``arrays``
    from row ``count`` on. Returns (new arrays, new count, overflowed);
    rows beyond the capacity are dropped and raise the overflow flag."""
    cap = arrays[0].shape[0]
    slots = count + torch.cumsum(sel.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = torch.where(sel & (slots < cap), slots, torch.full_like(slots, cap))
    out = [_put(a, slots, r) for a, r in zip(arrays, rows)]
    total = count + sel.sum(dtype=torch.int32)
    return out, torch.clamp(total, max=cap), total > cap


def init_state(cfg: TrackerStatic, camera, device=None) -> TrackState:
    """A fresh all-empty state on ``device`` (``cuda`` unless ``device="cpu"``)."""
    F, P, O, C = cfg.max_frames, cfg.max_points, cfg.max_obs, cfg.cap
    device = resolve_device(device)
    kw = dict(device=device)
    f32, i32, b = torch.float32, torch.int32, torch.bool

    def scalar(v):
        return torch.full((), v, dtype=i32, **kw)

    return TrackState(
        R=torch.eye(3, dtype=f32, **kw).expand(F, 3, 3).contiguous(),
        t=torch.zeros((F, 3), dtype=f32, **kw),
        pose_mask=torch.zeros(F, dtype=b, **kw),
        points=torch.zeros((P, 3), dtype=f32, **kw),
        pt_mask=torch.zeros(P, dtype=b, **kw),
        pt_desc=torch.zeros((P, DESC_DIM), dtype=f32, **kw),
        pt_last_seen=torch.full((P,), -(1 << 30), dtype=i32, **kw),
        obs_cam=torch.zeros(O, dtype=i32, **kw),
        obs_pt=torch.zeros(O, dtype=i32, **kw),
        obs_uv=torch.zeros((O, 2), dtype=f32, **kw),
        obs_mask=torch.zeros(O, dtype=b, **kw),
        n_frames=scalar(0), n_points=scalar(0), n_obs=scalar(0), last_kf=scalar(0),
        prev_f=scalar(-1),
        prev_xn=torch.zeros((C, 2), dtype=f32, **kw),
        prev_desc=torch.zeros((C, DESC_DIM), dtype=f32, **kw),
        prev_mask=torch.zeros(C, dtype=b, **kw),
        prev_lm=torch.full((C,), -1, dtype=i32, **kw),
        cam=torch.as_tensor(np.asarray(camera.intrinsics_vector(), np.float32), device=device),
    )


def track_step(state: TrackState, xy: torch.Tensor, desc: torch.Tensor, mask: torch.Tensor,
               generator: torch.Generator, thr_n: float, window, cfg: TrackerStatic,
               mf=None) -> tuple[TrackState, TrackInfo]:
    """Track one frame (xy (C, 2) pixels, desc (C, 128), mask (C,), on the
    state's device) against the map; returns the new state and the device
    TrackInfo, with no readback. ``window``: the tracking window in frames
    (an int or a 0-dim int32 tensor; ``FULL_WINDOW`` relocalizes against
    the whole map). On PnP failure the returned state is bit-equal to
    ``state``.

    ``mf``: the full-bank nearest-landmark match (ratio 1, no cross-check)
    computed outside, or None to compute it here. Either way it is matched
    against the bank before this step's descriptor refresh, so a match
    prefetched right after the previous step makes the same decisions."""
    C, P, F = cfg.cap, cfg.max_points, cfg.max_frames
    dev = state.R.device
    f = state.n_frames
    fw = torch.clamp(f, max=F - 1)  # JAX clamps an out-of-range gather
    xn = normalize_points(xy, state.cam, cfg.cam_model)

    # ---- 1. 2D-3D tracking match against the local landmark window ----
    lmask = state.pt_mask & (state.pt_last_seen >= f - window)
    mt = _match(desc, mask, state.pt_desc, lmask, cfg)
    lm = mt.idx.to(torch.int32)
    X = state.points[lm.long()]

    # ---- 2. RANSAC PnP ----
    pn = ransac_pnp(X, xn, mt.valid, thr=thr_n, n_hyp=cfg.n_hyp,
                    min_inliers=cfg.min_inliers, generator=generator, device=dev)
    ok = pn.ok
    tracked = mt.valid & pn.inliers & ok
    n_inl = tracked.sum(dtype=torch.int32)

    # ---- 3. keyframe decision ----
    if cfg.kf_tracked_thresh <= 0:
        is_kf = ok
    else:
        is_kf = ok & ((n_inl < cfg.kf_tracked_thresh) | (f - state.last_kf >= cfg.kf_max_gap))

    # ---- 4. accept pose ----
    fsel = f.reshape(1)
    R = _put(state.R, fsel, torch.where(ok, pn.pose.R, take(state.R, fw))[None])
    t = _put(state.t, fsel, torch.where(ok, pn.pose.t, take(state.t, fw))[None])
    pose_mask = _put(state.pose_mask, fsel, (take(state.pose_mask, fw) | ok)[None])

    # ---- 5. tracked landmarks: descriptor refresh, last seen, keyframe
    #         observations (written in step 7, with the new landmarks' rows:
    #         one copy of each table a step) ----
    lm_sel = torch.where(tracked, lm, torch.full_like(lm, P))
    fvec = f.expand(C)
    cur_lm = torch.where(tracked, lm, torch.full_like(lm, -1))

    # ---- 6. full-bank nearest-landmark match: dedup and retrieval votes,
    #         against the bank before this step's refresh ----
    if mf is None:
        mf = _match(desc, mask, state.pt_desc, state.pt_mask, cfg, ratio=1.0,
                    cross_check=False)
    known = mf.valid & (mf.dist < cfg.dedup_desc_d2)

    # ---- 7. new landmarks against the previous frame (keyframes only) ----
    free_cur = mask & ~tracked & ~known
    free_prev = state.prev_mask & (state.prev_lm < 0)
    m2 = _match(desc, free_cur, state.prev_desc, free_prev, cfg)
    sel2 = m2.valid & (cur_lm < 0) & is_kf & (state.prev_f >= 0)
    xpn = state.prev_xn[m2.idx.long()]
    pf = torch.clamp(state.prev_f, min=0)
    Rp, tp = take(state.R, pf), take(state.t, pf)
    pts, ok3 = triangulate_dlt(torch.stack([Rp, pn.pose.R]), torch.stack([tp, pn.pose.t]),
                               torch.stack([xpn, xn]), torch.stack([sel2, sel2]))
    keep = sel2 & ok3
    # Cheirality and reprojection gates in both views.
    for R_, t_, xv in ((Rp, tp, xpn), (pn.pose.R, pn.pose.t, xn)):
        p = pts @ R_.T + t_
        zp = torch.clamp(p[:, 2:3], min=1e-9)
        keep = keep & (p[:, 2] > 1e-3)
        keep = keep & (((p[:, :2] / zp - xv) ** 2).sum(-1) < thr_n)
    # Parallax gate between the viewing rays.
    c1 = -Rp.T @ tp
    c2 = -pn.pose.R.T @ pn.pose.t
    r1 = pts - c1
    r2 = pts - c2
    cosang = (r1 * r2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), min=1e-12)
    keep = keep & (cosang < math.cos(math.radians(cfg.min_parallax_deg)))

    # Append the new landmarks. Their slots (from n_points on) are disjoint
    # from the tracked landmarks' (below n_points), so the refresh of step 5
    # and the new rows go in one write each.
    slots_p = state.n_points + torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    slots_ok = keep & (slots_p < P)
    slots = torch.where(slots_ok, slots_p, torch.full_like(slots_p, P))
    points = _put(state.points, slots, pts)
    pt_desc = _put(state.pt_desc, torch.cat([_first_writers(lm_sel, P), slots]),
                   torch.cat([desc, desc]))
    pt_mask = _put(state.pt_mask, slots, True)
    pt_last_seen = _put(state.pt_last_seen, torch.cat([lm_sel, slots]), f)
    n_new = keep.sum(dtype=torch.int32)
    total_p = state.n_points + n_new
    n_points = torch.clamp(total_p, max=P)
    ovf2 = total_p > P
    cur_lm = torch.where(slots_ok, slots_p, cur_lm)
    # Observations, in the JAX step's order: the keyframe's tracked
    # landmarks, then the new landmarks in the previous view and in this
    # one. One append of the three blocks gives the rows, the count and the
    # overflow of three appends in turn.
    new_pt = torch.where(slots_ok, slots_p, torch.zeros_like(slots_p))
    (obs_cam, obs_pt, obs_uv, obs_mask), n_obs, ovf1 = _append_rows(
        [state.obs_cam, state.obs_pt, state.obs_uv, state.obs_mask],
        torch.cat([tracked & is_kf, slots_ok, slots_ok]),
        [torch.cat([fvec, state.prev_f.expand(C), fvec]), torch.cat([lm, new_pt, new_pt]),
         torch.cat([xn, xpn, xn]), torch.ones(3 * C, dtype=torch.bool, device=dev)],
        state.n_obs)

    # ---- 8. loop-closure votes and covisibility over the obs table ----
    voted = mf.valid & (mf.dist < cfg.vote_desc_d2) & mask
    matched_pt = _flags(P, torch.where(voted, mf.idx, torch.full_like(mf.idx, P)), dev)
    votes = _segment_count(obs_mask & matched_pt[obs_pt.long()], obs_cam, F)
    fidx = torch.arange(F, dtype=torch.int32, device=dev)
    votes = torch.where((fidx <= f - cfg.loop_gap) & pose_mask, votes, torch.zeros_like(votes))
    top_votes, top_cands = _top4(votes)
    # The current frame's covisibility row: covis[c] = the number of this
    # frame's PnP-inlier landmarks that frame c observes (feeds the
    # covisibility-gated local BA of ba_problem_from_state).
    tracked_pt = _flags(P, lm_sel, dev)
    covis = _segment_count(obs_mask & tracked_pt[obs_pt.long()], obs_cam, F)
    covis = torch.where(pose_mask, covis, torch.zeros_like(covis))

    # ---- 9. roll the previous-frame context (only on success) ----
    def roll(old, new):
        return torch.where(ok, new, old)

    new_state = TrackState(
        R=R, t=t, pose_mask=pose_mask,
        points=points, pt_mask=pt_mask, pt_desc=pt_desc, pt_last_seen=pt_last_seen,
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv, obs_mask=obs_mask,
        n_frames=torch.where(ok, f + 1, f), n_points=n_points, n_obs=n_obs,
        last_kf=torch.where(is_kf, f, state.last_kf),
        prev_f=roll(state.prev_f, f),
        prev_xn=roll(state.prev_xn, xn),
        prev_desc=roll(state.prev_desc, desc),
        prev_mask=roll(state.prev_mask, mask),
        prev_lm=roll(state.prev_lm, cur_lm),
        cam=state.cam,
    )
    # On failure every write above was gated to a no-op (the selections
    # fold ``ok``), so the state is unchanged bit for bit.
    info = TrackInfo(
        ok=ok, n_candidates=mt.valid.sum(dtype=torch.int32), n_inliers=n_inl, is_kf=is_kf,
        R=pn.pose.R, t=pn.pose.t, votes=top_votes, cands=top_cands, n_new_points=n_new,
        n_points=n_points, n_obs=n_obs, overflow=ovf1 | ovf2, covis=covis)
    return new_state, info


def loop_verify(state: TrackState, xy, desc, mask, cand: int, generator: torch.Generator,
                thr_n: float, cfg: TrackerStatic, n_hyp: int = 256, min_inliers: int = 10):
    """Geometric verification of a loop candidate: PnP of the current frame
    against the landmarks frame ``cand`` observes. Returns (PnPResult,
    number of match candidates as a device scalar)."""
    P = cfg.max_points
    dev = state.R.device
    xn = normalize_points(xy, state.cam, cfg.cam_model)
    obs_sel = state.obs_mask & (state.obs_cam == cand)
    lm_mask = _flags(P, torch.where(obs_sel, state.obs_pt, torch.full_like(state.obs_pt, P)),
                     dev) & state.pt_mask
    m = _match(desc, mask, state.pt_desc, lm_mask, cfg)
    X = state.points[m.idx.long()]
    pn = ransac_pnp(X, xn, m.valid, thr=thr_n, n_hyp=n_hyp, min_inliers=min_inliers,
                    generator=generator, device=dev)
    return pn, m.valid.sum(dtype=torch.int32)


def compact_obs(prob: BAProblem, bucket: int) -> BAProblem:
    """Compact the observation table to ``bucket`` rows: live rows first in
    their stable order, dead rows pointing at segment 0. BA cost scales
    with the table size, so a map's fixed capacity would otherwise be paid
    in padding; masked rows contribute exactly zero to every reduction."""
    o = prob.obs
    if bucket >= o.mask.shape[0]:
        return prob
    order = torch.argsort((~o.mask).to(torch.uint8), stable=True)[:bucket]
    live = o.mask[order]
    zero = torch.zeros((), dtype=o.cam_idx.dtype, device=o.cam_idx.device)
    obs = Observations(cam_idx=torch.where(live, o.cam_idx[order], zero),
                       pt_idx=torch.where(live, o.pt_idx[order], zero),
                       uv=o.uv[order], mask=live)
    return prob._replace(obs=obs)


def obs_bucket(n_obs: int, capacity: int, floor: int = 2048) -> int:
    """Power-of-two bucket for a live observation count (the JAX package's
    table size for its host-level solves; the port's solves compact to the
    live count)."""
    b = floor
    while b < n_obs:
        b *= 2
    return min(b, capacity)


def compact_obs_local(prob: BAProblem, bucket: int) -> BAProblem:
    """Compact to the ``bucket`` rows that can move a LOCAL solve: rows
    whose point is free or whose camera is free (a row with both frozen
    has zero Jacobian and a constant residual). If more rows qualify, the
    newest win; the kept rows stay in chronological order."""
    o = prob.obs
    O = o.mask.shape[0]
    if bucket >= O:
        return prob
    freecam = prob.cam_mask & ~prob.fixed_cams
    sel = o.mask & (prob.pt_mask[o.pt_idx.long()] | freecam[o.cam_idx.long()])
    row = torch.arange(O, dtype=torch.int32, device=sel.device)
    # Ascending key: selected rows newest first, the others after them.
    key = torch.where(sel, O - row, torch.full_like(row, 2 * O))
    order = torch.sort(torch.argsort(key, stable=True)[:bucket]).values
    keep = sel[order]
    zero = torch.zeros((), dtype=o.cam_idx.dtype, device=o.cam_idx.device)
    obs = Observations(cam_idx=torch.where(keep, o.cam_idx[order], zero),
                       pt_idx=torch.where(keep, o.pt_idx[order], zero),
                       uv=o.uv[order], mask=keep)
    return prob._replace(obs=obs)


def ba_problem_from_state(state: TrackState, f, window, free_second_cam: bool = False,
                          covis=None, covis_thresh: int = 0) -> BAProblem:
    """Local BA problem over the device state, with no host round trip.

    Time-window selection (default): cameras before ``f - window`` and the
    gauge pair (0, 1) are frozen, and so are points not seen within the
    window. Covisibility selection (``covis``, the current frame's row
    from TrackInfo, and ``covis_thresh`` > 0): the free cameras are the
    union of the window and the cameras sharing at least ``covis_thresh``
    PnP-inlier landmarks with the current frame, and the free points those
    that an active camera observes."""
    dev = state.R.device
    idx = torch.arange(state.pose_mask.shape[0], dtype=torch.int32, device=dev)
    n_gauge = 1 if free_second_cam else 2
    if covis is not None and covis_thresh > 0:
        if not torch.is_tensor(covis):
            covis = torch.from_numpy(np.array(covis))
        covis = covis.to(dev)
        active = state.pose_mask & ((covis >= covis_thresh) | (idx >= f - window))
        fixed = state.pose_mask & ((idx < n_gauge) | ~active)
        P = state.pt_mask.shape[0]
        sel_obs = state.obs_mask & active[state.obs_cam.long()]
        pt_local = _flags(P, torch.where(sel_obs, state.obs_pt,
                                         torch.full_like(state.obs_pt, P)), dev) & state.pt_mask
    else:
        fixed = state.pose_mask & ((idx < n_gauge) | (idx < f - window))
        pt_local = state.pt_mask & (state.pt_last_seen >= f - window)
    return BAProblem(
        poses=SE3(state.R, state.t), points=state.points,
        obs=Observations(state.obs_cam, state.obs_pt, state.obs_uv, state.obs_mask),
        cam_mask=state.pose_mask, pt_mask=pt_local, fixed_cams=fixed)
