"""Smoke run of the PyTorch/CUDA port (``fastmatch_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the result line:

1. the device, and ``nvidia-smi``'s name and power limit;
2. build of the CUDA kernels under ``src/fastmatch_tpu_torch/csrc/`` (one
   ``nvcc`` per source, all started together), and the SASS check of K1's
   and K2's libraries (tensor-core instructions in the fast and binary
   kernels, none in the exact ones);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes: K1 (batched fused matcher) at BASELINE.json config 2's
   size (64 pairs of 2048-capacity sets with 1500 live 128-d descriptors,
   exact, fast and packed binary, and fast at 256 pairs), K2 (fused
   distance/top-2/column argmin) at 2048x2048 and 2048x8192 in exact and
   fast mode, K3 (patch gather over patch sets) at the orientation and
   descriptor patch shapes of a 640x480 frame, on the real patch sets of a
   rendered frame (SIFT's 8, ORB's 4, one launch each) and at its edge
   cases, K4 (sorted segment sum, both variants) at
   each width the bundle adjustment sums and at its edge cases, and K5
   (sorted row gather) at the bundle adjustment's shapes; device time per
   launch by ``torch.profiler`` (K1 and K2 per mode and shape, K3 per
   shape and frame set, K4, K5), K1's, K2's and K3's host time per call,
   K3's ``torch.take`` yardstick, and the same-shape product alone
   (``product_only_ms``), and the host time of each step of K4's and K5's
   wrappers; then the edges of K1's and K2's shared tile engine, bit for
   bit against the plain versions (``check_edges``), and its depth loop
   (rows deeper than 256 values or 64 packed words) at the matchers' sizes
   (``check_depth``: K2 at D = 384 and 512, K1 at D = 384, K1 binary at 16
   and 128 words, ``match_pair_hamming(backend="auto")`` at 512 bits);
4. a small-input reference: ``reconstruct`` from synthetic features on the
   card and on the CPU, both held to the JAX package's ATE gate;
5. the config-2 path from images: SIFT and ORB on 33 rendered 640x480
   frames, matched as 32 consecutive pairs by ``match_batch`` (exact and
   fast) and ``match_batch_hamming``, with the launch counts of K1, K2 and
   K3 set to 0 just before and read just after (K3: one launch a frame);
6. the config-3 main path: ``reconstruct(images=...)`` on the 50 rendered
   frames with the default ``PipelineConfig``, with every kernel's launch
   count set to 0 just before and read just after (K3: one launch a
   frame); then global SfM and self-calibration on the same frames
   (``global_sfm_selfcal``): ``global_reconstruct(images=...)`` twice at
   window 8, bit-identical, ATE against the JAX package's, no host sync
   inside the averaging, K3 one launch a frame, K2 at least one a pair
   attempted, K4 and K5 launched, K1 not, and K4 at the averaging's
   key-set shapes against a float64 sum; ``self_calibrate`` of the true
   map seen through fx, fy x 1.06 (fx error cut by more than 3x, vector
   within 1e-3 of the JAX package's); ``reconstruct --mode global
   --selfcal 2`` and ``slam --plot`` through the CLI;
7. BASELINE.json config 4: the 500-keyframe pose graph through
   ``pgo_solve`` (dense and PCG), ``pgo_solve_hierarchical`` and
   ``sim3_pgo_solve``, held to the JAX package's figures on a CPU, every
   sum through K4 and each solver's two runs bit-identical
   (``config4_pgo``); then SLAM from 56
   rendered 640x480 frames of an out-and-back orbit (``config4_slam``:
   SIFT, ``slam`` with loop closure, PGO and global BA), with every
   kernel's launch count set to 0 just before and read just after (K3: one
   launch a frame; K1: none), and K2 at the loop retrieval's largest shape
   against its plain version;
8. the device-resident SLAM engines at config 4's widths
   (``config4_device_slam``): ``slam_device`` twice on the whole 120-frame
   out-and-back orbit (which the host engine loses), and on the 56 frames'
   features ``slam_scan(close_loops=True)``, ``slam_chunked(chunk=16)``,
   ``slam_scan_images`` on the frames, and the parity pairs with loop
   closure off; each run with the launch counts set to 0 just before and
   read just after and its host synchronizations counted. Gates: every
   frame tracked, ATE against the JAX package's figures, at least 4 loop
   closures on the 120 frames (one on the way back), the two
   ``slam_device`` runs bit-identical, ``slam_chunked`` bit-identical to
   ``slam_scan`` and ``slam_scan`` to ``slam_device`` (bitwise with the
   interval budgets lifted, decision-identical at the defaults), K2 at
   least 3 launches a frame, K3 one a frame in ``slam_scan_images`` and
   none in the feature-driven engines, K4 and K5 launched, K1 not;
9. the CLI (``cli``): ``info``, ``reconstruct``, ``evaluate``, ``match`` and
   ``slam`` (``--engine auto``: the device engine on the card);
10. image input (``image_io``): the port's own JPEG, PNG and PNM decoder
   (``csrc/imageio/``, built with g++ and -lpthread alone) on the corpus of
   ``tests/data/torch_images/`` against its ``references.npz`` (the JAX
   package's libjpeg/libpng decodes), bit for bit; the 50 smoke frames
   written as 8-bit PNGs and decoded back; ``reconstruct`` of that PNG
   directory, ``match`` of the two committed 640x480 JPEGs and of the same
   frames arithmetic-coded (SOF10 and SOF9, equal arrays and pairs) and
   ``flow`` of two PNGs through the CLI, with K1-K5's launch counts set to
   0 just before and read just after; host decode ms a frame and
   ``FrameLoader`` frames/s at 1 and 4 threads;
11. the small-baseline front end and dense depth (``vo_paths``) at default
   widths on the 50 smoke frames and a rectified right stream:
   ``visual_odometry`` and ``visual_odometry_scan`` twice each,
   ``stereo_visual_odometry``, ``stereo_disparity`` and ``rectify_pair``,
   ``densify``, ``track_pair`` at capacity 1024 and the ``vialign`` CLI,
   each run's launch counts set to 0 just before and read just after. Gates:
   every frame posed, ATE against the JAX package's figures, reruns
   bit-identical, the stereo run's metric scale, K3 ``1 + levels`` launches
   a tracked frame, K4 and K5 launched, K1 and K2 not, and card against CPU
   for ``track_pair``, ``stereo_disparity``, ``densify`` and ``vialign``;
   then the grouped BA and the 5-point solver on the card;
12. the saved map's product surface (``map_services``) over the 120-frame
   ``slam_device`` map of phase 8: checkpoints and a bit-identical resume
   from ``track.pt``, 12 held-out rendered views through ``localize`` and
   through ``serve`` over HTTP (sequential and 4 client threads), ``locate --retrieval 4`` through the CLI, ``merge_maps`` of
   two ``slam_device`` sessions, and the city: the map planted in a
   4,000,000-row bank (BASELINE.json config 5's retrieval leg), its IVF
   index built twice, both search routes, 4 views served from the IVF
   index, K2 at 2048 x 4,000,000 and K4 at k-means' shape against their
   plain versions, and the IVF agreement at 262,144 rows against the JAX
   package's (``tools/jax_city_reference.py``);
13. the distributed engine (``dist_paths``) at world size 1 over NCCL, the
   one-card ceiling: the ring matcher at 2048 x 262,144 and its ring steps
   over 4 and 8 slabs (K2), sharded BA on the main path's problem (K4, K5),
   ``slam_distributed`` on the 56 config-4 frames beside ``slam_device``
   (overlapped, resumed), the data-parallel matcher (K1) and stereo, sharded
   retrieval, the watchdog, and ``slam --mesh bank=1`` through the CLI.

Then one ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# The config-3 smoke scene: 640x480 rendered frames of a SyntheticScene
# (tests/synth.py). A 1.2-radian orbit over 50 frames gives ~1.4 degrees of
# parallax per frame at the scene centre, above MapConfig's 1-degree
# triangulation gate; the JAX package reconstructs all 50 frames of it on a
# CPU (tools/jax_reference_smoke.py).
SMOKE_SCENE = dict(seed=0, n_points=400, n_frames=50, span=1.2, image_size=(640, 480))
ATE_GATE = 0.35

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_FP32_FLOPS = 67e12      # outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # tensor cores
PEAK_INT_OPS = 1979e12       # int8 tensor cores: the card's highest integer rate
PEAK_BYTES = 3.35e12         # HBM3

# BASELINE.json config 2 (bench.py's workload): 64 pairs, capacity 2048,
# 1500 live unit |N(0, 1)| 128-d descriptors per set; and 256 pairs.
CONFIG2 = dict(batch=64, capacity=2048, live=1500, big_batch=256)
CONFIG2_PAIRS = 32  # consecutive frame pairs of the smoke scene
K1_MIN_VALID = 1000  # valid matches a gated K1 comparison needs
# Calls per CUDA-event batch for K4 and K5, whose wrapper calls are
# host-bound: enough that a batch measures the host's steady call rate, not
# its wake-up from the previous batch's synchronise.
HOST_REPS = 100
DEV = "cuda"        # the device of the config-2 checks and phase
# Kernel names (``kernel_short_name``) of one K1 and one K2 call: the shared
# tile engine (csrc/match_tile.cuh) and each one's finalize.
K1_KERNELS = {"match_tiles", "batch_match_finalize"}
K2_KERNELS = {"match_tiles", "topk_finalize"}
K3_KERNELS = {"gather_patch_sets_kernel"}


def render_smoke_scene(n_frames=None):
    """(scene, frames) of the smoke sequence; frames are (480, 640) f32."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import SyntheticScene, render_scene_views

    p = SMOKE_SCENE
    rng = np.random.default_rng(p["seed"])
    scene = SyntheticScene(rng, n_points=p["n_points"], n_frames=p["n_frames"],
                           image_size=p["image_size"], span=p["span"])
    frames = list(range(p["n_frames"] if n_frames is None else n_frames))
    views = render_scene_views(scene, rng, image_size=p["image_size"], frames=frames)
    return scene, views


# Self-calibration on the smoke scene (``global_sfm_selfcal``): the
# ground-truth map observed through a camera whose fx and fy are this many
# times the true ones (tests/test_calibrate.py's wrong-intrinsics map).
SELFCAL_SCALE = 1.06
SELFCAL_ROUNDS = 3


def selfcal_inputs(scene):
    """The smoke scene's ground-truth map as a miscalibrated pipeline would
    hold it: (R (F, 3, 3), t (F, 3), points (P, 3) seen by some frame,
    obs_frame, obs_point, obs_uv (O, 2) f32, true (9,) f32, wrong (fx, fy,
    cx, cy)). ``obs_uv`` is each true pixel normalized with the wrong
    camera, in float32, frame by frame; numpy only, so both packages
    start from the same bits."""
    import numpy as np

    F = scene.R.shape[0]
    true = np.array([scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2],
                     0, 0, 0, 0, 0], np.float32)
    f = true[:2] * np.float32(SELFCAL_SCALE)
    c = true[2:4]
    seen = scene.visible.any(axis=0)
    remap = np.cumsum(seen) - 1
    obs_f, obs_p, obs_uv = [], [], []
    for k in range(F):
        p = np.nonzero(scene.visible[k])[0]
        obs_f.append(np.full(len(p), k, np.int32))
        obs_p.append(remap[p].astype(np.int32))
        obs_uv.append((scene.pixels[k, p].astype(np.float32) - c) / f)
    wrong = (float(f[0]), float(f[1]), float(c[0]), float(c[1]))
    return (scene.R.astype(np.float32), scene.t.astype(np.float32),
            scene.points[seen].astype(np.float32), np.concatenate(obs_f),
            np.concatenate(obs_p), np.concatenate(obs_uv), true, wrong)


# The VO phase's stereo rig: the smoke scene's left frames and right frames
# from a camera displaced by VO_BASELINE along its own +x axis (the
# construction of tests/test_stereo_vo.py:_right_scene), rendered with the
# left frames' appearance draws so the pair is a true rectified pair. The
# landmarks lie within 2*sqrt(3) of the orbit's centre, 6 away, so the
# largest disparity is 500 * 0.2 / (6 - 2*sqrt(3)) = 39.4 px, inside
# StereoConfig.max_disp = 64.
VO_BASELINE = 0.2


def render_vo_scene(n_frames=None):
    """(scene, left frames, right frames) of the VO phase: the left frames
    are ``render_smoke_scene``'s, the right ones the rig's second camera."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import SyntheticScene, render_scene_views

    p = SMOKE_SCENE
    rng = np.random.default_rng(p["seed"])
    scene = SyntheticScene(rng, n_points=p["n_points"], n_frames=p["n_frames"],
                           image_size=p["image_size"], span=p["span"])
    rng_r = np.random.default_rng()
    rng_r.bit_generator.state = rng.bit_generator.state
    frames = list(range(p["n_frames"] if n_frames is None else n_frames))
    left = render_scene_views(scene, rng, image_size=p["image_size"], frames=frames)
    right = render_scene_views(right_scene(scene, VO_BASELINE, p["image_size"]), rng_r,
                               image_size=p["image_size"], frames=frames)
    return scene, left, right


def right_scene(scene, baseline, image_size):
    """The scene seen by the rig's right camera: x_cam_r = R X + t - [b, 0, 0]."""
    import types

    import numpy as np

    w, h = image_size
    t_r = scene.t - np.array([baseline, 0.0, 0.0])
    cam = np.einsum("fij,pj->fpi", scene.R, scene.points) + t_r[:, None, :]
    z = cam[..., 2]
    uv = (cam[..., :2] / np.clip(z[..., None], 1e-9, None)) @ np.diag(
        [scene.K[0, 0], scene.K[1, 1]]) + scene.K[:2, 2]
    vis = (z > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
    return types.SimpleNamespace(points=scene.points, R=scene.R, t=t_r, K=scene.K, pixels=uv,
                                 visible=vis)


def imu_circle(n_frames=8, s_true=2.2, per_interval=300, dt_frames=0.4):
    """A monocular trajectory and its IMU samples, in numpy: the analytic
    circle of tests/test_imu.py (radius 2, 0.9 rad/s, z drift 0.15 per s,
    body yawing with the motion), keyframes every ``dt_frames`` seconds,
    centres scaled by 1 / ``s_true``; ideal gyro and specific force
    R^T (a - g) at ``per_interval`` samples an interval. Returns (traj
    dict R, t, points; imu dict gyro, accel, dt, interval; true centres)."""
    import numpy as np

    g_w = np.array([0.0, 0.0, -9.81])
    om, r, zdrift = 0.9, 2.0, 0.15

    def circle(t):
        t = np.asarray(t, np.float64)
        p = np.stack([r * np.cos(om * t), r * np.sin(om * t), zdrift * t], -1)
        a = np.stack([-r * om * om * np.cos(om * t), -r * om * om * np.sin(om * t),
                      np.zeros_like(t)], -1)
        R = np.zeros((len(t), 3, 3))
        R[:, 0, 0], R[:, 0, 1] = np.cos(om * t), -np.sin(om * t)
        R[:, 1, 0], R[:, 1, 1] = np.sin(om * t), np.cos(om * t)
        R[:, 2, 2] = 1.0
        return R, p, a

    kf_t = dt_frames * np.arange(n_frames)
    R_wb, p, _ = circle(kf_t)
    R_wc = R_wb.transpose(0, 2, 1).astype(np.float32)
    C = (p / s_true).astype(np.float32)
    traj = dict(R=R_wc, t=-np.einsum("fij,fj->fi", R_wc, C),
                points=np.zeros((5, 3), np.float32))
    parts = {k: [] for k in ("gyro", "accel", "dt", "interval")}
    for i in range(n_frames - 1):
        ts = np.linspace(kf_t[i], kf_t[i + 1], per_interval, endpoint=False)
        R, _, a = circle(ts)
        parts["gyro"].append(np.tile(np.array([0.0, 0.0, om]), (per_interval, 1)))
        parts["accel"].append(np.einsum("nij,nj->ni", R.transpose(0, 2, 1), a - g_w))
        parts["dt"].append(np.full(per_interval, (kf_t[i + 1] - kf_t[i]) / per_interval))
        parts["interval"].append(np.full(per_interval, i))
    imu = {k: np.concatenate(v).astype(np.int64 if k == "interval" else np.float32)
           for k, v in parts.items()}
    return traj, imu, p


# BASELINE.json config 4 ("Pose-graph SLAM: 500-keyframe sequence with loop
# closure"), two ways. The pose graph at full size, not cut: the graph of
# benchmarks/pgo_bench.py (500 keyframes on a circle of radius 10, odometry
# drift 0.004, 5 loop closures, seed 0), rebuilt in numpy. And SLAM from
# images: SMOKE_SCENE's landmarks seen from radius 6 on an out-and-back
# orbit (a triangle wave over +-half_span at 2 half_span / sweep radians a
# frame, ~1.4 degrees), whose way back revisits the way out's viewpoints
# more than SlamConfig.loop_gap frames later (frames f and 2 sweep - f
# coincide); cut from 500 keyframes to n_frames = 56. The way back loses
# tracking a few frames after its first loop closures, in the JAX package
# at frame 59 and in the port at frame 57 (tools/jax_config4_reference.py
# --frames 120): SLAM tracks only the landmarks seen in its last 8 frames,
# and its dedup gate keeps older ones from being triangulated again, so a
# revisit sees ever fewer trackable landmarks. Hence the cut; a full orbit
# instead needs more than 2 degrees a frame, where tracking is lost within
# 12 frames.
CONFIG4_PGO = dict(n=500, radius=10.0, drift=0.004, seed=0)
CONFIG4_SCENE = dict(seed=0, n_points=400, n_frames=56, radius=6.0, half_span=0.6,
                     sweep=49, image_size=(640, 480))


def _so3_exp_np(w):
    """Rodrigues in float64: (3,) axis-angle -> (3, 3) rotation."""
    import numpy as np

    th = float(np.linalg.norm(w))
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th ** 2 * W @ W


def _se3_exp_np(xi):
    """(6,) twist [v, omega] -> (R, t) in float64 (the JAX package's SE3.exp)."""
    import numpy as np

    v, w = xi[:3], xi[3:]
    th = float(np.linalg.norm(w))
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        V = np.eye(3) + 0.5 * W
    else:
        V = (np.eye(3) + (1 - np.cos(th)) / th ** 2 * W
             + (th - np.sin(th)) / th ** 3 * W @ W)
    return _so3_exp_np(w), V @ v


def config4_pose_graph():
    """The config-4 pose graph of benchmarks/pgo_bench.py:17-66 in numpy
    (float64 algebra, the same draws in the same order), as float32 arrays:
    dict(R, t (drifted start), edge_i, edge_j, ZR, Zt, edge_weight,
    pose_mask, fixed, R_gt, t_gt)."""
    import numpy as np

    p = CONFIG4_PGO
    n, rng = p["n"], np.random.default_rng(p["seed"])
    ang = 2 * np.pi * np.arange(n) / n
    Rg = np.zeros((n, 3, 3))
    tg = np.zeros((n, 3))
    for k in range(n):
        c, s = np.cos(ang[k]), np.sin(ang[k])
        Rw = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        Rg[k] = Rw.T
        tg[k] = -Rw.T @ np.array([p["radius"] * c, p["radius"] * s, 0])

    def rel(a, b):  # T_a T_b^-1
        R = Rg[a] @ Rg[b].T
        return R, tg[a] - R @ tg[b]

    R0, t0 = [Rg[0]], [tg[0]]
    ei, ej, ZR, Zt = [], [], [], []
    for k in range(1, n):
        Rz, tz = rel(k, k - 1)
        nR, nt = _se3_exp_np(np.concatenate([p["drift"] * rng.standard_normal(3),
                                             0.5 * p["drift"] * rng.standard_normal(3)]))
        Rz, tz = nR @ Rz, nR @ tz + nt
        R0.append(Rz @ R0[-1])
        t0.append(Rz @ t0[-1] + tz)
        ei.append(k), ej.append(k - 1), ZR.append(Rz), Zt.append(tz)
    for a, b in ((n - 1, 0), (n // 2, 0), (n - 1, n // 2), (3 * n // 4, n // 4), (n // 4, 0)):
        Rz, tz = rel(a, b)
        ei.append(a), ej.append(b), ZR.append(Rz), Zt.append(tz)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(R=f32(R0), t=f32(t0), edge_i=np.asarray(ei, np.int32),
                edge_j=np.asarray(ej, np.int32), ZR=f32(ZR), Zt=f32(Zt),
                edge_weight=np.ones(len(ei), np.float32), pose_mask=np.ones(n, bool),
                fixed=fixed, R_gt=f32(Rg), t_gt=f32(tg))


class OrbitScene:
    """Landmarks seen by cameras at ``angles`` on a circle of ``radius``
    looking at the origin, with the attributes ``render_scene_views`` reads
    (K, points, R, t, pixels, visible), as ``tests/synth.py``'s
    SyntheticScene computes them."""

    def __init__(self, points, angles, radius, image_size):
        import numpy as np

        from synth import look_at

        w, h = image_size
        self.K = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1.0]])
        self.points = points
        poses = [look_at(np.array([radius * np.sin(a), 0.5 * np.sin(2 * a),
                                   -radius * np.cos(a)]), np.zeros(3)) for a in angles]
        self.R = np.stack([R for R, _ in poses])
        self.t = np.stack([t for _, t in poses])
        cam = np.einsum("fij,pj->fpi", self.R, points) + self.t[:, None, :]
        z = cam[..., 2]
        self.pixels = (cam[..., :2] / np.clip(z[..., None], 1e-9, None)) @ np.diag(
            [self.K[0, 0], self.K[1, 1]]) + self.K[:2, 2]
        uv = self.pixels
        self.visible = ((z > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < w)
                        & (uv[..., 1] >= 0) & (uv[..., 1] < h))


def config4_angles(n_frames):
    """The out-and-back orbit: a triangle wave from -half_span to
    +half_span in ``sweep`` frames and back, so frames f and 2 sweep - f
    share a viewpoint."""
    import numpy as np

    p = CONFIG4_SCENE
    span, sweep = 2 * p["half_span"], p["sweep"]
    phase = np.arange(n_frames) % (2 * sweep)
    return -p["half_span"] + span / sweep * np.where(phase <= sweep, phase, 2 * sweep - phase)


def render_config4_scene(n_frames=None):
    """(scene, frames) of the config-4 SLAM sequence: SMOKE_SCENE's 400
    landmarks (the same seed, the same draws) and their rendering, seen
    from ``config4_angles``; frames are (480, 640) f32."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import render_scene_views

    p = CONFIG4_SCENE
    n = p["n_frames"] if n_frames is None else n_frames
    rng = np.random.default_rng(p["seed"])
    points = rng.uniform(-2.0, 2.0, size=(p["n_points"], 3))  # SyntheticScene's first draw
    scene = OrbitScene(points, config4_angles(n), p["radius"], p["image_size"])
    return scene, render_scene_views(scene, rng, image_size=p["image_size"])


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, batches=7, reps=10):
    """Median over ``batches`` of the mean ms per call of ``fn`` across
    ``reps`` back-to-back calls on the current stream, by CUDA events, after
    one warm-up call. A call's time includes its wrapper's host work
    wherever that is longer than the device work it enqueues."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(fn, n=10_000):
    """Mean host microseconds per call of ``fn`` over ``n`` back-to-back
    calls by ``time.perf_counter_ns``, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / n / 1e3


def bound(n_bytes, n_ops=0.0, peak_ops=PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions -----------------------------


def _decisions_equal(got, ref):
    """valid equal everywhere, idx equal where valid."""
    return torch_all((got.valid == ref.valid) & (~ref.valid | (got.idx == ref.idx)))


def torch_all(t):
    return bool(t.all().item())


def _config2_sets(rng, batch, matched=False, dim=128):
    """bench.py's make_pairs in numpy: (a, b) lists of (live, dim) unit
    |N(0, 1)| sets, unrelated to each other. With ``matched``, each bank is
    instead a permuted copy of its queries with N(0, 0.08) noise (unit
    |.|), so about a fifth of the queries pass at ratio 0.8, many of them
    near the threshold (the noise scales as sqrt(128 / dim), so that the
    same share passes at any width)."""
    import numpy as np

    def unit(d):
        return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    noise = 0.08 * np.sqrt(128 / dim)

    def pair():
        a = unit(np.abs(rng.standard_normal((CONFIG2["live"], dim))))
        if not matched:
            return a, unit(np.abs(rng.standard_normal((CONFIG2["live"], dim))))
        b = unit(np.abs(a + noise * rng.standard_normal(a.shape)))
        return a, b[rng.permutation(CONFIG2["live"])]

    raw = [pair() for _ in range(batch)]
    return [a for a, _ in raw], [b for _, b in raw]


def _agreement(got, ref, mask):
    from fastmatch_tpu_torch.utils.evaluation import match_agreement

    return float(match_agreement(got.idx, got.valid, ref.idx, ref.valid, mask))


def k1_bound(mask_a, mask_b, ops_per_product, row_bytes, peak):
    """(bound_ms, bound_by) of one K1 call on these inputs: one product per
    live query and live bank row (``ops_per_product`` operations each), the
    live rows' operands (``row_bytes`` each) and both masks read once, and
    the three outputs (idx, dist, valid: 9 bytes a query) written once."""
    la = mask_a.sum(-1).double()
    lb = mask_b.sum(-1).double()
    n_ops = ops_per_product * float((la * lb).sum())
    n_bytes = (row_bytes * float(la.sum() + lb.sum()) + mask_a.numel() + mask_b.numel()
               + 9 * mask_a.numel())
    return bound(n_bytes, n_ops, peak)


def check_k1(rng):
    """K1 at config 2's size (64 pairs, capacity 2048, 1500 live 128-d).
    Exact: decisions identical to the plain version on bench.py's unrelated
    sets at ratio 0.8 (no match passes) and 1.0 (the mutual check decides),
    and on noisy-copy banks at ratio 0.8; the distance error is measured
    over their valid matches. Fast: >= 0.99 agreement with the exact plain
    version on both inputs that give matches, at 64 and at 256 pairs.
    Binary: identical to the popcount plain version, distances included.
    Every gated comparison needs valid matches."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.containers import BinaryDescriptors, Descriptors
    from fastmatch_tpu_torch.interop import (batched_descriptors_from_numpy,
                                             binary_descriptors_from_arrays)
    from fastmatch_tpu_torch.kernels import batch_match as k1
    from fastmatch_tpu_torch.matching import hamming
    from fastmatch_tpu_torch.matching.matcher import stack_matches

    dev = torch.device(DEV)
    cap, B, d = CONFIG2["capacity"], CONFIG2["batch"], 128
    min_valid = K1_MIN_VALID
    details, errs = [], []

    def sets(batch, matched):
        a_sets, b_sets = _config2_sets(rng, batch, matched)
        return (batched_descriptors_from_numpy(a_sets, cap, dev),
                batched_descriptors_from_numpy(b_sets, cap, dev))

    def record(rec, ok, why):
        details.append(rec)
        log("K1", json.dumps(rec))
        if not ok:
            raise AssertionError(f"K1 {why}: {rec}")

    def hold_exact(da, db, ratio, inputs, need_valid):
        got = k1.match_batch_fused(da, db, ratio=ratio)
        ref = k1.match_batch_fused_plain(da, db, ratio=ratio)
        both = got.valid & ref.valid
        n_valid = int(ref.valid.sum())
        err = float((got.dist - ref.dist)[both].abs().max()) if bool(both.any()) else None
        if err is not None:
            errs.append(err)
        same = _decisions_equal(got, ref)
        record(dict(mode="exact", batch=int(da.mask.shape[0]), inputs=inputs, ratio=ratio,
                    decisions_identical=same, n_valid=n_valid, max_abs_err=err,
                    raw_idx_agreement=float((got.idx == ref.idx)[da.mask].float().mean())),
               same and (n_valid >= min_valid or not need_valid),
               "exact decisions differ from the plain version, or too few valid matches")
        return ref

    def hold_fast(da, db, ratio, inputs, exact_ref):
        got = k1.match_batch_fused(da, db, ratio=ratio, fast=True)
        fast_ref = k1.match_batch_fused_plain(da, db, ratio=ratio, fast=True)
        agree = _agreement(got, exact_ref, da.mask)
        both = got.valid & fast_ref.valid
        n_valid = int(got.valid.sum())
        record(dict(mode="fast", batch=int(da.mask.shape[0]), inputs=inputs, ratio=ratio,
                    agreement_vs_exact_plain=agree,
                    agreement_vs_fast_plain=_agreement(got, fast_ref, da.mask),
                    n_valid=n_valid, max_abs_err_vs_fast_plain=float(
                        (got.dist - fast_ref.dist)[both].abs().max()) if bool(both.any())
                    else None),
               agree >= 0.99 and n_valid >= min_valid,
               "fast agreement below 0.99, or too few valid matches")

    def timed(name, fn, plain_fn, bnd, batch, peak, product=None, reps=10, plain_reps=2,
              prof_calls=10):
        """Wrapper ms (CUDA events), device us per call of the kernel's own
        launches (profiler), host us per call, the plain version's ms and
        the product alone (``product_only_ms``: the same-shape batched
        ``a @ b.T`` in the operands' type, TF32 off; a yardstick, not the
        same function)."""
        ms = cuda_ms(fn, reps=reps)
        plain_ms = cuda_ms(plain_fn, batches=3, reps=plain_reps)
        us, seen = device_us(fn, K1_KERNELS, n=prof_calls)
        rec = dict(mode=name, batch=batch, shape=[cap, cap, d], ms=ms,
                   pairs_per_s=batch / ms * 1e3, plain_ms=plain_ms, bound_ms=bnd[0],
                   bound_by=bnd[1], peak=peak,
                   device_us_per_call=us * seen / prof_calls if seen else None,
                   profiled_launches=seen, host_us_per_call=host_us(fn, 20),
                   product_only_ms=cuda_ms(product, reps=reps) if product else None)
        record(rec, True, "")
        return rec

    def product(da, db, dtype):
        a = da.data.to(dtype)
        bt = db.data.to(dtype).transpose(1, 2)
        return lambda: torch.bmm(a, bt)

    # bench.py's workload: unrelated sets.
    da, db = sets(B, matched=False)
    hold_exact(da, db, 0.8, "unrelated", need_valid=False)
    r1_ref = hold_exact(da, db, 1.0, "unrelated", need_valid=True)
    hold_fast(da, db, 1.0, "unrelated", r1_ref)
    del r1_ref
    ex_bound = k1_bound(da.mask, db.mask, 2 * d, 4 * d, PEAK_FP32_FLOPS)
    rec = timed("exact", lambda: k1.match_batch_fused(da, db),
                lambda: k1.match_batch_fused_plain(da, db), ex_bound, B,
                "fp32 CUDA cores, 67e12 FLOP/s", product(da, db, torch.float32), reps=5)
    timed("fast", lambda: k1.match_batch_fused(da, db, fast=True),
          lambda: k1.match_batch_fused_plain(da, db, fast=True),
          k1_bound(da.mask, db.mask, 2 * d, 2 * d, PEAK_BF16_FLOPS), B,
          "bf16 operands: tensor-core peak 989e12 FLOP/s (wgmma)",
          product(da, db, torch.bfloat16))

    # Noisy-copy banks: thousands of valid matches, many near the threshold.
    da, db = sets(B, matched=True)
    ref = hold_exact(da, db, 0.8, "noisy copies", need_valid=True)
    hold_fast(da, db, 0.8, "noisy copies", ref)
    del ref, da, db
    entry = dict(max_abs_err=max(errs), ms=rec["ms"], plain_ms=rec["plain_ms"],
                 bound_ms=ex_bound[0], bound_by=ex_bound[1], library_ms=None,
                 product_only_ms=rec["product_only_ms"])

    # bench.py's binary leg: 64 x 2048 x 8 words, half the rows re-drawn.
    words = rng.integers(0, 2 ** 32, size=(B, cap, 8), dtype=np.uint64).astype(np.uint32)
    other = words.copy()
    other[:, :cap // 2] = rng.integers(0, 2 ** 32, size=(B, cap // 2, 8),
                                       dtype=np.uint64).astype(np.uint32)
    ones = np.ones((B, cap), bool)
    A = binary_descriptors_from_arrays(words, ones, dev)
    Bk = binary_descriptors_from_arrays(other, ones, dev)

    def popcount_plain():
        return stack_matches(hamming.match_pair_hamming_plain(
            BinaryDescriptors(pa, ma), BinaryDescriptors(pb, mb))
            for pa, ma, pb, mb in zip(A.packed, A.mask, Bk.packed, Bk.mask))

    def kernel_plain():
        return hamming._quarter(k1.match_batch_fused_plain(
            Descriptors(A.packed, A.mask), Descriptors(Bk.packed, Bk.mask),
            ratio=hamming._ratio_sqrt(0.8), fast=True, const_sq_norm=256.0, binary=True))

    got = hamming.match_batch_hamming(A, Bk, backend="mxu", device=DEV)
    anchor = popcount_plain()
    identical = (torch_all(got.valid == anchor.valid) and torch_all(got.dist == anchor.dist)
                 and torch_all((got.idx == anchor.idx) | ~anchor.valid))
    n_valid = int(anchor.valid.sum())
    record(dict(mode="binary", batch=B, identical_to_popcount=identical,
                identical_to_plain=_decisions_equal(got, kernel_plain()), n_valid=n_valid,
                max_abs_err=float((got.dist - anchor.dist)[anchor.valid].abs().max())
                if n_valid else None),
           identical and n_valid >= min_valid,
           "binary differs from the popcount plain version, or too few valid matches")
    # +-1 products of 256 bits, as the TPU kernel counts them (d_eff = 32 W).
    timed("binary", lambda: hamming.match_batch_hamming(A, Bk, backend="mxu", device=DEV),
          kernel_plain, k1_bound(A.mask, Bk.mask, 2 * 256, 32, PEAK_INT_OPS), B,
          "+-1 products of 256 bits against the int8 tensor-core peak 1979e12 op/s "
          "(wgmma s8)")
    del got, anchor, A, Bk

    # Fast at 256 pairs on noisy-copy banks; the exact plain version is
    # taken 64 pairs at a time.
    BB = CONFIG2["big_batch"]
    da, db = sets(BB, matched=True)
    ref = stack_matches(
        m for s in range(0, BB, B) for m in zip(*k1.match_batch_fused_plain(
            type(da)(da.data[s:s + B], da.mask[s:s + B]),
            type(db)(db.data[s:s + B], db.mask[s:s + B]))))
    hold_fast(da, db, 0.8, "noisy copies", ref)
    del ref
    timed("fast", lambda: k1.match_batch_fused(da, db, fast=True),
          lambda: k1.match_batch_fused_plain(da, db, fast=True),
          k1_bound(da.mask, db.mask, 2 * d, 2 * d, PEAK_BF16_FLOPS), BB,
          "bf16 operands: tensor-core peak 989e12 FLOP/s (wgmma)",
          product(da, db, torch.bfloat16), reps=4, plain_reps=1, prof_calls=4)
    return entry, details


def kernel_instance_name(name):
    """A demangled CUDA kernel name without return type, namespaces or
    signature: ``"void fm::(anonymous namespace)::match_tiles<0, 1>(fm::
    (anonymous namespace)::TileArgs)"`` -> ``"match_tiles<0, 1>"``."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    head = head.split(" ", 1)[1] if head.startswith("void ") else head
    return head.split("<")[0].split("::")[-1] + ("<" + head.split("<", 1)[1] if "<" in head else "")


def kernel_short_name(name):
    """``kernel_instance_name`` without template arguments: ``"void
    (anonymous namespace)::segsum_short<3>(float const*, ...)"`` ->
    ``"segsum_short"``."""
    return kernel_instance_name(name).split("<")[0]


def device_us(fn, names, n=300):
    """Mean device microseconds per launch of the kernels called ``names``
    (``kernel_short_name``) over ``n`` calls of ``fn`` under torch.profiler,
    and the number of such launches it saw; (None, 0) if it saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.events():
        if (getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
                and kernel_short_name(ev.name) in names):
            total += ev.time_range.end - ev.time_range.start
            count += 1
    return (total / count if count else None), count


def check_k5(rng):
    """K5 at the smoke map's BA shape: 17788 sorted point keys into an
    8192-row table of 3 columns (the points and the PCG's zp; one thread per
    row), and of 6 columns (the 2-D mapping); bit-equal to ``table[seg]``,
    into a new tensor and into a given buffer. Timed as BA calls it (into
    its buffer) beside ``torch.index_select`` into a buffer, in the same
    run; both also into new tensors."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.kernels import segment_ops as k5

    dev = torch.device(DEV)
    O, N, used = 17788, 8192, 5025
    seg = torch.from_numpy(np.sort(rng.integers(0, used, O)).astype(np.int32)).to(dev)
    distinct = int(torch.unique(seg).numel())
    details, entry = [], None
    for D in (3, 6):
        table = torch.randn((N, D), device=dev)
        buf, lib_buf = table.new_empty((O, D)), table.new_empty((O, D))
        ref = table[seg.long()]
        equal = (bool(torch.equal(k5.sorted_gather_rows(table, seg), ref))
                 and bool(torch.equal(k5.sorted_gather_rows(table, seg, out=buf), ref)))
        ms = cuda_ms(lambda: k5.sorted_gather_rows(table, seg, out=buf), reps=HOST_REPS)
        library_ms = cuda_ms(lambda: torch.index_select(table, 0, seg, out=lib_buf),
                             reps=HOST_REPS)
        ms_new = cuda_ms(lambda: k5.sorted_gather_rows(table, seg), reps=HOST_REPS)
        library_ms_new = cuda_ms(lambda: torch.index_select(table, 0, seg), reps=HOST_REPS)
        plain_ms = cuda_ms(lambda: k5.gather_rows_plain(table, seg), reps=HOST_REPS)
        dev_us, seen = device_us(lambda: k5.sorted_gather_rows(table, seg, out=buf),
                                 {"gather_rows_narrow", "gather_rows_wide"})
        b_ms, b_by = bound(4 * (O + O * D + distinct * D))
        d = dict(rows=O, table=[N, D], distinct_keys=distinct, bit_equal=equal, ms=ms,
                 library_ms=library_ms, ms_new_tensor=ms_new,
                 library_ms_new_tensor=library_ms_new, plain_ms=plain_ms,
                 device_us_per_launch=dev_us, profiled_launches=seen, bound_ms=b_ms,
                 bound_by=b_by)
        details.append(d)
        log("K5", json.dumps(d))
        if not equal:
            raise AssertionError(f"K5 differs from table[seg] at D = {D}")
        if D == 3:
            entry = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=library_ms)
    return entry, details


def _descriptor_sets(rng, n, m, m_live, n_shared):
    """SIFT-like unit descriptors: n queries and an m-row bank whose first
    m_live rows are live and hold noisy copies of n_shared queries."""
    import numpy as np

    def unit(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    q = unit(np.abs(rng.standard_normal((n, 128)))).astype(np.float32)
    bank = np.zeros((m, 128), np.float32)
    bank[:m_live] = unit(np.abs(rng.standard_normal((m_live, 128))))
    rows = rng.choice(m_live, n_shared, replace=False)
    bank[rows] = unit(np.abs(q[:n_shared] + 0.08 * rng.standard_normal((n_shared, 128))))
    mask_b = np.zeros(m, bool)
    mask_b[:m_live] = True
    return q, np.ones(n, bool), bank, mask_b


def check_k2(rng):
    """K2 at the matcher's shapes; returns (entry, details)."""
    import torch

    from fastmatch_tpu_torch.core.containers import Descriptors
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.matching.matcher import BIG, match_pair_plain

    dev = torch.device("cuda")
    details, entry = [], None
    for n, m, m_live in ((2048, 2048, 2048), (2048, 8192, 5000)):
        q, mq, bank, mb = _descriptor_sets(rng, n, m, m_live, 1500)
        da = Descriptors(torch.from_numpy(q).to(dev), torch.from_numpy(mq).to(dev))
        db = Descriptors(torch.from_numpy(bank).to(dev), torch.from_numpy(mb).to(dev))
        a, b = da.data, db.data
        a2m = torch.where(da.mask, (a * a).sum(-1), BIG).contiguous()
        b2m = torch.where(db.mask, (b * b).sum(-1), BIG).contiguous()
        ref = match_pair_plain(da, db)
        for mode in ("exact", "fast"):
            fast = mode == "fast"
            got = k2.match_pair_fused(da, db, precision=mode)
            # The matcher's decisions (valid, and idx where valid).
            agree = ((got.valid == ref.valid)
                     & (~ref.valid | (got.idx == ref.idx))).float().mean().item()
            both = got.valid & ref.valid
            err = (got.dist - ref.dist)[both].abs().max().item() if both.any() else 0.0
            ki1, kd1, kd2, knnb = k2.distance_topk(a, b, b2m, a2m, fast=fast)
            pi1, pd1, pd2, pnnb = k2.distance_topk_plain(a, b, b2m, a2m, fast=fast)
            raw = dict(idx1=(ki1 == pi1).float().mean().item(),
                       nnb=(knnb[db.mask] == pnnb[db.mask]).float().mean().item(),
                       d1=(kd1 - pd1).abs().max().item(), d2=(kd2 - pd2).abs().max().item())
            call = lambda: k2.distance_topk(a, b, b2m, a2m, fast=fast)  # noqa: E731
            ms = cuda_ms(call)
            plain_ms = cuda_ms(lambda: k2.distance_topk_plain(a, b, b2m, a2m, fast=fast))
            us, seen = device_us(call, K2_KERNELS, n=50)
            # The product alone in the operands' type (TF32 off): a yardstick.
            pa, pbt = (a.bfloat16(), b.bfloat16().T) if fast else (a, b.T)
            n_bytes = 4 * (n * 128 + m * 128 + n + m) + 4 * (3 * n + m)
            b_ms, b_by = bound(n_bytes, 2.0 * n * m * 128,
                               PEAK_BF16_FLOPS if fast else PEAK_FP32_FLOPS)
            d = dict(shape=[n, m, 128], mode=mode, decision_agreement=agree,
                     n_valid=int(ref.valid.sum()), max_abs_err=err, raw=raw, ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     device_us_per_call=us * seen / 50 if seen else None,
                     profiled_launches=seen, host_us_per_call=host_us(call, 200),
                     product_only_ms=cuda_ms(lambda: pa @ pbt))
            details.append(d)
            log("K2", json.dumps(d))
            if mode == "exact" and agree != 1.0:
                raise AssertionError(f"K2 exact decisions differ at {n}x{m}: {agree}")
            if mode == "fast" and agree < 0.99:
                raise AssertionError(f"K2 fast agreement {agree} < 0.99 at {n}x{m}")
            if mode == "exact" and m == 8192:
                entry = dict(max_abs_err=max(err, raw["d1"], raw["d2"]), ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None, product_only_ms=d["product_only_ms"])
    return entry, details


def _quarter_sets(rng, n, m, d=128, dead_every=5):
    """Queries and a bank whose entries are multiples of 1/4 (exact in bf16,
    and every dot product exact in fp32 whatever the summation order), so
    the kernels must reproduce their plain versions bit for bit, ties
    included: bank row j repeats row j - 1 at every multiple of 64 (each
    wgmma tile, SIMT tile and split boundary), queries 0 and 1 are equal,
    and every ``dead_every``-th bank row is dead."""
    import numpy as np

    a = rng.integers(0, 4, (n, d)).astype(np.float32) / 4
    b = rng.integers(0, 4, (m, d)).astype(np.float32) / 4
    if n > 1:
        a[1] = a[0]
    for j in range(64, m, 64):
        b[j] = b[j - 1]
    mask_b = np.ones(m, bool)
    mask_b[2::dead_every] = False
    return a, b, mask_b


def check_edges(rng):
    """The tile engine's edges, each held to the plain version bit for bit
    on exact-arithmetic inputs (``_quarter_sets``): K2 at n = 1, at m = 1,
    127, 129 and 8193, at D = 256, and in the depth loop at D = 288 (a
    half last bf16 chunk) and 512 with m = 129, exact and fast; K1 at
    capacity 2047 with one all-masked bank pair, at 2 pairs of 256 queries
    (a split bank, with a run of dead tiles inside it), and in the depth
    loop at D = 384, exact and fast; K1 binary at 4, 8 and 64 words and in
    the depth loop at 68 (a half last chunk) and 128 words (the last 112
    rows of each set dead), identical to its plain version (idx at live
    queries) and to the popcount matcher but for column ties
    (``_column_ties_only``)."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.containers import BinaryDescriptors, Descriptors
    from fastmatch_tpu_torch.interop import binary_descriptors_from_arrays
    from fastmatch_tpu_torch.kernels import batch_match as k1
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.matching import hamming
    from fastmatch_tpu_torch.matching.matcher import BIG, stack_matches

    dev = torch.device(DEV)
    out, bad = [], []

    def same(x, y):
        return bool(torch.equal(x, y))

    for n, m, d in ((1, 300, 128), (300, 1, 128), (2048, 127, 128), (2048, 129, 128),
                    (300, 8193, 128), (500, 1000, 256), (2048, 129, 288), (2048, 129, 512)):
        a, b, mb = _quarter_sets(rng, n, m, d)
        a, b, mb = (torch.from_numpy(x).to(dev) for x in (a, b, mb))
        a2m = (a * a).sum(-1).contiguous()
        b2m = torch.where(mb, (b * b).sum(-1), BIG).contiguous()
        for fast in (False, True):
            got = k2.distance_topk(a, b, b2m, a2m, fast=fast)
            ref = k2.distance_topk_plain(a, b, b2m, a2m, fast=fast)
            ok = all(same(x, y) for x, y in zip(got, ref))
            out.append(dict(kernel="K2", shape=[n, m, d], fast=fast, identical=ok))
            if not ok:
                bad.append(out[-1])

    def k1_case(what, B, n, m, dead_rows=None, masked_pair=None, d=128):
        qs, bs, ma, mbs = [], [], [], []
        for _ in range(B):
            a, b, mb = _quarter_sets(rng, n, m, d)
            if dead_rows is not None:
                mb[dead_rows] = False
            qs.append(a), bs.append(b), ma.append(np.ones(n, bool)), mbs.append(mb)
        if masked_pair is not None:
            mbs[masked_pair][:] = False
        t = lambda x: torch.from_numpy(np.stack(x)).to(dev)  # noqa: E731
        da, db = Descriptors(t(qs), t(ma)), Descriptors(t(bs), t(mbs))
        for fast in (False, True):
            got = k1.match_batch_fused(da, db, ratio=1.0, fast=fast)
            ref = k1.match_batch_fused_plain(da, db, ratio=1.0, fast=fast)
            ok = all(same(x, y) for x, y in zip(got, ref))
            out.append(dict(kernel="K1", case=what, batch=B, shape=[n, m], fast=fast,
                            identical=ok, n_valid=int(ref.valid.sum())))
            if not ok:
                bad.append(out[-1])

    k1_case("capacity 2047, pair 1 all masked", 4, 2047, 2047, masked_pair=1)
    k1_case("split bank, bank rows 512-767 dead", 2, 256, 2048, dead_rows=slice(512, 768))
    k1_case("depth loop, D = 384, bank rows 128-191 dead", 2, 300, 700,
            dead_rows=slice(128, 192), d=384)

    for W in (4, 8, 64, 68, 128):
        B, cap = 2, 512
        words = rng.integers(0, 2 ** 32, size=(B, cap, W), dtype=np.uint64).astype(np.uint32)
        other = words[:, rng.permutation(cap)].copy()
        other[:, ::3] = rng.integers(0, 2 ** 32, size=other[:, ::3].shape,
                                     dtype=np.uint64).astype(np.uint32)
        mask = np.ones((B, cap), bool)
        mask[:, 400:] = False
        A = binary_descriptors_from_arrays(words, mask, dev)
        Bk = binary_descriptors_from_arrays(other, mask, dev)
        got = hamming.match_batch_hamming(A, Bk, backend="mxu", device=DEV)
        plain = hamming._quarter(k1.match_batch_fused_plain(
            Descriptors(A.packed, A.mask), Descriptors(Bk.packed, Bk.mask),
            ratio=hamming._ratio_sqrt(0.8), fast=True, const_sq_norm=32.0 * W, binary=True))
        anchor = stack_matches(hamming.match_pair_hamming_plain(
            BinaryDescriptors(pa, ma), BinaryDescriptors(pb, mb))
            for pa, ma, pb, mb in zip(A.packed, A.mask, Bk.packed, Bk.mask))
        ties, ties_only = _column_ties_only(got, anchor, A, Bk)
        # The plain version unpacks dead rows to zeros, where the kernel
        # (like the JAX kernel) reads their words: a dead query's raw idx
        # may differ; its decision (never valid) may not.
        ok = (same(got.valid, plain.valid) and same(got.dist, plain.dist)
              and same(got.idx[A.mask], plain.idx[A.mask]) and ties_only)
        out.append(dict(kernel="K1 binary", words=W, batch=B, capacity=cap, identical=ok,
                        column_ties=ties, n_valid=int(anchor.valid.sum())))
        if not ok or int(anchor.valid.sum()) == 0:
            bad.append(out[-1])
    log("edges", json.dumps(out))
    if bad:
        raise AssertionError(f"tile engine edge cases differ from the plain versions: {bad}")
    return out


def check_depth(rng):
    """The tile engine's depth loop (rows deeper than 256 values or 64
    packed words) at the matchers' sizes, against the plain versions:

    - K2 at 2048 x 8192 with D = 384 and 512 on noisy-copy banks
      (``_descriptor_sets``), exact (decisions identical to
      ``match_pair_plain``) and fast (agreement >= 0.99);
    - K1 at 64 x 2048 x 2048 with D = 384 (1500 live, noisy-copy banks),
      exact (decisions identical) and fast (agreement >= 0.99 with the
      exact plain version);
    - K1 binary at 16 and at 128 words (8 pairs of 2048, half the rows
      re-drawn): identical to its plain version, the JAX package's "mxu"
      semantics (value-based mutual test), and to the popcount matcher but
      for column ties;
    - ``match_pair_hamming(backend="auto")`` at 512 bits (K2 fast at D =
      512 on +-1 vectors): identical to the popcount matcher.

    Each with its wrapper ms, device us per call (profiler), plain ms and
    bound. Returns the details."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.containers import BinaryDescriptors, Descriptors
    from fastmatch_tpu_torch.interop import (batched_descriptors_from_numpy,
                                             binary_descriptors_from_arrays)
    from fastmatch_tpu_torch.kernels import batch_match as k1
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.matching import hamming
    from fastmatch_tpu_torch.matching.matcher import BIG, match_pair_plain, stack_matches

    dev = torch.device(DEV)
    details, bad = [], []

    def record(rec, ok):
        details.append(rec)
        log("depth", json.dumps(rec))
        if not ok:
            bad.append(rec)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    n, m, m_live = 2048, 8192, 5000
    for D in (384, 512):
        q = unit(np.abs(rng.standard_normal((n, D))))
        bank = np.zeros((m, D), np.float32)
        bank[:m_live] = unit(np.abs(rng.standard_normal((m_live, D))))
        rows = rng.choice(m_live, 1500, replace=False)
        bank[rows] = unit(np.abs(q[:1500] + 0.08 * np.sqrt(128 / D)
                                 * rng.standard_normal((1500, D))))
        mb = np.zeros(m, bool)
        mb[:m_live] = True
        da = Descriptors(torch.from_numpy(q).to(dev), torch.ones(n, dtype=torch.bool, device=dev))
        db = Descriptors(torch.from_numpy(bank).to(dev), torch.from_numpy(mb).to(dev))
        a, b = da.data, db.data
        a2m = (a * a).sum(-1).contiguous()
        b2m = torch.where(db.mask, (b * b).sum(-1), BIG).contiguous()
        ref = match_pair_plain(da, db)
        for mode in ("exact", "fast"):
            fast = mode == "fast"
            got = k2.match_pair_fused(da, db, precision=mode)
            agree = _agreement(got, ref, da.mask)
            call = lambda: k2.distance_topk(a, b, b2m, a2m, fast=fast)  # noqa: E731
            us, seen = device_us(call, K2_KERNELS, n=20)
            b_ms, b_by = bound(4 * (n * D + m * D + n + m) + 4 * (3 * n + m), 2.0 * n * m * D,
                               PEAK_BF16_FLOPS if fast else PEAK_FP32_FLOPS)
            record(dict(kernel="K2", shape=[n, m, D], mode=mode, decision_agreement=agree,
                        n_valid=int(ref.valid.sum()), ms=cuda_ms(call),
                        plain_ms=cuda_ms(lambda: k2.distance_topk_plain(a, b, b2m, a2m,
                                                                         fast=fast),
                                         batches=3, reps=3),
                        device_us_per_call=us * seen / 20 if seen else None,
                        profiled_launches=seen, bound_ms=b_ms, bound_by=b_by),
                   (agree == 1.0 if mode == "exact" else agree >= 0.99)
                   and int(ref.valid.sum()) >= K1_MIN_VALID // 2)

    B, cap, D = CONFIG2["batch"], CONFIG2["capacity"], 384
    a_sets, b_sets = _config2_sets(rng, B, matched=True, dim=D)
    da = batched_descriptors_from_numpy(a_sets, cap, dev)
    db = batched_descriptors_from_numpy(b_sets, cap, dev)
    ref = k1.match_batch_fused_plain(da, db)
    for mode in ("exact", "fast"):
        fast = mode == "fast"
        got = k1.match_batch_fused(da, db, fast=fast)
        agree = _agreement(got, ref, da.mask)
        call = lambda: k1.match_batch_fused(da, db, fast=fast)  # noqa: E731
        us, seen = device_us(call, K1_KERNELS, n=5)
        b_ms, b_by = k1_bound(da.mask, db.mask, 2 * D, (2 if fast else 4) * D,
                              PEAK_BF16_FLOPS if fast else PEAK_FP32_FLOPS)
        record(dict(kernel="K1", batch=B, shape=[cap, cap, D], mode=mode,
                    decisions_identical=_decisions_equal(got, ref) if not fast else None,
                    decision_agreement=agree, n_valid=int(ref.valid.sum()),
                    ms=cuda_ms(call, reps=3),
                    plain_ms=cuda_ms(lambda: k1.match_batch_fused_plain(da, db, fast=fast),
                                     batches=3, reps=1),
                    device_us_per_call=us * seen / 5 if seen else None,
                    profiled_launches=seen, bound_ms=b_ms, bound_by=b_by),
               (agree == 1.0 and _decisions_equal(got, ref)) if not fast
               else (agree >= 0.99 and int(got.valid.sum()) >= K1_MIN_VALID))
    del da, db, ref

    Bb = 8
    for W in (16, 128):
        words = rng.integers(0, 2 ** 32, size=(Bb, cap, W), dtype=np.uint64).astype(np.uint32)
        other = words.copy()
        other[:, :cap // 2] = rng.integers(0, 2 ** 32, size=(Bb, cap // 2, W),
                                           dtype=np.uint64).astype(np.uint32)
        other = other[:, rng.permutation(cap)]
        ones = np.ones((Bb, cap), bool)
        A = binary_descriptors_from_arrays(words, ones, dev)
        Bk = binary_descriptors_from_arrays(other, ones, dev)
        call = lambda: hamming.match_batch_hamming(A, Bk, backend="mxu", device=DEV)  # noqa
        got = call()
        plain = hamming._quarter(k1.match_batch_fused_plain(
            Descriptors(A.packed, A.mask), Descriptors(Bk.packed, Bk.mask),
            ratio=hamming._ratio_sqrt(0.8), fast=True, const_sq_norm=32.0 * W, binary=True))
        anchor = stack_matches(hamming.match_pair_hamming_plain(
            BinaryDescriptors(pa, ma), BinaryDescriptors(pb, mb))
            for pa, ma, pb, mb in zip(A.packed, A.mask, Bk.packed, Bk.mask))
        identical = all(bool(torch.equal(x, y)) for x, y in zip(got, plain))
        ties, ties_only = _column_ties_only(got, anchor, A, Bk)
        us, seen = device_us(call, K1_KERNELS, n=10)
        b_ms, b_by = k1_bound(A.mask, Bk.mask, 2 * 32 * W, 32, PEAK_INT_OPS)
        n_valid = int(anchor.valid.sum())
        record(dict(kernel="K1 binary", batch=Bb, shape=[cap, cap], words=W,
                    identical_to_plain=identical, column_ties=ties,
                    popcount_ties_only=ties_only, n_valid=n_valid, ms=cuda_ms(call),
                    plain_ms=cuda_ms(lambda: k1.match_batch_fused_plain(
                        Descriptors(A.packed, A.mask), Descriptors(Bk.packed, Bk.mask),
                        ratio=hamming._ratio_sqrt(0.8), fast=True, const_sq_norm=32.0 * W,
                        binary=True), batches=3, reps=1),
                    device_us_per_call=us * seen / 10 if seen else None,
                    profiled_launches=seen, bound_ms=b_ms, bound_by=b_by),
               identical and ties_only and n_valid >= K1_MIN_VALID)

    words = rng.integers(0, 2 ** 32, size=(cap, 16), dtype=np.uint64).astype(np.uint32)
    other = words[rng.permutation(cap)].copy()
    other[::2] = rng.integers(0, 2 ** 32, size=other[::2].shape,
                              dtype=np.uint64).astype(np.uint32)
    ones = np.ones(cap, bool)
    A = binary_descriptors_from_arrays(words, ones, dev)
    Bk = binary_descriptors_from_arrays(other, ones, dev)
    before = k2.distance_topk.launches
    got = hamming.match_pair_hamming(A, Bk, backend="auto", device=DEV)
    launched = k2.distance_topk.launches - before
    anchor = hamming.match_pair_hamming_plain(A, Bk)
    identical = all(bool(torch.equal(x, y)) for x, y in zip(got, anchor))
    record(dict(kernel="K2 via match_pair_hamming(auto)", shape=[cap, cap], bits=512,
                k2_launches=launched, identical_to_popcount=identical,
                n_valid=int(anchor.valid.sum())),
           identical and launched == 1 and int(anchor.valid.sum()) > 0)
    if bad:
        raise AssertionError(f"depth loop checks failed: {bad}")
    return details


def sass_check():
    """Tensor-core instructions in the built K1 and K2 libraries, per
    kernel (``cuobjdump -sass``): each engine instance's mode is its first
    template argument (0 exact, 1 bf16, 2 binary). Fast instances must
    hold HGMMA, binary ones IGMMA, and exact ones (and the finalize
    kernels) no tensor-core instruction at all (HMMA, IMMA, HGMMA, IGMMA:
    TF32 runs on HMMA)."""
    import re
    import shutil

    from fastmatch_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts, bad = {}, []
    for lib in ("batch_match", "distance_topk"):
        sass = subprocess.run([tool, "-sass", _build._target(lib)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = f"{lib}:{line.split('Function :')[1].strip()}"
                counts[fn] = dict(HGMMA=0, IGMMA=0, HMMA=0, IMMA=0)
            elif fn is not None:
                for op in counts[fn]:
                    counts[fn][op] += f" {op}." in line or f" {op} " in line
    for fn, c in counts.items():
        mode = re.search(r"match_tilesILi(\d)E", fn)
        mode = int(mode.group(1)) if mode else None
        tensor = sum(c.values())
        want = {1: c["HGMMA"] > 0, 2: c["IGMMA"] > 0}.get(mode, tensor == 0)
        if not want:
            bad.append((fn, c))
    log("sass", json.dumps(counts))
    if bad or not any("match_tilesILi1" in f for f in counts) or not any(
            "match_tilesILi2" in f for f in counts):
        raise AssertionError(f"SASS check failed: {bad}")
    return counts


def _k3_flat_index(seg):
    """int64 flat indices into ``seg.stack`` of every element of the
    segment's (K, P, P) windows, clamped as K3 clamps (the replicate pad
    folded into the reads); written out here apart from the port's plain
    version, for the bound and for ``torch.take``."""
    import torch

    L, H, W = seg.stack.shape
    P, pad = seg.patch, seg.pad
    lyx = seg.lyx.long()
    lv = lyx[:, 0].clamp(0, L - 1)
    y0 = lyx[:, 1].clamp(0, H + 2 * pad - P) - pad
    x0 = lyx[:, 2].clamp(0, W + 2 * pad - P) - pad
    r = torch.arange(P, device=seg.stack.device)
    rows = (y0[:, None] + r).clamp(0, H - 1)
    cols = (x0[:, None] + r).clamp(0, W - 1)
    return (lv[:, None, None] * H + rows[:, :, None]) * W + cols[:, None, :]


def _k3_bytes(segments):
    """Bytes a K3 call must move: every window element written once, each
    start row read once, and each stack element that some window covers read
    once (segments on one stack share their reads)."""
    import torch

    touched = {}
    for seg in segments:
        t = touched.setdefault(seg.stack.data_ptr(), torch.zeros(
            seg.stack.numel(), dtype=torch.bool, device=seg.stack.device))
        t[_k3_flat_index(seg).reshape(-1)] = True
    written = sum(4 * seg.lyx.shape[0] * seg.patch ** 2 + 12 * seg.lyx.shape[0]
                  for seg in segments)
    return written + sum(4 * int(t.sum()) for t in touched.values())


def _k3_same(got, ref):
    """Two lists of tensors equal bit for bit, shapes included."""
    import torch

    return len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref))


def _k3_frame_sets(dev):
    """The K3 segments of one rendered 640x480 smoke frame, as the detection
    stages of ``detect_and_describe`` (SIFT's 8) and
    ``detect_and_describe_orb`` (ORB's 4) hand them to the kernel."""
    import torch

    from fastmatch_tpu_torch.features import orb, sift

    _, views = render_smoke_scene(1)
    img = torch.as_tensor(views[0], dtype=torch.float32).to(dev)
    return {"sift_frame": sift._detect(img, sift.SIFTConfig())[1],
            "orb_frame": orb._detect(img, orb.ORBConfig())[1]}


def _k3_klt_sets(dev):
    """The K3 segments of KLT tracking one rendered 640x480 smoke pair (frames
    0 and 1), as ``track_pyramids`` hands them to the kernel, recorded
    from a real call: at capacities 512 (VO) and 1024 (``flow``), the
    template launch (every level's 16 px set, 3 one-level stacks) and the
    target launch of each level (32 px, from the coarser level's flow)."""
    import torch

    from fastmatch_tpu_torch.features import klt

    _, views = render_smoke_scene(2)
    cfg = klt.KLTConfig()
    p0 = klt.build_pyramid(views[0], cfg, dev)
    p1 = klt.build_pyramid(views[1], cfg, dev)
    out = {}
    real = klt.gather_patch_sets
    for cap in (512, 1024):
        calls = []

        def record(sets):
            calls.append([klt.PatchSet(s.stack, s.lyx.clone(), s.patch, s.pad) for s in sets])
            return real(sets)

        kps = klt.shi_tomasi(p0[0], capacity=cap, device=dev)
        klt.gather_patch_sets = record
        try:
            klt.track_pyramids(p0, p1, kps.xy, kps.mask, cfg, dev)
        finally:
            klt.gather_patch_sets = real
        torch.cuda.synchronize()
        out[f"klt_templates_K{cap}"] = calls[0]
        for l, sets in zip(range(cfg.levels - 1, -1, -1), calls[1:]):
            out[f"klt_targets_level{l}_K{cap}"] = sets
    return out


def _k3_edge_sets(rng, dev):
    """(name, segments, launches a call) of K3's edge cases, with starts
    beyond both edges of each padded stack and levels out of range."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.kernels import patch_gather as k3

    def seg(L, H, W, K, P, pad, far=False):
        Hp, Wp = H + 2 * pad, W + 2 * pad
        lyx = np.column_stack([rng.integers(-1, L + 1, K), rng.integers(-P - 4, Hp + 4, K),
                               rng.integers(-P - 4, Wp + 4, K)])
        if far:
            lyx[:, 1:] = rng.choice([-10 ** 6, 10 ** 6], size=(K, 2))
        stack = torch.from_numpy(rng.random((L, H, W), dtype=np.float32)).to(dev)
        return k3.PatchSet(stack, torch.from_numpy(lyx.astype(np.int32)).to(dev), P, pad)

    m = k3.MAX_SEGMENTS

    def many(n):
        out = []
        for _ in range(n):
            P = int(rng.choice([1, 5, 12, 19]))
            pad = int(rng.integers(0, 3)) + max(0, (P - 11) // 2)
            out.append(seg(int(rng.integers(1, 4)), 12, 14, int(rng.integers(0, 9)), P, pad))
        return out

    return [
        ("K=0", [seg(2, 30, 40, 0, 19, 9)], 0),
        ("K=0 beside work", [seg(2, 30, 40, 0, 19, 9), seg(2, 30, 40, 7, 19, 9),
                             seg(2, 30, 40, 0, 88, 30)], 1),
        ("K*P*P not a multiple of 4", [seg(2, 30, 40, 3, 19, 9), seg(1, 20, 30, 5, 13, 2),
                                       seg(3, 33, 37, 1, 35, 1)], 1),
        ("P=1", [seg(3, 10, 12, 37, 1, 0), seg(3, 10, 12, 9, 1, 4)], 1),
        ("P=H+2pad", [seg(6, 30, 41, 50, 34, 2), seg(1, 20, 24, 21, 40, 10),
                      seg(2, 60, 90, 11, 64, 2), seg(1, 84, 100, 9, 88, 2),
                      seg(1, 1, 1, 4, 19, 9)], 1),
        ("clamped starts, both sides", [seg(6, 60, 80, 300, 19, 9, far=True),
                                        seg(6, 60, 80, 300, 88, 14, far=True),
                                        seg(1, 50, 70, 200, 40, 20, far=True)], 1),
        (f"{m} segments", many(m), 1),
        (f"{m + 1} segments", many(m + 1), 2),
    ]


def check_k3(rng):
    """K3 (``gather_patch_sets``, one launch a call over up to MAX_SEGMENTS
    segments), every output bit-equal to its plain version:

    - one-segment, unpadded launches (``gather_patches``) at SIFT's
      orientation and descriptor shapes of a 640x480 frame at each of the 4
      octaves (2048 >> o keypoints; stacks pre-padded by R + 1 = 9 and cut
      into 19x19 patches, pre-padded by 2 and cut into 88x88, 64x64 at
      octave 3): device us per launch and bound at every octave, wrapper
      and plain ms and ``library_ms`` (``torch.take``, also bit-equal) at
      octave 0;
    - the real segment sets of a rendered 640x480 frame, SIFT's 8 and ORB's
      4 from the detection stage, also held against ``torch.take`` on the
      clamped flat index: wrapper ms, device us per launch (one launch a
      call), bound, plain ms, host us per call and ``library_ms`` (the sum
      over segments of ``torch.take`` on a precomputed int64 flat index);
    - KLT's sets (``_k3_klt_sets``): the template launch and each level's
      target launch of a rendered 640x480 pair at 512 and 1024 corners,
      bit-equal to the plain version and to ``torch.take``, with the same
      figures as the frame sets;
    - edge cases (``_k3_edge_sets``), with the launches each call makes.

    The kernels line's entry is the SIFT frame set's."""
    import torch

    from fastmatch_tpu_torch.kernels import patch_gather as k3

    dev = torch.device("cuda")
    details, entry = [], None
    for what, pad, P0 in (("orientation", 9, 19), ("descriptor", 2, 88)):
        for o in range(4):
            L, H, W = 6, (480 >> o) + 2 * pad, (640 >> o) + 2 * pad
            P, K = min(P0, H, W), max(2048 >> o, 128)
            stack = torch.rand((L, H, W), device=dev)
            lyx = torch.stack([torch.randint(1, 4, (K,), device=dev),
                               torch.randint(-4, H - P + 4, (K,), device=dev),
                               torch.randint(-4, W - P + 4, (K,), device=dev)], 1)
            lyx = lyx.to(torch.int32).contiguous()
            got = k3.gather_patches(stack, lyx, P)
            ref = k3.gather_patches_plain(stack, lyx, P)
            equal = bool(torch.equal(got, ref))
            us, seen = device_us(lambda: k3.gather_patches(stack, lyx, P), K3_KERNELS, n=50)
            b_ms, b_by = bound(_k3_bytes([k3.PatchSet(stack, lyx, P, 0)]))
            d = dict(what=what, octave=o, stack=[L, H, W], K=K, P=P, bit_equal=equal,
                     device_us_per_launch=us, profiled_launches=seen, bound_ms=b_ms,
                     bound_by=b_by)
            if o == 0:
                d["ms"] = cuda_ms(lambda: k3.gather_patches(stack, lyx, P))
                d["plain_ms"] = cuda_ms(lambda: k3.gather_patches_plain(stack, lyx, P))
                # torch.take on a precomputed int64 flat index: the one call
                # that computes the same gather (a yardstick).
                idx = _k3_flat_index(k3.PatchSet(stack, lyx, P, 0))
                d["library_ms"] = cuda_ms(lambda: torch.take(stack, idx))
                d["equal_to_take"] = bool(torch.equal(got, torch.take(stack, idx)))
                equal = equal and d["equal_to_take"]
            details.append(d)
            log("K3", json.dumps(d))
            if not equal:
                raise AssertionError(f"K3 {what} patches differ from the plain version")

    for what, sets in _k3_frame_sets(dev).items():
        got = k3.gather_patch_sets(sets)
        ref = k3.gather_patch_sets_plain(sets)
        idx = [_k3_flat_index(s) for s in sets]
        take = [torch.take(s.stack, i) for s, i in zip(sets, idx)]
        equal, equal_take = _k3_same(got, ref), _k3_same(got, take)
        before = k3.gather_patch_sets.launches
        us, seen = device_us(lambda: k3.gather_patch_sets(sets), K3_KERNELS, n=50)
        launched = k3.gather_patch_sets.launches - before
        b_ms, b_by = bound(_k3_bytes(sets))
        d = dict(what=what, segments=[dict(stack=list(s.stack.shape), K=s.lyx.shape[0],
                                           P=s.patch, pad=s.pad) for s in sets],
                 bit_equal=equal, equal_to_take=equal_take, device_us_per_launch=us,
                 profiled_launches=seen, wrapper_launches=launched, bound_ms=b_ms,
                 bound_by=b_by, bytes_written=sum(4 * s.lyx.shape[0] * s.patch ** 2 for s in sets),
                 ms=cuda_ms(lambda: k3.gather_patch_sets(sets)),
                 plain_ms=cuda_ms(lambda: k3.gather_patch_sets_plain(sets), batches=3, reps=3),
                 library_ms=cuda_ms(lambda: [torch.take(s.stack, i) for s, i in zip(sets, idx)]),
                 host_us=host_us(lambda: k3.gather_patch_sets(sets), n=500))
        d["share_of_bound"] = b_ms * 1e3 / us if us else None
        details.append(d)
        log("K3", json.dumps(d))
        # One launch a call, by the wrapper's counter over the warm-up and
        # the 50 profiled calls; the profiler, which may drop events, must
        # see at least one and no more than 50.
        if not (equal and equal_take) or launched != 51 or not 1 <= seen <= 50:
            raise AssertionError(f"K3 {what}: bit-equal to plain {equal}, to torch.take "
                                 f"{equal_take}, {launched} launches in 51 calls "
                                 f"(the profiler saw {seen})")
        if what == "sift_frame":
            entry = dict(max_abs_err=0.0, ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=b_ms,
                         bound_by=b_by, library_ms=d["library_ms"])

    for what, sets in _k3_klt_sets(dev).items():
        got = k3.gather_patch_sets(sets)
        ref = k3.gather_patch_sets_plain(sets)
        idx = [_k3_flat_index(s) for s in sets]
        take = [torch.take(s.stack, i) for s, i in zip(sets, idx)]
        equal, equal_take = _k3_same(got, ref), _k3_same(got, take)
        before = k3.gather_patch_sets.launches
        us, seen = device_us(lambda: k3.gather_patch_sets(sets), K3_KERNELS, n=50)
        launched = k3.gather_patch_sets.launches - before
        b_ms, b_by = bound(_k3_bytes(sets))
        d = dict(what=what, segments=[dict(stack=list(s.stack.shape), K=s.lyx.shape[0],
                                           P=s.patch, pad=s.pad) for s in sets],
                 bit_equal=equal, equal_to_take=equal_take, device_us_per_launch=us,
                 profiled_launches=seen, wrapper_launches=launched, bound_ms=b_ms,
                 bound_by=b_by, ms=cuda_ms(lambda: k3.gather_patch_sets(sets)),
                 plain_ms=cuda_ms(lambda: k3.gather_patch_sets_plain(sets)),
                 library_ms=cuda_ms(lambda: [torch.take(s.stack, i) for s, i in zip(sets, idx)]),
                 host_us=host_us(lambda: k3.gather_patch_sets(sets), n=500))
        details.append(d)
        log("K3", json.dumps(d))
        # One launch a call, by the wrapper's counter over the warm-up and
        # the 50 profiled calls; the profiler, which may drop events, must
        # see at least one and no more than 50.
        if not (equal and equal_take) or launched != 51 or not 1 <= seen <= 50:
            raise AssertionError(f"K3 {what}: bit-equal to plain {equal}, to torch.take "
                                 f"{equal_take}, {launched} launches in 51 calls "
                                 f"(the profiler saw {seen})")

    bad = []
    for what, sets, want in _k3_edge_sets(rng, dev):
        before = k3.gather_patch_sets.launches
        got = k3.gather_patch_sets(sets)
        made = k3.gather_patch_sets.launches - before
        torch.cuda.synchronize()
        ok = _k3_same(got, k3.gather_patch_sets_plain(sets)) and made == want
        details.append(dict(what=f"edge: {what}", segments=len(sets), launches=made, ok=ok))
        if not ok:
            bad.append((what, made, want))
    log("K3 edges", json.dumps([d for d in details if d["what"].startswith("edge")]))
    if bad:
        raise AssertionError(f"K3 edge cases (name, launches, expected) failed: {bad}")
    return entry, details


def _k4_cases(rng):
    """(name, keys, n_segments, D, BA shape?) of K4's checks: the smoke
    map's last BA solve (17788 live observations, 5025 of 8192 points, 50 of
    64 cameras) at each width BA sums, then the edge cases."""
    import numpy as np

    O = 17788

    def pts():
        return rng.integers(0, 5025, O)

    def cams(rows=O):
        return rng.integers(0, 50, rows)

    return [
        ("point D=3", pts(), 8192, 3, True),
        ("point D=9", pts(), 8192, 9, True),
        ("camera D=6", cams(), 64, 6, True),
        ("camera D=36", cams(), 64, 36, True),
        ("all rows in one segment", np.full(O, 4000), 8192, 3, False),
        ("keys -3..n+3, points", rng.integers(-3, 8192 + 4, O), 8192, 3, False),
        ("keys -3..n+3, cameras", rng.integers(-3, 64 + 4, O), 64, 6, False),
        ("n_segments = 1", rng.integers(-1, 2, O), 1, 6, False),
        ("200 of 8192 segments used",
         rng.choice(8192, 200, replace=False)[rng.integers(0, 200, O)], 8192, 3, False),
        ("map capacity: 65536 rows, 64 cameras", rng.integers(0, 64, 65536), 64, 36, False),
    ]


# K4's bound: K4's error over the largest |sum| against the plain
# version summed in float64.
K4_RTOL = 1e-5


def check_k4(rng):
    """K4 on ``_k4_cases``: relative error <= 1e-5 against the plain version
    summed in float64 (the fp32 plain version adds by float atomics in no
    fixed order, so its own error, recorded as ``plain_rel_err``, reaches
    1e-5 on one 17788-row segment) and two runs bit-identical in every
    case, the first run with the offsets and the longest length given as
    BA gives them, the second building them itself. Both variants (short, long) must run. Times
    (wrapper ms by CUDA events; device us per launch by the profiler at the
    BA shapes) with the offsets given, beside ``torch.segment_reduce``; the
    edge cases' times are of 3 batches of 20 calls."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.kernels import segment_ops as k4

    dev = torch.device(DEV)
    details, entry = [], None
    k4.sorted_segment_sum.by_variant.update(short=0, long=0)
    for what, keys, n_seg, D, ba_shape in _k4_cases(rng):
        seg = torch.from_numpy(np.sort(keys).astype(np.int32)).to(dev)
        O = seg.shape[0]
        vals = torch.randn((O, D), device=dev)
        off = k4.segment_offsets(seg, n_seg)
        max_len = int(k4.segment_lengths(off).max())
        before = dict(k4.sorted_segment_sum.by_variant)
        got = k4.sorted_segment_sum(vals, seg, n_seg, off, max_len)
        variant = [k for k, v in k4.sorted_segment_sum.by_variant.items() if v > before[k]]
        again = k4.sorted_segment_sum(vals, seg, n_seg)
        ref = k4.segment_sum_plain(vals.double(), seg, n_seg)
        scale = ref.abs().max().clamp(min=1e-30)
        rel = ((got - ref).abs().max() / scale).item()
        plain_rel = ((k4.segment_sum_plain(vals, seg, n_seg) - ref).abs().max() / scale).item()
        same = bool(torch.equal(got, again))
        lo, hi = off[[0, -1]].tolist()
        inside, lengths = vals[lo:hi], k4.segment_lengths(off).long()
        # The edge cases are timed at less depth than BA's shapes.
        depth = dict(batches=7, reps=HOST_REPS) if ba_shape else dict(batches=3, reps=20)
        ms = cuda_ms(lambda: k4.sorted_segment_sum(vals, seg, n_seg, off, max_len), **depth)
        plain_ms = cuda_ms(lambda: k4.segment_sum_plain(vals, seg, n_seg), **depth)
        library_ms = cuda_ms(lambda: torch.segment_reduce(inside, "sum", lengths=lengths),
                             **depth)
        dev_us, seen = (device_us(lambda: k4.sorted_segment_sum(vals, seg, n_seg, off, max_len),
                                  {"segsum_short", "segsum_long"})
                        if ba_shape else (None, 0))
        # The rows inside [0, n) and the offsets read once, the sums written once.
        b_ms, b_by = bound(4 * ((hi - lo) * D + n_seg + 1 + n_seg * D), (hi - lo) * D)
        d = dict(what=what, rows=O, cols=D, segments=n_seg, rows_in_range=hi - lo,
                 longest=max_len, variant=variant, rel_err=rel, plain_rel_err=plain_rel,
                 max_abs_err=(got - ref).abs().max().item(), bit_identical_runs=same,
                 ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 device_us_per_launch=dev_us, profiled_launches=seen, bound_ms=b_ms,
                 bound_by=b_by)
        details.append(d)
        log("K4", json.dumps(d))
        if rel > K4_RTOL or not same:
            raise AssertionError(f"K4 {what}: rel err {rel}, bit-identical runs {same}")
        if what == "point D=9":
            entry = dict(max_abs_err=d["max_abs_err"], ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
    ran = dict(k4.sorted_segment_sum.by_variant)
    log("K4 variants launched", json.dumps(ran))
    if min(ran.values()) <= 0:
        raise AssertionError(f"K4: a variant never ran: {ran}")
    return entry, details


def host_breakdown():
    """Host microseconds per call of each step of the K5 and K4 wrappers at
    the BA shapes (17788 keys into 8192 x 3; point-keyed sum at D = 3 with
    the offsets given), each the mean over 10,000 back-to-back calls by
    ``time.perf_counter_ns`` (``host_us``), beside the costlier forms that
    the wrappers no longer take (a ``torch.empty`` given a device, a
    ``torch.cuda.Stream`` object) and the library calls. ``loop`` is the
    timing loop's own cost, included in every other figure."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.kernels import _build
    from fastmatch_tpu_torch.kernels import segment_ops as ops

    n_calls = 10_000

    def per_call_us(fn):
        return host_us(fn, n_calls)

    rng = np.random.default_rng(1)
    dev = torch.device(DEV)
    O, N, D = 17788, 8192, 3
    seg = torch.from_numpy(np.sort(rng.integers(0, 5025, O)).astype(np.int32)).to(dev)
    table = torch.randn((N, D), device=dev)
    buf, lib_buf = table.new_empty((O, D)), table.new_empty((O, D))
    gather = _build.entry("gather_rows", "fm_gather_rows", ops._ARGTYPES)
    ptrs = (table.data_ptr(), seg.data_ptr(), buf.data_ptr())
    stream = _build.stream_of(table)
    k5 = dict(
        loop=per_call_us(lambda: None),
        wrapper_into_buffer=per_call_us(lambda: ops.sorted_gather_rows(table, seg, out=buf)),
        wrapper=per_call_us(lambda: ops.sorted_gather_rows(table, seg)),
        checks=per_call_us(lambda: ops._gather_args(table, seg)),
        alloc_new_empty=per_call_us(lambda: table.new_empty((O, D))),
        alloc_torch_empty_with_device=per_call_us(lambda: torch.empty(
            (O, D), dtype=torch.float32, device=table.device)),
        stream_raw=per_call_us(lambda: _build.stream_of(table)),
        stream_object=per_call_us(
            lambda: torch.cuda.current_stream(table.device).cuda_stream),
        entry_lookup=per_call_us(
            lambda: _build.entry("gather_rows", "fm_gather_rows", ops._ARGTYPES)),
        data_ptrs=per_call_us(lambda: (table.data_ptr(), seg.data_ptr(), buf.data_ptr())),
        ctypes_launch=per_call_us(lambda: gather(ptrs[0], ptrs[1], O, N, D, ptrs[2], stream)),
        index_select_into_buffer=per_call_us(
            lambda: torch.index_select(table, 0, seg, out=lib_buf)),
        index_select=per_call_us(lambda: torch.index_select(table, 0, seg)),
    )
    vals = torch.randn((O, D), device=dev)
    off = ops.segment_offsets(seg, N)
    max_len = int(ops.segment_lengths(off).max())
    ssum = _build.entry("segment_sum", "fm_sorted_segment_sum", ops._ARGTYPES)
    sums = vals.new_empty((N, D))
    lengths = ops.segment_lengths(off).long()
    k4 = dict(
        loop=k5["loop"],
        wrapper=per_call_us(lambda: ops.sorted_segment_sum(vals, seg, N, off, max_len)),
        checks=per_call_us(lambda: ops._sum_args(vals, seg, N, off, max_len)),
        alloc_new_empty=per_call_us(lambda: vals.new_empty((N, D))),
        ctypes_launch=per_call_us(lambda: ssum(vals.data_ptr(), off.data_ptr(), N, D, 0,
                                               sums.data_ptr(), stream)),
        segment_reduce=per_call_us(lambda: torch.segment_reduce(vals, "sum",
                                                                lengths=lengths)),
    )
    steps = dict(calls_per_step=n_calls, k5_17788x3=k5, k4_point_17788x3=k4)
    log("host_breakdown_us", json.dumps(steps))
    return steps


# -- phases 4 and 5: reconstruct ---------------------------------------------------


def small_reference():
    """reconstruct on the card and on the CPU from the synthetic features of
    the JAX package's ATE test (10 frames, 300 points): both must reach its
    gate (ATE < 0.05, all 10 frames)."""
    import numpy as np

    from synth import SyntheticScene, random_descriptors
    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.pipeline.config import BAConfig, MapConfig, PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import reconstruct
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    rng = np.random.default_rng(0)
    scene = SyntheticScene(rng, n_points=300, n_frames=10)
    base = random_descriptors(rng, 300)
    feats = []
    for f in range(10):
        vis = np.where(scene.visible[f])[0]
        xy = np.zeros((512, 2), np.float32)
        desc = np.zeros((512, 128), np.float32)
        mask = np.zeros(512, bool)
        d = np.abs(base[vis] + 0.05 * rng.standard_normal((len(vis), 128)))
        xy[:len(vis)] = scene.pixels[f, vis] + 0.3 * rng.standard_normal((len(vis), 2))
        desc[:len(vis)] = d / np.linalg.norm(d, axis=1, keepdims=True)
        mask[:len(vis)] = True
        feats.append((xy, desc, mask))
    cfg = PipelineConfig(ba=BAConfig(interval=4, max_iters=10, pcg_iters=30),
                         map=MapConfig(max_frames=16, max_points=2048, max_obs=16384))
    gt = -np.einsum("fji,fj->fi", scene.R, scene.t)
    out = {}
    for dev in ("cuda", "cpu"):
        rec = reconstruct(feats, Pinhole.from_K(scene.K), cfg, device=dev)
        out[dev] = dict(n_frames=rec.n_frames, n_points=int(rec.pt_mask.sum()),
                        ate=float(ate_rmse(rec.camera_centers(), gt[:rec.n_frames])))
    log("small_reference", json.dumps(out))
    for dev, r in out.items():
        if r["n_frames"] != 10 or not r["ate"] < 0.05:
            raise AssertionError(f"small reference on {dev}: {r}")


def _column_ties_only(got, anchor, desc_a, desc_b):
    """K1's binary mode keeps the JAX kernel's value-based mutual test: a
    query passes when it attains its bank row's minimum distance, where the
    popcount matcher keeps only the lowest such query. Returns (number of
    differing decisions, whether every difference is such a tie and all
    else is identical, distances included)."""
    import torch

    from fastmatch_tpu_torch.matching import hamming

    same = torch_all(got.valid | ~anchor.valid) and torch_all(
        ((got.idx == anchor.idx) & (got.dist == anchor.dist)) | ~anchor.valid)
    extra = got.valid & ~anchor.valid
    for p in torch.nonzero(extra.any(-1))[:, 0].tolist():
        h = hamming.hamming_distance_matrix(desc_a.packed[p], desc_b.packed[p])
        h = torch.where(desc_a.mask[p][:, None], h, torch.iinfo(h.dtype).max)
        q = torch.nonzero(extra[p])[:, 0]
        i1 = got.idx[p, q].long()
        same = same and torch_all(h[q, i1] == h[:, i1].min(dim=0).values)
        same = same and torch_all(got.dist[p, q] == h[q, i1].float())
    return int(extra.sum()), same


def config2_images(views):
    """BASELINE.json config 2 from images: SIFT (capacity 2048) and ORB
    (``ORBConfig()``) on the first CONFIG2_PAIRS + 1 smoke frames, matched
    as consecutive pairs by ``match_batch`` (K1 exact and fast) and
    ``match_batch_hamming`` (K1 binary). Gates: K1 exact agrees with the
    per-pair ``match_pair`` (K2) on >= 0.999 of the live queries, fast with
    exact on >= 0.99, ORB identical to K1's plain version and to the
    popcount plain version but for column ties (``_column_ties_only``), and
    every pair has valid matches. Returns the launch counts of K1, K2, K3."""
    import torch

    from fastmatch_tpu_torch.core.containers import BinaryDescriptors, Descriptors
    from fastmatch_tpu_torch.features.orb import ORBConfig, detect_and_describe_orb
    from fastmatch_tpu_torch.features.sift import detect_and_describe
    from fastmatch_tpu_torch.kernels import batch_match as k1
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.kernels import patch_gather as k3
    from fastmatch_tpu_torch.matching import hamming
    from fastmatch_tpu_torch.matching.matcher import match_batch, match_pair, stack_matches

    frames = views[:CONFIG2_PAIRS + 1]
    wrappers = {"batch_match": k1.match_batch_fused, "distance_topk": k2.distance_topk,
                "gather_patch_sets": k3.gather_patch_sets, "gather_patches": k3.gather_patches}
    secs = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    def pairs(items, cls, field):
        first = cls(torch.stack([getattr(d, field) for d in items[:-1]]),
                    torch.stack([d.mask for d in items[:-1]]))
        second = cls(torch.stack([getattr(d, field) for d in items[1:]]),
                     torch.stack([d.mask for d in items[1:]]))
        return first, second

    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    sift = stage("sift", lambda: [detect_and_describe(f, device=DEV)[1] for f in frames])
    orb = stage("orb", lambda: [detect_and_describe_orb(f, ORBConfig(), device=DEV)[1]
                                for f in frames])
    da, db = pairs(sift, Descriptors, "data")
    oa, ob = pairs(orb, BinaryDescriptors, "packed")
    exact = stage("match_batch_exact",
                  lambda: match_batch(da, db, backend="kernel", device=DEV))
    fast = stage("match_batch_fast",
                 lambda: match_batch(da, db, backend="kernel", precision="fast", device=DEV))
    orb_m = stage("match_batch_hamming", lambda: hamming.match_batch_hamming(
        oa, ob, backend="mxu", device=DEV))
    per_pair = stage("match_pair_k2", lambda: stack_matches(
        match_pair(Descriptors(a, ma), Descriptors(b, mb), device=DEV)
        for a, ma, b, mb in zip(da.data, da.mask, db.data, db.mask)))
    anchor = stage("popcount_plain", lambda: stack_matches(
        hamming.match_pair_hamming_plain(BinaryDescriptors(a, ma), BinaryDescriptors(b, mb))
        for a, ma, b, mb in zip(oa.packed, oa.mask, ob.packed, ob.mask)))
    launches = {k: w.launches for k, w in wrappers.items()}

    agree_k2 = _agreement(exact, per_pair, da.mask)
    agree_fast = _agreement(fast, exact, da.mask)
    orb_plain = hamming._quarter(k1.match_batch_fused_plain(
        Descriptors(oa.packed, oa.mask), Descriptors(ob.packed, ob.mask),
        ratio=hamming._ratio_sqrt(0.8), fast=True, const_sq_norm=256.0, binary=True))
    orb_identical = (torch_all(orb_m.valid == orb_plain.valid)
                     and torch_all(orb_m.dist == orb_plain.dist)
                     and torch_all(orb_m.idx == orb_plain.idx))
    ties, orb_ties_only = _column_ties_only(orb_m, anchor, oa, ob)
    valid = {k: m.valid.sum(-1).tolist() for k, m in
             (("sift_exact", exact), ("sift_fast", fast), ("orb", orb_m))}
    stats = dict(pairs=CONFIG2_PAIRS, frame=list(SMOKE_SCENE["image_size"]),
                 sift_live=[int(d.mask.sum()) for d in sift],
                 orb_live=[int(d.mask.sum()) for d in orb],
                 k1_exact_vs_k2_agreement=agree_k2, k1_fast_vs_exact_agreement=agree_fast,
                 orb_identical_to_plain=orb_identical,
                 orb_vs_popcount_column_ties=ties, orb_vs_popcount_ties_only=orb_ties_only,
                 valid_per_pair=valid,
                 stage_seconds=secs, launches=launches)
    log("config2_images", json.dumps(stats))
    if agree_k2 < 0.999 or agree_fast < 0.99 or not orb_identical or not orb_ties_only:
        raise AssertionError(f"config-2 image phase: K1 vs K2 {agree_k2}, fast {agree_fast}, "
                             f"ORB identical to plain {orb_identical}, differences from "
                             f"popcount only at column ties {orb_ties_only}")
    for k, counts in valid.items():
        if min(counts) <= 0:
            raise AssertionError(f"config-2 image phase: a pair without {k} matches: {counts}")
    k3_want = 2 * len(frames)  # one K3 launch a frame, SIFT's and ORB's
    if launches.pop("gather_patches") or launches["gather_patch_sets"] != k3_want:
        raise AssertionError(f"config-2 path: K3 launches {launches}, want {k3_want} "
                             "patch-set launches and no one-segment launch")
    for k, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {k} was not launched on the config-2 path")
    return launches


def main_path(scene, views):
    """reconstruct(images=...) on the smoke scene at the default config."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.kernels import patch_gather as k3
    from fastmatch_tpu_torch.kernels import segment_ops as k4
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import reconstruct
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    wrappers = {"distance_topk": k2.distance_topk, "gather_patch_sets": k3.gather_patch_sets,
                "gather_patches": k3.gather_patches, "sorted_segment_sum": k4.sorted_segment_sum,
                "sorted_gather_rows": k4.sorted_gather_rows}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    k4.sorted_segment_sum.by_variant.update(short=0, long=0)
    t0 = time.perf_counter()
    rec = reconstruct(None, Pinhole.from_K(scene.K), PipelineConfig(), images=views,
                      device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    k4_variants = dict(k4.sorted_segment_sum.by_variant)
    n = rec.n_frames
    centers = rec.camera_centers()
    gt = -np.einsum("fji,fj->fi", scene.R[:n], scene.t[:n])
    ate = float(ate_rmse(centers, gt))
    pts = rec.points[rec.pt_mask]
    stats = dict(scene=SMOKE_SCENE, frames=len(views), frames_reconstructed=n,
                 seconds=secs, frames_per_s=n / secs, stage_seconds=rec.stage_seconds,
                 peak_mem_bytes=torch.cuda.max_memory_allocated(), ate=ate,
                 n_points=int(pts.shape[0]), n_obs=rec.n_obs, launches=launches,
                 k4_launches_by_variant=k4_variants)
    log("main_path", json.dumps(stats))
    if n != len(views) or not np.isfinite(centers).all() or not np.isfinite(pts).all():
        raise AssertionError(f"main path: {n}/{len(views)} frames, or non-finite output")
    if not ate < ATE_GATE:
        raise AssertionError(f"main path ATE {ate} >= {ATE_GATE}")
    if launches.pop("gather_patches") or launches["gather_patch_sets"] != len(views):
        raise AssertionError(f"main path: K3 launches {launches}, want one patch-set "
                             "launch a frame and no one-segment launch")
    for k, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    return launches, stats, rec


# The JAX package's figures on the same inputs, on a CPU
# (tools/jax_config4_reference.py): the config-4 pose graph solved dense,
# by PCG and hierarchically, and SLAM on the config-4 scene.
JAX_CONFIG4_PGO = dict(
    cost0=0.41399016976356506, ate_start=0.4149347245693207,
    dense=dict(cost=0.00010385062341811135, iters=30, ate=0.03560258075594902),
    pcg=dict(cost=0.0001988184085348621, iters=30, ate=0.03497856482863426),
    hierarchical=dict(cost=0.0001204079162562266, iters=50, ate=0.03375827521085739))
JAX_CONFIG4_SLAM = dict(frames_tracked=56, ate=0.007685244083404541,
                        loop_edges=[[54, 41], [55, 42]], pgo_runs=2, n_points=5433,
                        n_obs=16656)


def _centers(R, t):
    import torch

    return -torch.einsum("fji,fj->fi", R, t)


def config4_pgo():
    """The config-4 pose graph at full size (``config4_pose_graph``: 500
    keyframes, 504 edges) through ``pgo_solve`` (dense, twice, and PCG,
    twice; ``max_iters=30, kernel="geman", huber_delta_static=0.5``),
    ``pgo_solve_hierarchical`` and ``sim3_pgo_solve`` (the same graph as
    similarities, twice) on the card, with K4's launch count set to 0 just
    before and read just after. Gates: cost0 within rtol 1e-4 of the JAX
    package's on the CPU (the same function of the same inputs); the
    dense, PCG and hierarchical final costs within rtol 1e-3 of the JAX
    package's; the dense ATE within 10% of the JAX package's and below the
    drifted start's; every solver lowers the cost; every sum goes through
    K4 (``_key_sum``, keys sorted once a solve), so each solver's two runs
    are bit-identical (``bit_identical_rerun``). Prints ms per solve, LM
    iterations/s (wall clock, after a warm-up solve), K4's launches on the
    path and by solver, and K4's device us a launch (``torch.profiler``) in
    a dense solve. ``_pgo_sums`` holds K4 against the plain version at each
    of these sums' shapes (a gate)."""
    import torch

    from fastmatch_tpu_torch.core.lie import Sim3
    from fastmatch_tpu_torch.interop import pose_graph_from_numpy
    from fastmatch_tpu_torch.kernels import segment_ops as k4
    from fastmatch_tpu_torch.posegraph import pgo_solve, pgo_solve_hierarchical
    from fastmatch_tpu_torch.posegraph.sim3 import Sim3Graph, sim3_pgo_solve
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    a = config4_pose_graph()
    g = pose_graph_from_numpy(dict(poses=(a["R"], a["t"]), edge_i=a["edge_i"],
                                   edge_j=a["edge_j"], Z=(a["ZR"], a["Zt"]),
                                   edge_weight=a["edge_weight"], pose_mask=a["pose_mask"],
                                   fixed=a["fixed"]), device=DEV)
    ones = lambda n: torch.ones(n, device=g.poses.t.device)  # noqa: E731
    sg = Sim3Graph(Sim3(g.poses.R, g.poses.t, ones(g.poses.t.shape[0])), g.edge_i, g.edge_j,
                   Sim3(g.Z.R, g.Z.t, ones(g.edge_i.shape[0])), g.edge_weight, g.pose_mask,
                   g.fixed)
    gt = _centers(torch.from_numpy(a["R_gt"]), torch.from_numpy(a["t_gt"]))

    def ate(T):
        return float(ate_rmse(_centers(T.R.cpu(), T.t.cpu()), gt))

    kw = dict(kernel="geman", huber_delta_static=0.5, device=DEV)
    solves = {"dense": lambda: pgo_solve(g, max_iters=30, **kw),
              "pcg": lambda: pgo_solve(g, max_iters=30, solver="pcg", **kw),
              "hierarchical": lambda: pgo_solve_hierarchical(g, **kw),
              "sim3": lambda: sim3_pgo_solve(sg, max_iters=10, **kw)}
    out = dict(graph=CONFIG4_PGO, edges=int(a["edge_i"].shape[0]), ate_start=ate(g.poses),
               jax_cpu=JAX_CONFIG4_PGO)
    solves["dense"]()  # warm-up (cuSOLVER's first call)
    torch.cuda.synchronize()
    k4.sorted_segment_sum.launches = 0
    for name, fn in solves.items():
        before = k4.sorted_segment_sum.launches
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = dict(cost0=float(res.cost0), cost=float(res.cost), iters=res.iters,
                         ate=ate(res.poses), ms_per_solve=secs * 1e3,
                         lm_iters_per_s=res.iters / secs,
                         k4_launches=k4.sorted_segment_sum.launches - before)
        if name != "hierarchical":
            again = fn()
            out[name]["bit_identical_rerun"] = bool(
                torch.equal(res.poses.R, again.poses.R) and torch.equal(res.poses.t, again.poses.t)
                and torch.equal(res.cost, again.cost))
    out["k4_launches_on_the_path"] = k4.sorted_segment_sum.launches
    # K4's device time in the first two LM iterations of the dense solve
    # (H's and the gradient's sum each iteration), scaled to a full solve's
    # launches: profiling a whole solve costs tens of seconds of host time.
    us, seen = device_us(lambda: pgo_solve(g, max_iters=2, **kw),
                         {"segsum_short", "segsum_long"}, n=1)
    out["dense_k4_profile"] = dict(
        device_us_per_launch=us, profiled_launches=seen,
        device_us_per_solve=us * out["dense"]["k4_launches"] if seen else None)
    out["k4_sums"] = _pgo_sums(g, sg)
    log("config4_pgo", json.dumps(out))
    J, d = JAX_CONFIG4_PGO, out["dense"]
    fails = []
    if abs(d["cost0"] - J["cost0"]) > 1e-4 * J["cost0"]:
        fails.append("cost0 differs from the JAX package's beyond rtol 1e-4")
    for name in ("dense", "pcg", "hierarchical"):
        if abs(out[name]["cost"] - J[name]["cost"]) > 1e-3 * J[name]["cost"]:
            fails.append(f"{name} cost differs from the JAX package's beyond rtol 1e-3")
    if not (abs(d["ate"] - J["dense"]["ate"]) <= 0.1 * J["dense"]["ate"]
            and d["ate"] < out["ate_start"]):
        fails.append("dense ATE not within 10% of the JAX package's, or not below the start's")
    for name in solves:
        if not out[name]["cost"] < out[name]["cost0"]:
            fails.append(f"{name} did not lower the cost")
        if out[name]["k4_launches"] <= 0:
            fails.append(f"{name} made no K4 launch")
        if out[name].get("bit_identical_rerun") is False:
            fails.append(f"two {name} solves are not bit-identical")
    for what, k in out["k4_sums"].items():
        if not (k["rel_err"] <= K4_RTOL and k["bit_identical_runs"]):
            fails.append(f"K4 at the {what} sum: rel err {k['rel_err']}, "
                         f"bit-identical runs {k['bit_identical_runs']}")
    if fails:
        raise AssertionError(f"config-4 PGO: {fails}: {out}")
    return out


def _pgo_sums(g, sg):
    """K4 at each sum that the config-4 solves make, on the 500-keyframe
    graph's blocks at its start (Geman-McClure weights, delta 0.5): the
    dense H (the 4E 6x6 blocks into N*N segments of 36), the gradient and
    the PCG's block diagonal (2E rows into N segments of 6 and of 36; a PCG
    matvec sums rows of 6 the same way), and Sim(3)'s H (the 4E 7x7 blocks
    into N*N segments of 49). Each sum is held against the plain version
    in float64: ``rel_err`` is the max abs error over the largest |sum|
    (gate K4_RTOL, as in ``check_k4``), and two launches must be
    bit-identical. Wrapper ms beside the plain version's (``index_add_``)
    and ``torch.segment_reduce``'s, and the bound (each row, offset and
    sum moved once)."""
    import torch

    from fastmatch_tpu_torch.kernels import segment_ops as k4
    from fastmatch_tpu_torch.posegraph import sim3
    from fastmatch_tpu_torch.posegraph.pgo import _dense_sums, _edge_normal_blocks

    n = g.poses.R.shape[0]
    h_sum, node = _dense_sums(g, n)
    Hii, Hjj, Hij, gi, gj, _, _ = _edge_normal_blocks(g.poses, g, 0.5, "geman")
    SHii, SHjj, SHij, _, _ = sim3._edge_normal_blocks(sg.poses, sg, 0.5, "geman")
    cases = {"dense H": (h_sum, [Hii, Hjj, Hij, Hij.transpose(-1, -2)]),
             "gradient": (node, [gi, gj]),
             "PCG block diagonal": (node, [Hii, Hjj]),
             "Sim(3) H": (h_sum, [SHii, SHjj, SHij, SHij.transpose(-1, -2)])}
    out = {}
    for what, (ks, parts) in cases.items():
        vals = torch.cat([p.reshape(p.shape[0], -1) for p in parts])[ks.perm].contiguous()
        call = lambda: k4.sorted_segment_sum(vals, ks.seg, ks.n, ks.offsets,  # noqa: E731
                                             ks.max_len)
        got, again = call(), call()
        ref = k4.segment_sum_plain(vals.double(), ks.seg, ks.n)
        err = float((got.double() - ref).abs().max())
        lengths = k4.segment_lengths(ks.offsets).long()
        O, D = vals.shape
        b_ms, b_by = bound(4 * (O * D + ks.n + 1 + ks.n * D), O * D)
        out[what] = dict(
            rows=O, cols=D, segments=ks.n, longest=ks.max_len, max_abs_err=err,
            rel_err=err / max(float(ref.abs().max()), 1e-30),
            bit_identical_runs=bool(torch.equal(got, again)),
            ms=cuda_ms(call, batches=5, reps=20),
            plain_ms=cuda_ms(lambda: k4.segment_sum_plain(vals, ks.seg, ks.n),
                             batches=5, reps=20),
            library_ms=cuda_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths),
                               batches=5, reps=20),
            bound_ms=b_ms, bound_by=b_by)
    return out


def config4_slam():
    """BASELINE.json config 4 from images: SIFT (``detect_features``, the
    default ``SIFTConfig``, capacity 2048) on the config-4 scene's rendered
    640x480 frames, then ``slam`` with the default ``SlamConfig`` and
    ``MapConfig.max_frames`` >= the frame count, with every kernel's launch
    count set to 0 just before and read just after. Gates: every frame
    tracked, a loop edge at least ``loop_gap`` frames long, a PGO run, ATE
    < ATE_GATE; K3 one launch a frame, K2, K4 and K5 launched, K1 not. Then
    K2 at the loop retrieval's largest shape (the last frame against the
    bank of every frame ``loop_gap`` older) held against the plain version
    with exact decisions, with its wrapper ms, device us and bound.
    Returns (launches, stats, (scene, frames, features)): the device
    engines' phase runs on the same features."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.core.containers import Descriptors
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.matching.matcher import BIG, match_pair_plain
    from fastmatch_tpu_torch.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import detect_features
    from fastmatch_tpu_torch.pipeline.slam import SlamConfig, slam
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    t0 = time.perf_counter()
    scene, views = render_config4_scene()
    render_s = time.perf_counter() - t0
    N = len(views)
    cfg = PipelineConfig(map=MapConfig(max_frames=max(64, N)))
    scfg = SlamConfig()
    wrappers = _kernel_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    secs = {"sift": 0.0}
    feats = detect_features(views, cfg, DEV, secs)
    out = slam(feats, Pinhole.from_K(scene.K), cfg, scfg, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    rec = out.rec
    rec.stage_seconds["sift"] = secs["sift"]
    n = rec.n_frames
    gt = -np.einsum("fji,fj->fi", scene.R[:n], scene.t[:n])
    ate = float(ate_rmse(rec.camera_centers(), gt))
    loops = [[int(e[0]), int(e[1])] for e in out.loop_edges]
    stats = dict(scene=CONFIG4_SCENE, frames=N, frames_tracked=n, seconds=wall,
                 frames_per_s=n / wall, render_seconds=render_s,
                 stage_seconds=rec.stage_seconds, ate=ate, loop_edges=loops,
                 pgo_runs=out.pgo_runs, odo_edges=len(out.odo_edges),
                 n_points=int(rec.pt_mask.sum()), n_obs=rec.n_obs, launches=dict(launches),
                 peak_mem_bytes=torch.cuda.max_memory_allocated(), jax_cpu=JAX_CONFIG4_SLAM)

    # K2 at the retrieval's largest shape, against the plain version.
    n_old = N - 1 - scfg.loop_gap
    dev = torch.device(DEV)
    da = Descriptors(torch.from_numpy(feats[-1][1]).to(dev), torch.from_numpy(feats[-1][2]).to(dev))
    db = Descriptors(torch.from_numpy(np.concatenate([f[1] for f in feats[:n_old]])).to(dev),
                     torch.from_numpy(np.concatenate([f[2] for f in feats[:n_old]])).to(dev))
    got = k2.match_pair_fused(da, db)
    ref = match_pair_plain(da, db)
    a, b = da.data, db.data
    a2m = torch.where(da.mask, (a * a).sum(-1), BIG).contiguous()
    b2m = torch.where(db.mask, (b * b).sum(-1), BIG).contiguous()
    call = lambda: k2.distance_topk(a, b, b2m, a2m)  # noqa: E731
    us, seen = device_us(call, K2_KERNELS, n=10)
    nq, m, D = a.shape[0], b.shape[0], a.shape[1]
    b_ms, b_by = bound(4 * (nq * D + m * D + nq + m) + 4 * (3 * nq + m), 2.0 * nq * m * D)
    retrieval = dict(shape=[nq, m, D], n_old=n_old, decisions_identical=_decisions_equal(got, ref),
                     n_valid=int(ref.valid.sum()), ms=cuda_ms(call, batches=5, reps=5),
                     plain_ms=cuda_ms(lambda: k2.distance_topk_plain(a, b, b2m, a2m),
                                      batches=3, reps=1),
                     device_us_per_call=us * seen / 10 if seen else None,
                     profiled_launches=seen, bound_ms=b_ms, bound_by=b_by)
    stats["retrieval_k2"] = retrieval
    log("config4_slam", json.dumps(stats))
    fails = []
    if n != N or not np.isfinite(rec.camera_centers()).all():
        fails.append(f"{n}/{N} frames tracked, or non-finite poses")
    if not any(f - c >= scfg.loop_gap for f, c in loops):
        fails.append(f"no loop edge of at least {scfg.loop_gap} frames")
    if out.pgo_runs < 1:
        fails.append("no PGO run")
    if not ate < ATE_GATE:
        fails.append(f"ATE {ate} >= {ATE_GATE}")
    if launches.pop("gather_patches") or launches["gather_patch_sets"] != N:
        fails.append(f"K3 launches {launches}, want one patch-set launch a frame")
    if launches.pop("batch_match"):
        fails.append("K1 launched on the config-4 path")
    fails += [f"kernel {k} not launched" for k, c in launches.items() if c <= 0]
    if not retrieval["decisions_identical"]:
        fails.append("K2 at the retrieval shape differs from the plain version")
    if fails:
        raise AssertionError(f"config-4 SLAM: {fails}")
    return launches, stats, (scene, views, feats)


# -- phase 8: the device-resident SLAM engines -------------------------------------

# The JAX package's device engines on a CPU, on the config-4 orbit's SIFT
# features (tools/jax_config4_reference.py --engine device,scan,chunked
# --seed 0,1,2, and --frames 120 --engine device --seed 0,1,2): default
# SlamConfig, MapConfig.max_frames 64 (128 at 120 frames); scan with
# post-hoc closure, chunked with chunk 16. ``ate`` and the counts are seed
# 0's; ``ate_seeds`` is the ATE over seeds 0-2 (the seed keys every RANSAC
# draw). For slam_device ``ate`` is the JAX driver's own (its last solve
# at the interval budgets) and ``ate_seeds`` that of the same runs ended
# with the scan engines' final solve at full budgets (``ate_final_full``),
# the solve the port's device engine ends with.
JAX_DEVICE_SLAM = {
    "device_120": dict(frames_tracked=120, ate=0.014789875596761703,
                       ate_seeds=[0.008907943964004517, 0.020285559818148613, 0.011586901731789112],
                       loop_edges=[[12, 0], [24, 1], [53, 41], [65, 33], [77, 21], [89, 9],
                                   [101, 3], [113, 15]], pgo_runs=8, n_points=6578,
                       n_obs=27246),
    "device": dict(frames_tracked=56, ate=0.009930196218192577,
                   ate_seeds=[0.004830744117498398, 0.009489035233855247, 0.005427381955087185],
                   loop_edges=[[12, 0], [24, 1], [53, 41]], pgo_runs=3, n_points=5131,
                   n_obs=20059),
    "scan": dict(frames_tracked=56, ate=0.00500131119042635,
                 ate_seeds=[0.00500131119042635, 0.004775146022439003,
                            0.005207451060414314],
                 loop_edges=[[21, 1], [53, 41]], pgo_runs=1, n_points=5144, n_obs=20007),
    "chunked": dict(frames_tracked=56, ate=0.0047241635620594025,
                    ate_seeds=[0.0047241635620594025, 0.04093405231833458,
                               0.005434168037027121],
                    loop_edges=[[12, 0], [25, 1], [53, 41]], pgo_runs=3, n_points=5134,
                    n_obs=20099),
}
# An engine's ATE may exceed the largest of the JAX package's over seeds 0-2
# by this margin. Both packages spread alike over the seeds: widely for
# slam_chunked (the JAX package 0.0047-0.0409, the port 0.0052-0.0388 on
# the card, tools/config4_seed_spread.py), narrowly for the others (scan:
# the JAX package 0.0048-0.0052, the port 0.0050-0.0060). The margin holds
# the port's spread on the card for each engine.
ATE_SPREAD_MARGIN = 1.15
DEVICE_SLAM_FRAMES = 120  # the whole out-and-back orbit: the host engine loses it
MIN_DEVICE_LOOPS = 4


def _kernel_wrappers():
    """The launch-counting wrappers of K1-K5, by name."""
    from fastmatch_tpu_torch.kernels import batch_match as k1
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.kernels import patch_gather as k3
    from fastmatch_tpu_torch.kernels import segment_ops as k4

    return {"batch_match": k1.match_batch_fused, "distance_topk": k2.distance_topk,
            "gather_patch_sets": k3.gather_patch_sets, "gather_patches": k3.gather_patches,
            "sorted_segment_sum": k4.sorted_segment_sum,
            "sorted_gather_rows": k4.sorted_gather_rows}


def _same_map(a, b, names=("R", "t", "points", "obs_cam", "obs_pt", "obs_uv", "obs_mask")):
    import numpy as np

    return (a.frame_seq == b.frame_seq
            and all(np.array_equal(getattr(a.rec, k), getattr(b.rec, k)) for k in names))


def _same_decisions(a, b):
    import numpy as np

    return (a.frame_seq == b.frame_seq and a.rec.n_points == b.rec.n_points
            and a.rec.n_obs == b.rec.n_obs and np.array_equal(a.rec.obs_pt, b.rec.obs_pt))


def config4_device_slam(scene56, views56, feats56):
    """The device-resident engines on the config-4 orbit, at config 4's
    widths (SIFT capacity 2048, 128-d descriptors, MapConfig's 8192 points
    and 65,536 observations, the default SlamConfig and BAConfig). Each run
    has every kernel's launch count set to 0 just before and read just
    after, and its host synchronizations counted by
    ``torch.cuda.set_sync_debug_mode`` (but the first, timed ``slam_device``
    run's). Runs: ``slam_device`` twice on the whole 120-frame orbit
    (MapConfig.max_frames 128), which the host engine loses; on the 56
    frames of ``config4_slam`` (its features): ``slam_scan(close_loops=
    True)``, ``slam_chunked(chunk=16)``, ``slam_scan_images`` on the frames
    themselves, and with loop closure off ``slam_device``, ``slam_scan`` and
    ``slam_chunked``, and the first two again with the interval budgets
    lifted. Gates: every frame tracked, finite poses, ATE < ATE_GATE and
    at most ATE_SPREAD_MARGIN times the largest of the JAX package's
    over seeds 0-2 (``JAX_DEVICE_SLAM``); on 120 frames at
    least MIN_DEVICE_LOOPS loop edges of at least ``loop_gap`` frames, one
    of them on the way back (frame id > 64), and PGO runs; the two
    ``slam_device`` runs bit-identical (R, t, points, observation table);
    with closure off ``slam_scan`` and ``slam_device`` bit-identical with
    the budgets lifted and decision-identical at the capped defaults
    (recorded: whether bitwise there too), ``slam_chunked`` and
    ``slam_scan`` bit-identical; K2 at least 3 launches a tracked frame, K3
    one a frame in ``slam_scan_images`` and none in the feature-driven
    engines, K4 and K5 launched, K1 not. Returns (the first 120-frame
    run's launches, stats, and that run's scene, features and result: the
    map of ``map_services``)."""
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import detect_features
    from fastmatch_tpu_torch.pipeline.slam import SlamConfig
    from fastmatch_tpu_torch.pipeline.slam_device import slam_device
    from fastmatch_tpu_torch.pipeline.slam_scan import slam_chunked, slam_scan, slam_scan_images
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    wrappers = _kernel_wrappers()
    scfg = SlamConfig()
    off = dataclasses.replace(scfg, loop_min_votes=10 ** 9)
    t0 = time.perf_counter()
    scene120, views120 = render_config4_scene(DEVICE_SLAM_FRAMES)
    feats120 = detect_features(views120, PipelineConfig(), DEV)
    stats = dict(render_and_sift_120_seconds=time.perf_counter() - t0, runs={},
                 jax_cpu=JAX_DEVICE_SLAM, ate_spread_margin=ATE_SPREAD_MARGIN)
    cfg120 = PipelineConfig(map=MapConfig(max_frames=128))
    cfg56 = PipelineConfig(map=MapConfig(max_frames=64))
    uncapped = dataclasses.replace(cfg56, ba=dataclasses.replace(
        cfg56.ba, interval_max_iters=0, interval_pcg_iters=0))

    def counted(name, scene, fn, count_syncs=True):
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if count_syncs:
                torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rec = out.rec
        seq = np.asarray(out.frame_seq)
        centers = rec.camera_centers()
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        n = rec.n_frames
        stats["runs"][name] = dict(
            frames=len(scene.R), frames_tracked=n, seconds=wall, frames_per_s=n / wall,
            stage_seconds=rec.stage_seconds,
            loop_edges=[[int(e[0]), int(e[1])] for e in out.loop_edges],
            pgo_runs=out.pgo_runs, n_points=int(rec.pt_mask.sum()), n_obs=rec.n_obs,
            finite=bool(np.isfinite(centers).all()),
            ate=float(ate_rmse(centers, -np.einsum("fji,fj->fi", scene.R[seq], scene.t[seq]))),
            launches={k: w.launches for k, w in wrappers.items()},
            host_syncs=syncs if count_syncs else None,
            host_syncs_per_frame=syncs / len(scene.R) if count_syncs else None,
            peak_mem_bytes=torch.cuda.max_memory_allocated())
        log(f"config4_device_slam {name}", json.dumps(stats["runs"][name]))
        return out

    cam120, cam56 = Pinhole.from_K(scene120.K), Pinhole.from_K(scene56.K)
    runs = {
        "device_120": counted("device_120", scene120, lambda: slam_device(
            feats120, cam120, cfg120, scfg, device=DEV), count_syncs=False),
        "device_120_again": counted("device_120_again", scene120, lambda: slam_device(
            feats120, cam120, cfg120, scfg, device=DEV)),
        "scan": counted("scan", scene56, lambda: slam_scan(
            feats56, cam56, cfg56, scfg, close_loops=True, device=DEV)),
        "chunked": counted("chunked", scene56, lambda: slam_chunked(
            feats56, cam56, cfg56, scfg, chunk=16, device=DEV)),
        "scan_images": counted("scan_images", scene56, lambda: slam_scan_images(
            views56, cam56, cfg56, scfg, device=DEV)),
        "device_no_closure": counted("device_no_closure", scene56, lambda: slam_device(
            feats56, cam56, cfg56, off, device=DEV)),
        "scan_no_closure": counted("scan_no_closure", scene56, lambda: slam_scan(
            feats56, cam56, cfg56, off, device=DEV)),
        "chunked_no_closure": counted("chunked_no_closure", scene56, lambda: slam_chunked(
            feats56, cam56, cfg56, off, chunk=16, device=DEV)),
        "device_uncapped": counted("device_uncapped", scene56, lambda: slam_device(
            feats56, cam56, uncapped, off, device=DEV)),
        "scan_uncapped": counted("scan_uncapped", scene56, lambda: slam_scan(
            feats56, cam56, uncapped, off, device=DEV)),
    }
    parity = dict(
        device_runs_bit_identical=_same_map(runs["device_120"], runs["device_120_again"]),
        scan_vs_device_uncapped_bit_identical=_same_map(runs["scan_uncapped"],
                                                        runs["device_uncapped"]),
        scan_vs_device_capped_decisions_identical=_same_decisions(runs["scan_no_closure"],
                                                                  runs["device_no_closure"]),
        scan_vs_device_capped_bit_identical=_same_map(runs["scan_no_closure"],
                                                      runs["device_no_closure"]),
        chunked_vs_scan_bit_identical=_same_map(runs["chunked_no_closure"],
                                                runs["scan_no_closure"]),
        scan_images_vs_scan_bit_identical=_same_map(runs["scan_images"],
                                                    runs["scan_no_closure"]))
    stats["parity"] = parity
    log("config4_device_slam parity", json.dumps(parity))

    fails = []
    for name, st in stats["runs"].items():
        if st["frames_tracked"] != st["frames"] or not st["finite"]:
            fails.append(f"{name}: {st['frames_tracked']}/{st['frames']} frames tracked, "
                         "or non-finite poses")
        if not st["ate"] < ATE_GATE:
            fails.append(f"{name}: ATE {st['ate']} >= {ATE_GATE}")
        ref = JAX_DEVICE_SLAM.get(name)
        if ref and not st["ate"] <= ATE_SPREAD_MARGIN * max(ref["ate_seeds"]):
            fails.append(f"{name}: ATE {st['ate']} > {ATE_SPREAD_MARGIN} x the JAX package's "
                         f"largest over seeds 0-2, {max(ref['ate_seeds'])}")
        la = st["launches"]
        images = name == "scan_images"
        if la["distance_topk"] < 3 * (st["frames"] - 2):
            fails.append(f"{name}: K2 launches {la['distance_topk']} < 3 a frame")
        if la["gather_patch_sets"] != (st["frames"] if images else 0) or la["gather_patches"]:
            fails.append(f"{name}: K3 launches {la}, want {'one a frame' if images else 'none'}")
        if la["batch_match"]:
            fails.append(f"{name}: K1 launched")
        fails += [f"{name}: kernel {k} not launched"
                  for k in ("sorted_segment_sum", "sorted_gather_rows") if la[k] <= 0]
    dev120 = stats["runs"]["device_120"]
    long_loops = [e for e in dev120["loop_edges"] if e[0] - e[1] >= scfg.loop_gap]
    if len(long_loops) < MIN_DEVICE_LOOPS or not any(f > 64 for f, _ in long_loops):
        fails.append(f"device_120: loop edges {dev120['loop_edges']}, want at least "
                     f"{MIN_DEVICE_LOOPS} of at least {scfg.loop_gap} frames, one with frame "
                     "id > 64")
    if dev120["pgo_runs"] < 1:
        fails.append("device_120: no PGO run")
    fails += [f"parity: {k} is false" for k in (
        "device_runs_bit_identical", "scan_vs_device_uncapped_bit_identical",
        "scan_vs_device_capped_decisions_identical", "chunked_vs_scan_bit_identical")
        if not parity[k]]
    if fails:
        raise AssertionError(f"config-4 device SLAM: {fails}")
    return dev120["launches"], stats, dict(scene=scene120, feats=feats120,
                                           out=runs["device_120"])


# -- phase 9: the command-line interface ------------------------------------------

# ``evaluate synth --n-synth 2`` at the default config through the JAX
# package's CLI (``python -m fastmatch_tpu.cli``) on a CPU.
JAX_EVALUATE_SYNTH2 = dict(mean_precision=0.976190447807312, mean_recall=0.7641296982765198,
                           n_correct=164, n_predicted=168, n_gt=215)
SYNTH_PRECISION_TOL = 0.02
CLI_COUNT_TOL = 0.05


def _cli(argv):
    """(JSON objects printed, wall seconds) of one in-process CLI call."""
    import contextlib
    import io

    import torch

    from fastmatch_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", DEV, *argv])
    torch.cuda.synchronize()
    return ([json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")],
            time.perf_counter() - t0)


def quantize8(img):
    """A float frame as the image library decodes its 8-bit encoding:
    code * (1.0f / 255.0f) in float32."""
    import numpy as np

    q = np.clip(np.round(img * 255), 0, 255).astype(np.float32)
    return q * (np.float32(1.0) / np.float32(255.0))


def _write_gt_tum(scene, n, path):
    import numpy as np

    with open(path, "w") as fh:
        for f, c in enumerate(-np.einsum("fji,fj->fi", scene.R[:n], scene.t[:n])):
            fh.write(f"{f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} 0 0 0 1\n")


def cli_phase(scene, views, direct):
    """The port's CLI on the card, from features and synthetic images; the
    image files come in the next phase (``image_io_phase``). ``info``
    through ``python -m fastmatch_tpu_torch.cli`` in a child process; then
    in-process (``cli.main``), each call with K1-K5's launch counts set to 0
    just before and read just after: ``reconstruct`` of a .npz of the 50
    smoke frames' features (SIFT on the card from the frames quantized to
    8 bits as the image library decodes them, ``quantize8``), ``evaluate
    traj`` of its output against the scene's TUM trajectory, ``match`` of
    frames 0 and 1's descriptor dumps, ``evaluate synth --n-synth 2`` (SIFT
    on numpy images); and ``verify_matches(model="fundamental")``, the target of
    ``match --verify fundamental``, on frames 0 and 1. Gates: 50/50
    frames, ATE < ATE_GATE, points and observations within 5% of
    ``direct`` (the main path's ``reconstruct`` on the unquantized frames
    in this run); K2, K4 and K5 launched by reconstruct, K2 by match, K3
    (one launch an image) and K2 by evaluate synth; the match verified
    with inliers; the synth precision within 0.02 of the JAX package's on
    the CPU; and ``slam`` (``--engine auto``, no ``--device``) of the same
    .npz in a child process must report the device engine over every
    frame."""
    import tempfile

    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.containers import Matches
    from fastmatch_tpu_torch.features.sift import detect_and_describe
    from fastmatch_tpu_torch.matching.matcher import match_pair
    from fastmatch_tpu_torch.matching.verify import verify_matches
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig

    out, fails = {}, []
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    info = subprocess.run([sys.executable, "-m", "fastmatch_tpu_torch.cli", "info"],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    out["info"] = dict(rc=info.returncode, stdout=info.stdout.strip(),
                       seconds=time.perf_counter() - t0)
    if info.returncode != 0 or "nvidia-smi" not in info.stdout:
        fails.append(f"cli info failed: {info.stderr[-2000:]}")
    wrappers = _kernel_wrappers()

    def call(name, argv):
        for w in wrappers.values():
            w.launches = 0
        reports, secs = _cli(argv)
        out[name] = dict(report=reports[-1], seconds=secs,
                         launches={k: w.launches for k, w in wrappers.items()})
        return reports[-1], out[name]["launches"]

    cfg = PipelineConfig()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        feats = []
        for img in views:
            kps, desc = detect_and_describe(quantize8(img), cfg.sift, device=DEV)
            feats.append((kps, desc))
        arrays = {"n_frames": len(views), "image_size": np.array(views[0].shape[::-1])}
        for i, (kps, desc) in enumerate(feats):
            arrays.update({f"xy_{i}": kps.xy.cpu().numpy(), f"desc_{i}": desc.data.cpu().numpy(),
                           f"mask_{i}": desc.mask.cpu().numpy()})
        npz = os.path.join(tmp, "features.npz")
        np.savez(npz, **arrays)
        for i in (0, 1):
            np.save(os.path.join(tmp, f"desc{i}.npy"), arrays[f"desc_{i}"][arrays[f"mask_{i}"]])
        gt_path = os.path.join(tmp, "gt_tum.txt")
        _write_gt_tum(scene, len(views), gt_path)
        out["features_seconds"] = time.perf_counter() - t0
        rec_path, metrics = os.path.join(tmp, "rec.npz"), os.path.join(tmp, "metrics.jsonl")
        rep, rec_launches = call("reconstruct", ["reconstruct", npz, "--out", rec_path,
                                                 "--metrics", metrics])
        with open(metrics) as fh:
            stages = [e for e in map(json.loads, fh) if e["event"] == "stage_seconds"][0]
        out["reconstruct"].update(
            stage_seconds={k: v for k, v in stages.items() if k not in ("ts", "event", "step")},
            direct=dict(n_points=direct["n_points"], n_obs=direct["n_obs"]))
        traj, _ = call("evaluate_traj", ["evaluate", "traj", "--est", rec_path, "--gt", gt_path])
        t0 = time.perf_counter()
        auto = subprocess.run([sys.executable, "-m", "fastmatch_tpu_torch.cli", "slam", npz],
                              capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
        out["slam_auto"] = dict(rc=auto.returncode, seconds=time.perf_counter() - t0,
                                report=[json.loads(line) for line in auto.stdout.splitlines()
                                        if line.startswith("{")][-1:],
                                stderr=auto.stderr[-2000:] if auto.returncode else "")
        match, match_launches = call("match", ["match", os.path.join(tmp, "desc0.npy"),
                                               os.path.join(tmp, "desc1.npy")])
    synth, synth_launches = call("evaluate_synth", ["evaluate", "synth", "--n-synth", "2"])
    out["evaluate_synth"]["jax_cpu"] = JAX_EVALUATE_SYNTH2
    (kp0, d0), (kp1, d1) = feats[0], feats[1]
    m = match_pair(d0, d1, device=DEV)
    vr = verify_matches(kp0, kp1, Matches(m.idx, m.dist, m.valid), model="fundamental",
                        generator=torch.Generator(DEV).manual_seed(0), device=DEV)
    out["verify_fundamental"] = dict(ok=bool(vr.ok), n_inliers=int(vr.n_inliers),
                                     n_matches=int(m.valid.sum()))
    log("cli", json.dumps(out))
    auto = out["slam_auto"]["report"]
    if out["slam_auto"]["rc"] != 0 or not auto or auto[0].get("engine") != "device" \
            or auto[0]["n_frames"] != len(views):
        fails.append(f"cli slam --engine auto: {out['slam_auto']}, want the device engine "
                     f"over {len(views)} frames")
    if rep["n_frames"] != len(views):
        fails.append(f"cli reconstruct: {rep['n_frames']}/{len(views)} frames")
    if not traj["ate_rmse"] < ATE_GATE:
        fails.append(f"cli reconstruct ATE {traj['ate_rmse']} >= {ATE_GATE}")
    for k in ("n_points", "n_obs"):
        if abs(rep[k] - direct[k]) > CLI_COUNT_TOL * direct[k]:
            fails.append(f"cli reconstruct {k} {rep[k]} not within 5% of the direct "
                         f"call's {direct[k]}")
    for what, launched, need in (("reconstruct", rec_launches, ("distance_topk",
                                  "sorted_segment_sum", "sorted_gather_rows")),
                                 ("match", match_launches, ("distance_topk",)),
                                 ("evaluate synth", synth_launches, ("distance_topk",))):
        fails += [f"cli {what}: kernel {k} not launched" for k in need if launched[k] <= 0]
    if synth_launches["gather_patch_sets"] != 4 or synth_launches["gather_patches"]:
        fails.append(f"cli evaluate synth K3 launches {synth_launches}, want one an image")
    if not match["n_matches"] > 0:
        fails.append(f"cli match: {match}")
    if not (out["verify_fundamental"]["ok"] and out["verify_fundamental"]["n_inliers"] > 0):
        fails.append(f"verify_matches(fundamental): {out['verify_fundamental']}")
    prec = synth["aggregate"]["mean_precision"]
    if not abs(prec - JAX_EVALUATE_SYNTH2["mean_precision"]) <= SYNTH_PRECISION_TOL:
        fails.append(f"cli evaluate synth precision {prec}, JAX on the CPU "
                     f"{JAX_EVALUATE_SYNTH2['mean_precision']}")
    if fails:
        raise AssertionError(f"cli phase: {fails}")
    return out


# -- phase 10: image input ----------------------------------------------------

IMAGE_DATA = os.path.join(ROOT, "tests", "data", "torch_images")
# Adam7 PNGs: libpng, read row by row as the JAX package reads them, returns
# the passes' rows; the port refuses them (tests/test_torch_imageio.py).
IMAGE_ADAM7 = ("png_adam7.png", "png_adam7_gray.png")
IMAGE_MATCH_PAIR = ("smoke_000.jpg", "smoke_001.jpg")
# The same frames transcoded losslessly to arithmetic coding (SOF10, SOF9):
# the same DCT coefficients, so the same arrays and the same pairs.
IMAGE_ARITH_PAIR = ("smoke_000_arith_prog.jpg", "smoke_001_arith.jpg")
IMAGE_ARITH_SOURCES = {"smoke_000_arith.jpg": "smoke_000.jpg",
                       "smoke_001_arith.jpg": "smoke_001.jpg",
                       "smoke_000_arith_prog.jpg": "smoke_000.jpg"}
DECODE_REPS = 20


def write_png8(path, img8):
    """An 8-bit gray PNG of `img8` (H, W) uint8 by numpy and the standard
    library's zlib, the row filters cycling None, Sub, Up, Average, Paeth."""
    import struct
    import zlib

    import numpy as np

    x = img8.astype(np.int16)
    rows = []
    for y in range(x.shape[0]):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([[0], cur[:-1]]).astype(np.int16)
        ul = np.concatenate([[0], up[:-1]]).astype(np.int16)
        f = y % 5
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    h, w = img8.shape
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(rows), 6)) + chunk(b"IEND", b""))


def _corpus_check(load_gray):
    """Every corpus file's decode against references.npz: (n_files, fails)."""
    import hashlib

    import numpy as np

    refs = np.load(os.path.join(IMAGE_DATA, "references.npz"))
    inv = np.float32(1.0) / np.float32(255.0)
    fails = []
    for key in refs.files:
        kind, _, name = key.rpartition(":")
        try:
            got = load_gray(os.path.join(IMAGE_DATA, name))
        except IOError as e:
            got = int(str(e).rsplit(" ", 1)[-1])
        if name in IMAGE_ADAM7:
            ok = isinstance(got, int) and got == 2
        elif kind == "rc":
            ok = isinstance(got, int) and got == int(refs[key])
        elif isinstance(got, int):
            ok = False
        elif kind == "f32":
            ok = np.array_equal(got, refs[key])
        elif kind == "sha256":
            ok = str(refs[key]) == (f"{got.shape[0]}x{got.shape[1]}:"
                                    + hashlib.sha256(got.tobytes()).hexdigest())
        else:
            ok = np.array_equal(got, refs[key].astype(np.float32) * inv)
        if not ok:
            fails.append(name)
    return len(refs.files), fails


def image_io_phase(scene, views, cli_out):
    """Image files through the port on the card's machine, which has no
    libjpeg, libpng or zlib headers: the port's own decoder
    (``csrc/imageio/``), built there by g++ with -lpthread alone. (a) Every
    corpus file of tests/data/torch_images/ decodes bit for bit to its
    ``references.npz`` entry (the JAX package's decode on a CPU), or to the
    same return code (Adam7: 2, the chosen difference). (b) The 50 smoke
    frames written as 8-bit PNGs (``write_png8``) decode to ``quantize8`` of
    the frames, the SIFT inputs of ``cli_phase``'s .npz route, bit for bit.
    Then through the CLI, each call with K1-K5's launch counts set to 0 just
    before and read just after: (c) ``reconstruct`` of the PNG directory:
    50/50 frames, ATE < ATE_GATE by ``evaluate traj``, points and
    observations within 5% of the .npz route's (and whether the two reports
    are equal), K2-K5 launched (K3 once a frame); (d) ``match`` of the two
    committed 640x480 JPEGs: K3 twice and K2 launched, the pairs equal to
    the same SIFT and ``match_pair`` on the decoded arrays, which (a) holds
    equal to the references; (e) ``match`` of the same frames
    arithmetic-coded (SOF10 and SOF9, ``IMAGE_ARITH_PAIR``), whose arrays
    equal the Huffman files' bit for bit: K3 twice and K2 as often as in
    (d), the same pairs; (f) ``flow`` of two of the PNGs. Logged: the host
    ms of one 640x480 JPEG (Huffman, arithmetic sequential and arithmetic
    progressive) and PNG decode (median of DECODE_REPS) and
    ``FrameLoader``'s frames/s over the 50 PNGs at 1 and 4 threads, beside
    ``nvidia-smi``'s name and power limit."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from fastmatch_tpu_torch.features.sift import detect_and_describe
    from fastmatch_tpu_torch.matching.matcher import match_pair
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig
    from fastmatch_tpu_torch.utils import imageio

    out, fails = {"nvidia_smi": nvidia_smi_line()}, []
    t0 = time.perf_counter()
    imageio.build()
    out["build_seconds"] = time.perf_counter() - t0
    n_files, corpus_fails = _corpus_check(imageio.load_gray)
    out["corpus"] = dict(files=n_files, mismatches=corpus_fails)
    fails += [f"corpus file {n} decodes unlike references.npz" for n in corpus_fails]
    wrappers = _kernel_wrappers()

    def call(name, argv):
        for w in wrappers.values():
            w.launches = 0
        reports, secs = _cli(argv)
        out[name] = dict(report=reports[-1], seconds=secs,
                         launches={k: w.launches for k, w in wrappers.items()})
        return reports[-1], out[name]["launches"]

    def median_ms(fn):
        times = []
        for _ in range(DECODE_REPS):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    with tempfile.TemporaryDirectory() as tmp:
        png_dir = os.path.join(tmp, "png")
        os.makedirs(png_dir)
        paths, bad = [], []
        for i, img in enumerate(views):
            path = os.path.join(png_dir, f"{i:06d}.png")
            write_png8(path, np.clip(np.round(img * 255), 0, 255).astype(np.uint8))
            paths.append(path)
            if not np.array_equal(imageio.load_gray(path), quantize8(img)):
                bad.append(i)
        out["png_frames"] = dict(n=len(paths), mismatches=bad)
        fails += [f"PNG frame {i} does not decode to its 8-bit codes" for i in bad]

        jpeg0 = os.path.join(IMAGE_DATA, IMAGE_MATCH_PAIR[0])
        arith = {n: os.path.join(IMAGE_DATA, n) for n in IMAGE_ARITH_SOURCES}
        out["decode_ms"] = dict(
            jpeg_640x480=median_ms(lambda: imageio.load_gray(jpeg0)),
            jpeg_arith_640x480=median_ms(lambda: imageio.load_gray(arith["smoke_000_arith.jpg"])),
            jpeg_arith_prog_640x480=median_ms(
                lambda: imageio.load_gray(arith["smoke_000_arith_prog.jpg"])),
            png_640x480=median_ms(lambda: imageio.load_gray(paths[0])), reps=DECODE_REPS)
        arith_unlike = [n for n, src in IMAGE_ARITH_SOURCES.items() if not np.array_equal(
            imageio.load_gray(arith[n]), imageio.load_gray(os.path.join(IMAGE_DATA, src)))]
        out["arith_equals_huffman"] = dict(files=len(arith), mismatches=arith_unlike)
        fails += [f"{n} decodes unlike {IMAGE_ARITH_SOURCES[n]}" for n in arith_unlike]
        loader_fps = {}
        for n_threads in (1, 4):
            t = time.perf_counter()
            with imageio.FrameLoader(paths, size=(640, 480), n_threads=n_threads) as frames:
                n = sum(1 for _ in frames)
            loader_fps[f"threads_{n_threads}"] = n / (time.perf_counter() - t)
            if n != len(paths):
                fails.append(f"FrameLoader({n_threads} threads) gave {n}/{len(paths)} frames")
        out["loader_frames_per_s"] = loader_fps

        rec_path, metrics = os.path.join(tmp, "rec.npz"), os.path.join(tmp, "metrics.jsonl")
        gt_path = os.path.join(tmp, "gt_tum.txt")
        _write_gt_tum(scene, len(views), gt_path)
        rep, rec_launches = call("reconstruct", ["reconstruct", png_dir, "--out", rec_path,
                                                 "--metrics", metrics])
        with open(metrics) as fh:
            stages = [e for e in map(json.loads, fh) if e["event"] == "stage_seconds"][0]
        out["reconstruct"]["stage_seconds"] = {k: v for k, v in stages.items()
                                               if k not in ("ts", "event", "step")}
        traj, _ = call("evaluate_traj", ["evaluate", "traj", "--est", rec_path, "--gt", gt_path])
        npz_rep = cli_out["reconstruct"]["report"]
        out["reconstruct"]["npz_route"] = npz_rep
        out["reconstruct"]["same_as_npz_route"] = all(
            rep[k] == npz_rep[k] for k in ("n_frames", "n_points", "n_obs"))

        pairs_path = os.path.join(tmp, "pairs.npz")
        match, match_launches = call("match", ["match", jpeg0,
                                               os.path.join(IMAGE_DATA, IMAGE_MATCH_PAIR[1]),
                                               "--out", pairs_path])
        cli_pairs = np.load(pairs_path)["pairs"]
        cfg = PipelineConfig()
        descs = [detect_and_describe(torch.from_numpy(imageio.load_gray(
            os.path.join(IMAGE_DATA, n))), cfg.sift, device=DEV)[1] for n in IMAGE_MATCH_PAIR]
        m = match_pair(descs[0], descs[1], ratio=cfg.matching.ratio,
                       cross_check=cfg.matching.cross_check, backend=cfg.matching.backend,
                       precision=cfg.matching.precision, device=DEV)
        valid = m.valid.cpu().numpy() & descs[0].mask.cpu().numpy()
        lib_pairs = np.stack([np.where(valid)[0], m.idx.cpu().numpy()[valid]], axis=1)
        out["match"]["pairs_equal_library_call"] = bool(np.array_equal(cli_pairs, lib_pairs))
        arith_pairs_path = os.path.join(tmp, "pairs_arith.npz")
        _, arith_launches = call("match_arith", ["match", *(arith[n] for n in IMAGE_ARITH_PAIR),
                                                 "--out", arith_pairs_path])
        out["match_arith"]["pairs_equal_huffman"] = bool(np.array_equal(
            np.load(arith_pairs_path)["pairs"], cli_pairs))
        flow, flow_launches = call("flow", ["flow", paths[0], paths[1]])
    log("image_io", json.dumps(out))

    if rep["n_frames"] != len(views):
        fails.append(f"reconstruct <png dir>: {rep['n_frames']}/{len(views)} frames")
    if not traj["ate_rmse"] < ATE_GATE:
        fails.append(f"reconstruct <png dir> ATE {traj['ate_rmse']} >= {ATE_GATE}")
    for k in ("n_points", "n_obs"):
        if abs(rep[k] - npz_rep[k]) > CLI_COUNT_TOL * npz_rep[k]:
            fails.append(f"reconstruct <png dir> {k} {rep[k]} not within 5% of the .npz "
                         f"route's {npz_rep[k]}")
    fails += [f"reconstruct <png dir>: kernel {k} not launched" for k in (
        "distance_topk", "sorted_segment_sum", "sorted_gather_rows") if rec_launches[k] <= 0]
    if rec_launches["gather_patch_sets"] != len(views):
        fails.append(f"reconstruct <png dir> K3 launches {rec_launches}, want one a frame")
    if match_launches["gather_patch_sets"] != 2 or match_launches["distance_topk"] <= 0:
        fails.append(f"match of two JPEGs: launches {match_launches}, want K3 twice and K2")
    if not (match["n_matches"] > 0 and out["match"]["pairs_equal_library_call"]):
        fails.append(f"match of two JPEGs: {match}, pairs equal to the library call: "
                     f"{out['match']['pairs_equal_library_call']}")
    if (arith_launches["gather_patch_sets"] != 2
            or arith_launches["distance_topk"] != match_launches["distance_topk"]):
        fails.append(f"match of two arithmetic JPEGs: launches {arith_launches}, want K3 "
                     f"twice and K2 as in the Huffman pair's {match_launches}")
    if not out["match_arith"]["pairs_equal_huffman"]:
        fails.append(f"match of two arithmetic JPEGs: {out['match_arith']['report']}, pairs "
                     f"unlike the Huffman pair's")
    if not flow["n_tracked"] > 0:
        fails.append(f"flow of two PNGs: {flow}")
    if fails:
        raise AssertionError(f"image_io phase: {fails}")
    return out


# The CPU test's tolerance for the grouped BA against the default path
# (tests/test_torch_ba_grouped.py, the JAX package's rtol for it).
GROUPED_BA_RTOL = 1e-3


# -- phase 10: the small-baseline front end and dense depth --------------------

# The JAX package's figures on the VO phase's inputs (``render_vo_scene``, 50
# frames, default configs), on a CPU: ``tools/jax_vo_reference.py --frames 50
# --seed 0,1,2,3,4,5,6,7`` (the host engines' draws come from PRNGKey(0)
# there; the tool offsets that key by the seed). Each mono engine boots at
# frame 18 and poses frames 1-17 afterwards by PnP on the ~43 tracks that
# survive to it: that PnP's draws set the whole sequence's ATE (0.043 to
# 0.109 over the host engine's seeds), while the ATE of the frames from the
# boot frame on is the same to 3 digits for every seed (``ate_from_boot``).
JAX_VO = {
    "host": dict(ate_seeds=[0.04401319592143247, 0.0432832829965845, 0.04274566674674535,
                            0.04430101606452639, 0.08858922598027572, 0.10861084385959532,
                            0.05655711371889059, 0.05036592651496649],
                 ate_from_boot_seeds=[0.01321114366425271, 0.013226377906433376,
                                      0.013211091827768839],
                 keyframes=33, n_points=578, boot=18),
    "scan": dict(ate_seeds=[0.05937518684038394, 0.06573150008351221, 0.0574511311149668,
                            0.051163843492193564, 0.10906040748837514, 0.13867574560451626,
                            0.07113529571643114, 0.04130978825166229],
                 ate_from_boot_seeds=[0.01338473134884371, 0.013386038149468002,
                                      0.013387941892084409],
                 keyframes=33, n_points=578, boot=18),
    "stereo": dict(scale_seeds=[1.00229975553181, 0.9966015710467938, 1.043146205008661,
                                1.0172222788810001, 1.002508988722298],
                   ate_rigid_seeds=[0.023387135220327142, 0.026077240627437184,
                                    0.09152988695609592, 0.04526832055305423,
                                    0.03866798114264105],
                   fallbacks_seeds=[2, 4, 4, 6, 2]),
    "rectified_pair_valid_frac": 0.3865885416666667,
    "unrectified_pair_0_6_valid_frac": 0.24886393229166667,
}
VO_RIGID_ATE = 0.15       # tests/test_stereo_vo.py::test_metric_trajectory's gate
# That test also allows 3 flagged fallbacks and a scale within 0.03 of 1; on
# this sequence the JAX package gives 2 / 4 / 4 / 6 / 2 fallbacks (frames
# 40-49, where few tracks survive) and scales 0.997-1.043 over seeds 0-4.
# So, as for the SLAM engines: at most its most fallbacks, and a scale
# error at most ATE_SPREAD_MARGIN times its largest.
VO_MAX_FALLBACKS = max(JAX_VO["stereo"]["fallbacks_seeds"])
VO_UNRECTIFIED_PAIR = (0, 6)


def _vo_run(name, fn, gt, frames, stats, wrappers):
    """Run one VO engine with every kernel's launch count set to 0 just
    before and read just after, and its host synchronizations counted;
    record seconds, frames/s, syncs a frame, peak memory, launches, the
    sim(3) ATE, the Umeyama scale and the rigid ATE."""
    import warnings

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from vo_fixtures import summary

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            rec = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    st = dict(summary(rec, gt), seconds=wall, frames_per_s=frames / wall, host_syncs=syncs,
              host_syncs_per_frame=syncs / frames, peak_mem_bytes=torch.cuda.max_memory_allocated(),
              launches={k: w.launches for k, w in wrappers.items()},
              stage_seconds=rec.stage_seconds,
              finite=bool(np.isfinite(rec.R[:rec.n_frames]).all()
                          and np.isfinite(rec.points[rec.pt_mask]).all()))
    stats[name] = st
    log(f"vo_paths {name}", json.dumps({k: v for k, v in st.items() if k != "stage_seconds"}))
    return rec


def _same_rec(a, b, names=("R", "t", "points", "obs_cam", "obs_pt", "obs_uv", "obs_mask")):
    import numpy as np

    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in names)


def vo_paths():
    """The small-baseline front end and dense depth on the card, at default
    widths (``VOConfig()``: capacity 512, KLT 3 levels, win 11, 8
    iterations; ``PipelineConfig()``, ``StereoConfig()``: 64 disparities,
    win 9; ``StereoVOConfig()``) on ``render_vo_scene``'s 50 640x480 frames
    (the config-3 smoke sequence) and their right frames at VO_BASELINE.
    Each run has every kernel's launch count set to 0 just before and read
    just after, its host synchronizations counted and its peak memory read:
    ``visual_odometry`` twice, ``visual_odometry_scan`` twice,
    ``stereo_visual_odometry``, ``stereo_disparity`` on frame 0's rectified
    pair (and on the CPU), ``rectify_pair`` + ``stereo_disparity`` on the
    unrectified pair VO_UNRECTIFIED_PAIR at its true relative pose (and on
    the CPU), ``densify`` over the host engine's trajectory (and on the
    CPU), ``track_pair`` at capacity 1024 on frames 0 and 1 (and on the
    CPU), and the ``vialign`` CLI on ``imu_circle``'s trajectory and IMU
    runs (and with ``--device cpu``).

    Gates: each mono engine poses every frame with no PnP fallback, ATE <
    ATE_GATE, and the ATE of the frames from its boot frame on at most
    ATE_SPREAD_MARGIN times the JAX package's largest over seeds 0-2
    (``JAX_VO``; the whole sequence's ATE is recorded beside the JAX
    package's range over seeds 0-7: the retroactive poses before the boot
    frame spread with the draws in both packages); its two runs
    bit-identical; stereo VO every frame posed, at most VO_MAX_FALLBACKS
    fallbacks, the scale's distance from 1 at most ATE_SPREAD_MARGIN times
    the JAX package's largest over seeds 0-4, rigid ATE < VO_RIGID_ATE; K3 exactly ``1 + levels``
    launches a tracked frame (and none in the rest), K4 and K5 launched by
    the engines, K1 and K2 never; card against CPU: ``track_pair`` corners
    equal, status equal on >= 0.99 of them and positions within 0.01 px on
    the tracks live in both; ``stereo_disparity`` valid masks equal on >=
    0.999 of the pixels, disparities within 1e-3 px where both are valid
    (both pairs); ``densify``'s point count within 2%; ``vialign``'s scale
    and gravity within 1e-4."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from fastmatch_tpu_torch import cli
    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.dense.densify import densify
    from fastmatch_tpu_torch.dense.stereo import rectify_pair, stereo_disparity
    from fastmatch_tpu_torch.features.klt import KLTConfig, track_pair
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig
    from fastmatch_tpu_torch.pipeline.stereo_vo import StereoVOConfig, stereo_visual_odometry
    from fastmatch_tpu_torch.pipeline.vo import VOConfig, visual_odometry
    from fastmatch_tpu_torch.pipeline.vo_scan import _BOOT_CHUNK, visual_odometry_scan

    wrappers = _kernel_wrappers()
    t0 = time.perf_counter()
    scene, left, right = render_vo_scene()
    n = len(left)
    out = dict(render_seconds=time.perf_counter() - t0, jax_cpu=JAX_VO, runs={}, card_vs_cpu={})
    cam = Pinhole.from_K(scene.K)
    cfg = PipelineConfig()
    vo = VOConfig()
    levels = vo.klt.levels
    gt = _centers_np(scene.R[:n], scene.t[:n])
    runs = out["runs"]
    recs = {
        "host": _vo_run("host", lambda: visual_odometry(left, cam, cfg, vo, device=DEV), gt, n,
                        runs, wrappers),
        "host_again": _vo_run("host_again", lambda: visual_odometry(left, cam, cfg, vo,
                                                                    device=DEV), gt, n, runs,
                              wrappers),
        "scan": _vo_run("scan", lambda: visual_odometry_scan(left, cam, cfg, vo, device=DEV), gt,
                        n, runs, wrappers),
        "scan_again": _vo_run("scan_again", lambda: visual_odometry_scan(left, cam, cfg, vo,
                                                                         device=DEV), gt, n,
                              runs, wrappers),
        "stereo": _vo_run("stereo", lambda: stereo_visual_odometry(
            left, right, cam, VO_BASELINE, cfg, StereoVOConfig(), device=DEV), gt, n, runs,
            wrappers),
    }
    fails = []
    parity = dict(host_runs_bit_identical=_same_rec(recs["host"], recs["host_again"]),
                  scan_runs_bit_identical=_same_rec(recs["scan"], recs["scan_again"]))
    out["parity"] = parity
    fails += [f"parity: {k} is false" for k, v in parity.items() if not v]
    for name, st in runs.items():
        la = st["launches"]
        engine = name.replace("_again", "")
        # Tracked frames: every frame after the first, and in the scan
        # engine the rest of the bootstrap's last chunk again.
        tracked = n - 1
        if engine == "scan":
            fb = st["boot"][0]
            chunk_end = min(1 + _BOOT_CHUNK * ((fb - 1) // _BOOT_CHUNK + 1), n)
            tracked = (chunk_end - 1) + (n - 1 - fb)
        st["tracked_frames"] = tracked
        st["k3_launches_per_tracked_frame"] = la["gather_patch_sets"] / tracked
        if la["gather_patch_sets"] != (1 + levels) * tracked or la["gather_patches"]:
            fails.append(f"{name}: K3 launches {la}, want {1 + levels} a tracked frame "
                         f"({tracked} frames)")
        if la["batch_match"] or la["distance_topk"]:
            fails.append(f"{name}: K1 or K2 launched: {la}")
        fails += [f"{name}: kernel {k} not launched"
                  for k in ("sorted_segment_sum", "sorted_gather_rows") if la[k] <= 0]
        if st["posed"] != n or st["n_frames"] != n or not st["finite"]:
            fails.append(f"{name}: {st['posed']}/{n} frames posed, or non-finite output")
        if engine == "stereo":
            scale_tol = ATE_SPREAD_MARGIN * max(abs(x - 1) for x in JAX_VO[engine]["scale_seeds"])
            if (len(st["pnp_failed"]) > VO_MAX_FALLBACKS or abs(st["scale"] - 1) > scale_tol
                    or not st["ate_rigid"] < VO_RIGID_ATE):
                fails.append(f"stereo: fallbacks {st['pnp_failed']}, scale {st['scale']}, rigid "
                             f"ATE {st['ate_rigid']}")
            continue
        fb = st["boot"][0]
        st["ate_from_boot"] = _ate_np(_centers_np(recs[name].R[fb:n], recs[name].t[fb:n]),
                                      gt[fb:])
        ref = max(JAX_VO[engine]["ate_from_boot_seeds"])
        st["jax_ate_range_seeds_0_7"] = [min(JAX_VO[engine]["ate_seeds"]),
                                         max(JAX_VO[engine]["ate_seeds"])]
        if (st["pnp_failed"] or not st["ate"] < ATE_GATE
                or st["ate_from_boot"] > ATE_SPREAD_MARGIN * ref):
            fails.append(f"{name}: fallbacks {st['pnp_failed']}, ATE {st['ate']} (gate < "
                         f"{ATE_GATE}), ATE from the boot frame {st['ate_from_boot']} (gate <= "
                         f"{ATE_SPREAD_MARGIN} x {ref})")

    # ---- card against CPU ----
    cmp_ = out["card_vs_cpu"]
    for w in wrappers.values():
        w.launches = 0
    klt = KLTConfig()
    t0 = time.perf_counter()
    card = [x.cpu().numpy() for x in track_pair(left[0], left[1], klt, capacity=1024,
                                                device=DEV)]
    card_s = time.perf_counter() - t0
    k3_track = wrappers["gather_patch_sets"].launches
    cpu = [x.numpy() for x in track_pair(left[0], left[1], klt, capacity=1024, device="cpu")]
    same0 = (card[0] == cpu[0]).all(1)
    st_card, st_cpu = card[2][same0], cpu[2][same0]
    both = st_card & st_cpu
    d = dict(corners_equal=float(same0.mean()), status_agreement=float((st_card == st_cpu).mean()),
             live=int(both.sum()),
             max_dxy=float(np.abs(card[1][same0][both] - cpu[1][same0][both]).max())
             if both.any() else None, seconds=card_s, k3_launches=k3_track)
    cmp_["track_pair_1024"] = d
    if (d["corners_equal"] < 0.99 or d["status_agreement"] < 0.99 or not both.any()
            or d["max_dxy"] > 0.01 or k3_track != 1 + levels):
        fails.append(f"track_pair card vs CPU: {d}")

    def disparity(a, b, rect, dev):
        if rect is not None:
            a, b, _ = rectify_pair(a, b, scene.K, *rect, device=dev)
        return (x.cpu().numpy() for x in stereo_disparity(a, b, device=dev))

    def stereo_cmp(name, a, b, rect):
        t0 = time.perf_counter()
        dc, vc = disparity(a, b, rect, DEV)
        secs = time.perf_counter() - t0
        dp, vp = disparity(a, b, rect, "cpu")
        bothv = vc & vp
        r = dict(valid_frac_card=float(vc.mean()), valid_frac_cpu=float(vp.mean()),
                 valid_frac_jax_cpu=JAX_VO[f"{name}_valid_frac"],
                 mask_agreement=float((vc == vp).mean()),
                 max_ddisp=float(np.abs(dc[bothv] - dp[bothv]).max()) if bothv.any() else None,
                 seconds=secs)
        cmp_[name] = r
        if r["mask_agreement"] < 0.999 or not bothv.any() or r["max_ddisp"] > 1e-3:
            fails.append(f"{name} card vs CPU: {r}")

    stereo_cmp("rectified_pair", left[0], right[0], None)
    i, j = VO_UNRECTIFIED_PAIR
    R_ab = scene.R[j] @ scene.R[i].T
    stereo_cmp("unrectified_pair_0_6", left[i], left[j], (R_ab, scene.t[j] - R_ab @ scene.t[i]))

    host = recs["host"]
    F = host.n_frames
    args = (left[:F], host.R[:F], host.t[:F], scene.K)
    kw = dict(sparse_points=host.points[host.pt_mask])
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    _, _, rep_card = densify(*args, **kw, device=DEV)
    dens_s = time.perf_counter() - t0
    _, _, rep_cpu = densify(*args, **kw, device="cpu")
    r = dict(card=rep_card, cpu=rep_cpu, seconds=dens_s,
             launches={k: w.launches for k, w in wrappers.items()})
    cmp_["densify"] = r
    if (rep_card["pairs_used"] != rep_cpu["pairs_used"] or rep_card["pairs_used"] < 1
            or abs(rep_card["n_points"] - rep_cpu["n_points"]) > 0.02 * rep_cpu["n_points"]):
        fails.append(f"densify card vs CPU: {rep_card} vs {rep_cpu}")

    with tempfile.TemporaryDirectory() as tmp:
        traj, imu, _ = imu_circle()
        np.savez(os.path.join(tmp, "traj.npz"), **traj)
        np.savez(os.path.join(tmp, "imu.npz"), **imu)
        argv = ["vialign", "--traj", os.path.join(tmp, "traj.npz"), "--imu",
                os.path.join(tmp, "imu.npz"), "--out", os.path.join(tmp, "m.npz")]
        vc, secs = _cli(argv)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", "cpu", *argv])
        vp = json.loads(buf.getvalue().strip().splitlines()[-1])
    vc = vc[-1]
    r = dict(card=vc, cpu=vp, seconds=secs)
    cmp_["vialign"] = r
    if (abs(vc["scale"] - vp["scale"]) > 1e-4 * abs(vp["scale"])
            or np.abs(np.subtract(vc["gravity"], vp["gravity"])).max() > 1e-4 * 9.81):
        fails.append(f"vialign card vs CPU: {r}")
    log("vo_paths card vs CPU", json.dumps(cmp_))
    if fails:
        raise AssertionError(f"VO paths: {fails}")
    return {k: runs[k]["launches"] for k in ("host", "scan", "stereo")}, out


def _centers_np(R, t):
    import numpy as np

    return -np.einsum("fji,fj->fi", np.asarray(R, np.float64), np.asarray(t, np.float64))


def _ate_np(est, gt):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from vo_fixtures import ate

    return ate(est, gt)


def jittered_ba_problem(rec):
    """The main path's final BA problem (its live observation table), with
    its points and non-gauge camera centres moved by seeded noise of 1% of
    their spread so that LM iterates."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.pipeline.tracker import compact_obs

    prob = compact_obs(rec.ba_problem(), int(rec.obs_mask.sum()))
    rng = np.random.default_rng(0)

    def jitter(x, mask):
        x = x.cpu().numpy()
        noise = 0.01 * x[mask].std(0) * rng.standard_normal(x.shape)
        return torch.from_numpy((x + noise * mask[:, None]).astype(np.float32)).to(DEV)

    moving = (prob.cam_mask & ~prob.fixed_cams).cpu().numpy()
    return prob._replace(points=jitter(prob.points, prob.pt_mask.cpu().numpy()),
                         poses=prob.poses._replace(t=jitter(prob.poses.t, moving)))


def grouped_ba(rec):
    """``ba_solve(grouped="auto")`` against the default on the main path's
    final BA problem (its live observation table, BA's config), with its
    points and non-gauge camera centres moved by seeded noise of 1% of
    their spread so that LM iterates. Gates: the grouped and the default
    assembly of that problem each within GROUPED_ASSEMBLY_RTOL of the
    float64 sums (``_assemblies``); the final costs within
    GROUPED_BA_RTOL; two grouped solves bit-identical (the grouped path
    has no scatter; K4 sums the PCG loop in a fixed order)."""
    import torch

    from fastmatch_tpu_torch.ba.lm import ba_solve

    cfg = rec.cfg.ba
    prob = jittered_ba_problem(rec)
    huber = cfg.huber_px / float(rec.camera.fx)
    kw = dict(device=DEV, max_iters=cfg.max_iters, pcg_iters=cfg.pcg_iters,
              huber_delta_static=huber)
    out, res = {"assembly": _assemblies(prob, huber)}, {}
    for name, grouped in (("default", None), ("grouped", "auto"), ("grouped_again", "auto")):
        t0 = time.perf_counter()
        res[name] = ba_solve(prob, grouped=grouped, **kw)
        torch.cuda.synchronize()
        out[name] = dict(cost0=float(res[name].cost0), cost=float(res[name].cost),
                         iters=res[name].iters, seconds=time.perf_counter() - t0)
    a, b = res["grouped"], res["grouped_again"]
    out["grouped_bit_identical"] = bool(torch.equal(a.points, b.points)
                                        and torch.equal(a.poses.R, b.poses.R)
                                        and torch.equal(a.cost, b.cost))
    out["observations"] = int(prob.obs.mask.sum())
    log("grouped_ba", json.dumps(out))
    d, g = out["default"]["cost"], out["grouped"]["cost"]
    errs = out["assembly"]
    if (abs(d - g) > GROUPED_BA_RTOL * abs(d) or not out["grouped_bit_identical"]
            or not g < out["grouped"]["cost0"] or errs["cost_grouped"] != errs["cost_default"]
            or max(errs["grouped_rel_err"].values()) > GROUPED_ASSEMBLY_RTOL
            or max(errs["default_rel_err"].values()) > GROUPED_ASSEMBLY_RTOL):
        raise AssertionError(f"grouped BA: {out}")
    return out


# The assemblies' bound: max abs error over the largest |block| against
# float64 sums of the same per-observation terms. Float32 sums measure
# 2.7e-7 at 512 observations on the CPU; an observation missing from one
# of a camera's ~350 moves its Hcc by ~3e-3.
GROUPED_ASSEMBLY_RTOL = 5e-6


def _assemblies(prob, huber):
    """The grouped (``assemble_grouped``) and the default (``assemble``,
    K4's sums) assembly of the point-sorted problem, each block set (Hcc,
    Hpp, gc, gp) held against the plain version's sums of the same
    per-observation terms in float64: max abs error over the largest
    |block|; and the two costs."""
    import torch

    from fastmatch_tpu_torch.ba.lm import sort_obs_by_point
    from fastmatch_tpu_torch.ba.schur import (assemble, assemble_grouped, group_observations,
                                              residuals_and_jacobians, segment_keys)
    from fastmatch_tpu_torch.kernels.segment_ops import segment_sum_plain

    p = sort_obs_by_point(prob.to(DEV))
    C, P = p.n_cams, p.n_points
    keys = segment_keys(p.obs, C, P)
    grouped = group_observations(p.obs, C, P)
    sys_d, cost_d = assemble(p.poses, p.points, p.obs, C, P, huber, keys)
    sys_g, cost_g = assemble_grouped(p.poses, p.points, p.obs, grouped, C, P, huber, keys)
    r, Jc, Jp, w = (x.double() for x in residuals_and_jacobians(p.poses, p.points, p.obs,
                                                                 huber, keys))
    wv = w[:, None, None]
    ci, pi = p.obs.cam_idx.long(), p.obs.pt_idx.long()

    def plain(v, idx, n):
        return segment_sum_plain(v.reshape(v.shape[0], -1), idx, n).reshape((n,) + v.shape[1:])

    ref = dict(Hcc=plain(torch.einsum("oki,okj->oij", Jc * wv, Jc), ci, C),
               Hpp=plain(torch.einsum("oki,okj->oij", Jp * wv, Jp), pi, P),
               gc=-plain(torch.einsum("oki,ok->oi", Jc * wv, r), ci, C),
               gp=-plain(torch.einsum("oki,ok->oi", Jp * wv, r), pi, P))

    def rel(sys):
        return {k: float((getattr(sys, k).double() - v).abs().max()
                         / v.abs().max().clamp(min=1e-30)) for k, v in ref.items()}

    return dict(grouped_rel_err=rel(sys_g), default_rel_err=rel(sys_d),
                cost_grouped=float(cost_g), cost_default=float(cost_d))


FIVE_POINT_TOL_DEG = 0.1
# The minimal solver's own gates, before RANSAC's 8-point refit (see
# ``_five_point_samples``). On frames 0-1 of the smoke scene (1.4 degrees
# apart) a sample's best candidate explains a median 0.957 of the
# 8-point's inliers, and at least 0.8 of them in 0.889 of the samples (the
# port on the CPU, seed 1); with one coefficient block of the solver's
# constraint matrix negated, 0.695 of the samples do, and RANSAC's result
# after the refit is unchanged. The card's rounding moves single samples'
# candidates (the root bracketing is sensitive; 29% of the samples differ
# by more than 0.01 of support from the CPU's on the H100) but not the
# share: 0.871 on the card against 0.879 on the CPU.
FIVE_POINT_SUPPORT = 0.95
FIVE_POINT_GOOD_SHARE = 0.8
FIVE_POINT_MIN_GOOD = 0.8
FIVE_POINT_CPU_SLACK = 0.05


def five_point(scene, views):
    """``ransac_essential(solver="5pt")`` beside the 8-point solver on the
    matches of frames 0 and 1 (SIFT and K2 on the card, normalized by the
    scene's K; the same n_hyp and threshold as the bootstrap). Gates: the
    5-point rotation error (degrees, against the scene's relative pose)
    within FIVE_POINT_TOL_DEG of the 8-point's after RANSAC, and the
    minimal solver's gates before its refit (``_five_point_samples``)."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.camera import Pinhole, normalize_np
    from fastmatch_tpu_torch.features.sift import detect_and_describe
    from fastmatch_tpu_torch.geometry.ransac import ransac_essential
    from fastmatch_tpu_torch.matching.matcher import match_pair
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig

    cfg = PipelineConfig()
    cam = Pinhole.from_K(scene.K)
    (k0, d0), (k1, d1) = (detect_and_describe(v, cfg.sift, device=DEV) for v in views[:2])
    m = match_pair(d1, d0, device=DEV)
    q = torch.nonzero(m.valid)[:, 0]
    x1 = normalize_np(k1.xy[q].cpu().numpy().astype(np.float64), cam).astype(np.float32)
    x0 = normalize_np(k0.xy[m.idx[q].long()].cpu().numpy().astype(np.float64),
                      cam).astype(np.float32)
    R_gt = scene.R[1] @ scene.R[0].T
    out = dict(matches=int(q.shape[0]))
    thr = (cfg.ransac.thr_px / cam.fx) ** 2
    res = {}
    for solver in ("8pt", "5pt"):
        t0 = time.perf_counter()
        res[solver] = r = ransac_essential(
            torch.from_numpy(x0), torch.from_numpy(x1), torch.ones(len(x0), dtype=torch.bool),
            thr=thr, n_hyp=cfg.ransac.n_hyp, solver=solver,
            generator=torch.Generator(DEV).manual_seed(0), device=DEV)
        out[solver] = dict(ok=bool(r.ok), n_inliers=int(r.n_inliers),
                           rot_err_deg=float(_rot_err_deg(r.R.cpu().double().numpy(), R_gt)),
                           seconds=time.perf_counter() - t0)
    out["samples"] = _five_point_samples(x0, x1, res["8pt"].inliers, thr, cfg.ransac.n_hyp)
    log("five_point", json.dumps(out))
    s = out["samples"]
    if not (out["5pt"]["ok"] and out["5pt"]["rot_err_deg"]
            <= out["8pt"]["rot_err_deg"] + FIVE_POINT_TOL_DEG
            and s["support_5pt"] >= FIVE_POINT_SUPPORT * s["support_8pt"]
            and s["good_card"] >= FIVE_POINT_MIN_GOOD
            and s["good_card"] >= s["good_cpu"] - FIVE_POINT_CPU_SLACK):
        raise AssertionError(f"5-point RANSAC: {out}")
    return out


def _rot_err_deg(R, R_gt):
    """Angle (degrees) of R R_gt^T, over any leading axes."""
    import numpy as np

    cos = (np.einsum("...ij,ij->...", R, R_gt) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def _five_point_samples(x0, x1, inliers, thr, n_hyp):
    """The 5-point solver on its own, before RANSAC's 8-point refit (which
    would hide a broken solver on clean matches). ``n_hyp`` seeded samples
    of 5 and of 8 matches: ``support_5pt`` and ``support_8pt`` are the
    largest Sampson support of any candidate E (gate: the 5-point's at
    least FIVE_POINT_SUPPORT of the 8-point's). Then ``n_hyp`` samples of
    5 of the 8-point RANSAC's inliers through ``five_point_essential`` on
    the card and on the CPU (the same inputs; both candidate sets scored on
    the CPU): a sample's best support is the largest share of those
    inliers that one of its candidates explains. ``good_card`` and
    ``good_cpu`` are the share of samples whose best support is at least
    FIVE_POINT_GOOD_SHARE (gates: at least FIVE_POINT_MIN_GOOD, and the
    card's at least the CPU's less FIVE_POINT_CPU_SLACK), and
    ``card_cpu_differ`` the share whose best support differs by more than
    0.01 between the two (printed, not gated: see above)."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.geometry.epipolar import eight_point_essential, sampson_error
    from fastmatch_tpu_torch.geometry.five_point import five_point_essential
    from fastmatch_tpu_torch.geometry.ransac import _sample_minimal_sets

    a, b = torch.from_numpy(x0).to(DEV), torch.from_numpy(x1).to(DEV)
    gen = torch.Generator(DEV).manual_seed(1)
    live = torch.ones(a.shape[0], dtype=torch.bool, device=DEV)

    def support(Es, ok, a, b):
        return ((sampson_error(Es, a[None], b[None]) < thr) & ok[:, None]).sum(1)

    idx5, idx8 = (_sample_minimal_sets(gen, live, n_hyp, k) for k in (5, 8))
    E5, ok5 = five_point_essential(a[idx5], b[idx5])
    ones = torch.ones(n_hyp, dtype=torch.bool, device=DEV)
    out = dict(support_5pt=int(support(E5.reshape(-1, 3, 3), ok5.reshape(-1), a, b).max()),
               support_8pt=int(support(eight_point_essential(a[idx8], b[idx8]), ones,
                                       a, b).max()))
    idx = _sample_minimal_sets(gen, inliers.to(DEV), n_hyp, 5)
    n_in = int(inliers.sum())
    ac, bc = a.cpu(), b.cpu()
    best = {}
    for where, (xa, xb) in (("card", (a[idx], b[idx])), ("cpu", (ac[idx.cpu()], bc[idx.cpu()]))):
        E, ok = five_point_essential(xa, xb)
        k = E.shape[-3]
        sup = support(E.cpu().reshape(-1, 3, 3), ok.cpu().reshape(-1), ac, bc)
        best[where] = sup.reshape(n_hyp, k).max(1).values.double().numpy() / n_in
        out[f"good_{where}"] = float((best[where] >= FIVE_POINT_GOOD_SHARE).mean())
        out[f"median_best_support_{where}"] = float(np.median(best[where]))
    out["card_cpu_differ"] = float((np.abs(best["card"] - best["cpu"]) > 0.01).mean())
    return out


# -- phase 11: the saved map's product surface ----------------------------------

# Held-out views: the orbit's midpoints between keyframes k and k + 1.
HELD_OUT_KEYFRAMES = tuple(range(4, 120, 10))   # 4, 14, ..., 114
LOCATE_ROT_DEG = 1.0      # pose gates after the map's sim(3) alignment (ATE's)
LOCATE_CENTER = 0.05      # scene units
LOCATE_MIN_OK = 10        # of the 12 views
RESUME_SNAPSHOT_FID = 28  # save_track_state after this frame id of the 56-frame run
# Merge: sessions of frames 0-69 and 50-119, B moved by a known Sim(3).
MERGE_SESSIONS = ((0, 70), (50, 120))
MERGE_SIM3 = dict(scale=1.7, yaw_deg=30.0, t=(0.5, -0.2, 0.8))
MERGE_SCALE_TOL = 0.01
MERGE_RMSE = 0.05         # scene units
# BASELINE.json config 5's retrieval leg: 10,000 keyframes x 400 descriptors.
CITY = dict(n_kf=10_000, per_kf=400, seed=0, radius=(50.0, 100.0))
CITY_PEAK_BYTES = 40e9
CITY_SERVED = 4
# IVF parity: the generator at 262,144 rows, match_pair_ann_big(budget 65,536,
# 8 probes) against exact search, both with the cross-check.
CITY_PARITY = dict(n_kf=1024, per_kf=256, seed=1, budget=65_536, n_probe=8)
IVF_PARITY_TOL = 0.03
# The JAX package's figure on CITY_PARITY's inputs, on a CPU:
# ``python tools/jax_city_reference.py`` (k-means from PRNGKey(0), 512
# clusters: build_map_index's default rule at 262,144 rows). Of the 2048
# queries (768 live: the rows of 3 keyframes x 256, shuffled)
# exact search validates 757, the shortlist 243, and those agree on every
# one.
JAX_CITY = dict(rows=262144, n_clusters=512, seed=1, key=0, budget=65536, n_probe=8,
                agreement=1.0, co_valid=243, exact_valid=757, ivf_valid=243)


def make_city(n_kf, per_kf, rng):
    """Synthetic city bank with loop-closure structure (the generator of
    ``benchmarks/city_bench.py``'s ``_make_city``, its normal draws made in
    float32): a codebook of ~16 rows a word, keyframe k drawing its words
    from a sliding window of it (consecutive keyframes share words), rows
    |word + 0.3 N(0, 1)| normalized. Returns (bank (M, 128) grouped per
    keyframe, query (2048, 128), qmask, j): the query re-observes keyframes
    j..j+2 (a revisit of one place)."""
    import numpy as np

    def unit(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    M = n_kf * per_kf
    n_words = max(4096, M // 16)
    wpk = n_words // n_kf
    words = unit(np.abs(rng.standard_normal((n_words, 128), dtype=np.float32)))
    chunks = []
    kf_per_chunk = max(1, (1 << 20) // per_kf)
    for k0 in range(0, n_kf, kf_per_chunk):
        ks = np.arange(k0, min(k0 + kf_per_chunk, n_kf))
        base = np.repeat(ks * wpk, per_kf)
        wid = (base + rng.integers(0, max(3 * wpk, 1), base.shape[0])) % n_words
        w = words[wid]
        chunks.append(unit(np.abs(w + 0.3 * rng.standard_normal(w.shape, dtype=np.float32))))
    bank = np.concatenate(chunks)
    j = int(rng.integers(0, n_kf - 3))
    src = np.arange(j * per_kf, (j + 3) * per_kf)
    rng.shuffle(src)
    src = src[:min(2048, src.shape[0])]
    q = np.zeros((2048, 128), np.float32)
    q[:src.shape[0]] = unit(np.abs(bank[src] + 0.05 * rng.standard_normal(
        (src.shape[0], 128), dtype=np.float32)))
    qmask = np.zeros(2048, bool)
    qmask[:src.shape[0]] = True
    return bank, q, qmask, j


def shortlist_agreement(exact, ivf):
    """(agreement, co-valid count): the fraction of queries valid in both
    searches whose matches agree (``benchmarks/city_bench.py``'s figure)."""
    both = exact.valid & ivf.valid
    n = int(both.sum())
    agree = float((exact.idx[both] == ivf.idx[both]).float().mean()) if n else float("nan")
    return agree, n


def render_held_out_views():
    """(scene, frames) of the held-out views: the config-4 orbit's 400
    landmarks with their appearance (the same draws as
    ``render_config4_scene``) seen from the midpoints of the 120-frame
    orbit between keyframes k and k + 1, k in HELD_OUT_KEYFRAMES."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import render_scene_views

    p = CONFIG4_SCENE
    rng = np.random.default_rng(p["seed"])
    points = rng.uniform(-2.0, 2.0, size=(p["n_points"], 3))
    a = config4_angles(DEVICE_SLAM_FRAMES)
    mids = np.array([(a[k] + a[k + 1]) / 2 for k in HELD_OUT_KEYFRAMES])
    scene = OrbitScene(points, mids, p["radius"], p["image_size"])
    return scene, render_scene_views(scene, rng, image_size=p["image_size"])


def _rot_deg(R):
    import numpy as np

    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def _map_alignment(rec, frame_seq, scene):
    """The map's alignment to ground truth: ``s``, ``R``, ``t`` of ATE's
    ``align_umeyama`` of the map's camera centres onto the scene's; and
    ``R_orient``, the world rotation that best carries the map's keyframe
    orientations onto the scene's (the projection onto SO(3) of the sum of
    R_gt_k^T R_map_k), with the median keyframe rotation error under each."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.utils.evaluation import align_umeyama

    seq = np.asarray(frame_seq)
    gt = -np.einsum("fji,fj->fi", scene.R[seq], scene.t[seq])
    s, R, t = align_umeyama(torch.from_numpy(rec.camera_centers().astype(np.float32)),
                            torch.from_numpy(gt.astype(np.float32)))
    R = R.numpy().astype(np.float64)
    Rm = rec.R[:len(seq)].astype(np.float64)
    Rg = scene.R[seq].astype(np.float64)
    U, _, Vt = np.linalg.svd(np.einsum("kji,kjl->il", Rg, Rm))
    Ro = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    return dict(s=float(s), R=R, t=t.numpy().astype(np.float64), R_orient=Ro,
                keyframe_rot_err_median=float(np.median(
                    [_rot_deg(a @ R.T @ b.T) for a, b in zip(Rm, Rg)])),
                keyframe_rot_err_orient_median=float(np.median(
                    [_rot_deg(a @ Ro.T @ b.T) for a, b in zip(Rm, Rg)])))


def _view_errors(align, R, t, R_gt, t_gt):
    """(centre error in scene units, rotation error in degrees under the
    centre alignment, and under ``R_orient``) of a pose in the map's frame
    against ground truth."""
    import numpy as np

    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    c = align["s"] * align["R"] @ (-R.T @ t) + align["t"]
    c_gt = -R_gt.T @ t_gt
    return (float(np.linalg.norm(c - c_gt)), _rot_deg(R @ align["R"].T @ R_gt.T),
            _rot_deg(R @ align["R_orient"].T @ R_gt.T))


def _within(errors):
    """A localized view within the gates: (centre error, rotation error
    under the map's ATE alignment, under ``R_orient``) from
    ``_view_errors``, None for a view that did not localize. The gates read
    the first two."""
    return errors is not None and errors[0] < LOCATE_CENTER and errors[1] < LOCATE_ROT_DEG


def _reset_launches(wrappers):
    import torch

    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0


def _read_launches(wrappers):
    import torch

    torch.cuda.synchronize()
    return {k: w.launches for k, w in wrappers.items()}


def _device_time(call, names, per_call, n):
    """Device us per call by ``torch.profiler`` over ``n`` calls (each
    ``per_call`` launches of kernels called ``names``), recorded only when
    the profiler saw every launch (late in this long process it drops
    some: then None, with the count it saw and the mean us of the launches
    it saw), and the ms per call by CUDA events around each call alone
    (synchronized, so launch gaps inside a call are in it)."""
    import statistics

    import torch

    us, seen = device_us(call, names, n=n)
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return dict(device_us_per_call=us * per_call if seen == per_call * n else None,
                device_us_per_launch_seen=us, profiled_launches=seen,
                expected_launches=per_call * n, event_ms_per_call=statistics.median(times))


def _slabbed_k2_plain(a, b, b2m, a2m, slab=128):
    """``distance_topk_plain`` of (N, D) queries against an (M, D) bank in
    query slabs of ``slab`` rows: the row outputs slab by slab, the column
    argmin as the running minimum of the kernels' 64-bit column key
    (``order_key``: the value, then the lowest row). Equal to the one-piece
    plain version, in (slab, M) memory."""
    import torch

    from fastmatch_tpu_torch.kernels import distance_topk as k2

    rows = []
    best = None
    for s0 in range(0, a.shape[0], slab):
        a_s, a2_s = a[s0:s0 + slab], a2m[s0:s0 + slab]
        neg2 = -2.0 * (a_s @ b.T)
        v1, i1, v2 = k2.plain_top2(neg2 + b2m[None, :])
        rows.append((i1.to(torch.int32), torch.clamp(v1 + a2_s, min=0.0),
                     torch.clamp(v2 + a2_s, min=0.0)))
        r = torch.arange(s0, s0 + a_s.shape[0], device=a.device)[:, None]
        key = k2.order_key(neg2 + a2_s[:, None], r.expand_as(neg2)).min(dim=0).values
        best = key if best is None else torch.minimum(best, key)
        del neg2
    i1, d1, d2 = (torch.cat(x) for x in zip(*rows))
    return i1, d1, d2, (best & 0xFFFFFFFF).to(torch.int32)


def _k2_at(name, a, b, mask_a, mask_b, check=True, product_slab=None, time_plain=False):
    """K2 at one of the path's shapes: raw outputs against the plain
    version (in query slabs), wrapper ms, device us per call, the product
    alone (``product_only_ms``; over bank slabs of ``product_slab`` rows
    into one buffer where the whole (N, M) product would not fit), the
    bound by fp32 operations, and with ``time_plain`` the plain version's
    ms (``distance_topk_plain`` in one piece, or above 1e9 distances in the
    query slabs of ``_slabbed_k2_plain``, where one piece would not fit)."""
    import torch

    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.matching.matcher import BIG

    a, b = a.contiguous(), b.contiguous()
    a2m = torch.where(mask_a, (a * a).sum(-1), BIG).contiguous()
    b2m = torch.where(mask_b, (b * b).sum(-1), BIG).contiguous()
    n, m = a.shape[0], b.shape[0]
    call = lambda: k2.distance_topk(a, b, b2m, a2m)  # noqa: E731
    d = dict(name=name, shape=[n, m, a.shape[1]])
    if check:
        ki1, kd1, kd2, knnb = call()
        pi1, pd1, pd2, pnnb = _slabbed_k2_plain(a, b, b2m, a2m)
        d.update(idx1_equal=bool(torch.equal(ki1, pi1)),
                 nnb_equal=bool(torch.equal(knnb[mask_b], pnnb[mask_b])),
                 max_abs_err=max((kd1 - pd1).abs().max().item(), (kd2 - pd2).abs().max().item()))
    reps = 3 if n * m > 1e9 else 10
    d["ms"] = cuda_ms(call, batches=3, reps=reps)
    d.update(_device_time(call, K2_KERNELS, 2, 20 if n * m > 1e9 else 50))
    if product_slab is None:
        d["product_only_ms"] = cuda_ms(lambda: a @ b.T, batches=3, reps=reps)
    else:
        buf = a.new_empty((n, product_slab))
        slabs = [b[s:s + product_slab] for s in range(0, m, product_slab)]

        def product():
            for bs in slabs:
                torch.matmul(a, bs.T, out=buf[:, :bs.shape[0]])

        d["product_only_ms"] = cuda_ms(product, batches=3, reps=1)
    if time_plain:
        plain = _slabbed_k2_plain if n * m > 1e9 else k2.distance_topk_plain
        d["plain_ms"] = cuda_ms(lambda: plain(a, b, b2m, a2m), batches=2, reps=1)
    d["bound_ms"], d["bound_by"] = bound(4 * (n * 128 + m * 128 + n + m) + 4 * (3 * n + m),
                                         2.0 * n * m * a.shape[1])
    log("K2 at", json.dumps(d))
    return d


def _k4_kmeans_shape(data, assign, k):
    """K4 at k-means' cluster-sum shape (the bank's rows sorted by cluster,
    K segments): against its plain version (float sums in another order:
    the largest error relative to the largest sum), wrapper ms, device us,
    and ``torch.segment_reduce`` as the library time."""
    import torch

    from fastmatch_tpu_torch.kernels import segment_ops as k4

    keys = assign.to(torch.int32)
    order = torch.argsort(keys, stable=True)
    sk = keys[order].contiguous()
    vals = data[order].contiguous()
    off = k4.segment_offsets(sk, k)
    max_len = int(k4.segment_lengths(off).max())
    got = k4.sorted_segment_sum(vals, sk, k, offsets=off, max_len=max_len)
    ref = k4.segment_sum_plain(vals, sk, k)
    call = lambda: k4.sorted_segment_sum(vals, sk, k, offsets=off, max_len=max_len)  # noqa: E731
    lengths = k4.segment_lengths(off)
    d = dict(rows=int(vals.shape[0]), cols=int(vals.shape[1]), segments=k,
             longest_segment=max_len,
             max_rel_err=((got - ref).abs().max() / ref.abs().max()).item(),
             bit_identical_rerun=bool(torch.equal(call(), got)),
             ms=cuda_ms(call, batches=3, reps=5),
             plain_ms=cuda_ms(lambda: k4.segment_sum_plain(vals, sk, k), batches=3, reps=5),
             library_ms=cuda_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths),
                                batches=3, reps=5))
    d.update(_device_time(call, {"segsum_short", "segsum_long"}, 1, 50))
    d["bound_ms"], d["bound_by"] = bound(4 * (vals.numel() + k + 1 + k * vals.shape[1]),
                                         float(vals.numel()))
    log("map_services K4", json.dumps(d))
    return d


def _track_saver(fid, path):
    """``SlamHooks`` that save the run with ``save_track_state`` after frame
    id ``fid``."""
    from fastmatch_tpu_torch.pipeline.checkpoint import save_track_state
    from fastmatch_tpu_torch.pipeline.slam_device import SlamHooks

    class Saver(SlamHooks):
        def after_frame(self, state, f, fi, out, book):
            if f == fid:
                save_track_state(state, book, out, path)

    return Saver()


def _checkpoints(rec120, cam, feats56, tmp):
    """save_map/restore_map of the 120-frame map, the config-hash guard, and
    the 56-frame slam_device run saved after frame RESUME_SNAPSHOT_FID and
    resumed from its track.pt."""
    import dataclasses

    import numpy as np

    from fastmatch_tpu_torch.pipeline.checkpoint import (restore_map, restore_track_state,
                                                         save_map)
    from fastmatch_tpu_torch.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction
    from fastmatch_tpu_torch.pipeline.slam import SlamConfig
    from fastmatch_tpu_torch.pipeline.slam_device import drive_slam

    names = ("R", "t", "pose_mask", "points", "pt_mask", "pt_desc", "obs_cam", "obs_pt",
             "obs_uv", "obs_mask")
    out = {}
    t0 = time.perf_counter()
    save_map(rec120, os.path.join(tmp, "map120"))
    out["save_map_seconds"] = time.perf_counter() - t0
    out["map_pt_bytes"] = os.path.getsize(os.path.join(tmp, "map120", "map.pt"))
    t0 = time.perf_counter()
    back = restore_map(Reconstruction(cfg=rec120.cfg, camera=cam), os.path.join(tmp, "map120"))
    out["restore_map_seconds"] = time.perf_counter() - t0
    out["roundtrip_equal"] = (all(np.array_equal(getattr(back, k), getattr(rec120, k))
                                  for k in names)
                              and (back.n_frames, back.n_points, back.n_obs)
                              == (rec120.n_frames, rec120.n_points, rec120.n_obs))
    other = dataclasses.replace(rec120.cfg, ba=dataclasses.replace(rec120.cfg.ba, interval=3))
    try:
        restore_map(Reconstruction(cfg=other, camera=cam), os.path.join(tmp, "map120"))
        out["mismatch_raises"] = False
    except ValueError:
        out["mismatch_raises"] = True
    cfg56, scfg = PipelineConfig(map=MapConfig(max_frames=64)), SlamConfig()
    track = os.path.join(tmp, "track56")
    t0 = time.perf_counter()
    full = drive_slam(feats56, cam, cfg56, scfg, hooks=_track_saver(RESUME_SNAPSHOT_FID, track),
                      device=DEV)
    out["uninterrupted_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = drive_slam(feats56, cam, cfg56, scfg, resume=restore_track_state(track, DEV),
                         device=DEV)
    out["resumed_seconds"] = time.perf_counter() - t0
    out["resume_bit_identical"] = (
        _same_map(resumed, full, names)
        and [e[:2] for e in resumed.loop_edges] == [e[:2] for e in full.loop_edges]
        and all(np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3]) for x, y in
                zip(resumed.odo_edges + resumed.loop_edges, full.odo_edges + full.loop_edges))
        and resumed.pgo_runs == full.pgo_runs)
    out.update(frames_tracked=full.rec.n_frames, loop_edges=len(full.loop_edges),
               pgo_runs=full.pgo_runs)
    log("map_services checkpoints", json.dumps(out))
    return out


def _http(port, path, body=None):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        out = json.loads(r.read())
    return out, 1e3 * (time.perf_counter() - t0)


def _npz_body(xy, d, m):
    import io

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, xy=xy, desc=d, mask=m)
    return buf.getvalue()


def _serve_views(views, wrappers, service=None, ckpt=None, cam=None, concurrent=True):
    """Serve a map on port 0 in a thread: ``serve(ckpt, cam)`` itself (the
    index built from the checkpoint, the warmup, then the socket), or a
    given ``service`` through ``warmup`` and ``make_server``. Then /healthz,
    each view POSTed once (answers against ``service.query``), and with
    ``concurrent`` 4 client threads x 3 requests (answers against the
    sequential ones). Returns stats, K2's launches when the socket bound
    among them; the server is shut down."""
    import statistics
    import threading

    from fastmatch_tpu_torch.pipeline.serve import make_server, serve

    _reset_launches(wrappers)
    t0 = time.perf_counter()
    if ckpt is None:
        service.warmup()
        st = dict(k2_launches_before_bind=wrappers["distance_topk"].launches)
        httpd = make_server(service, port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
    else:
        ready, bound = threading.Event(), {}

        def on_bind(server):
            bound.update(server=server, k2=wrappers["distance_topk"].launches)

        thread = threading.Thread(target=serve, args=(ckpt, cam), daemon=True, kwargs=dict(
            port=0, ready_event=ready, device=DEV, on_bind=on_bind))
        thread.start()
        if not ready.wait(timeout=600):
            raise AssertionError("serve() did not bind within 600 s")
        httpd = bound["server"]
        service = httpd.service
        st = dict(k2_launches_before_bind=bound["k2"])
    st["start_seconds"] = time.perf_counter() - t0
    try:
        direct = [service.query(*v) for v in views]
        st["healthz"], _ = _http(httpd.server_port, "/healthz")
        answers, ms = [], []
        for v in views:
            a, t = _http(httpd.server_port, "/localize", _npz_body(*v))
            answers.append(a)
            ms.append(t)
        st["http_equals_direct"] = all(a["R"] == d["R"] and a["t"] == d["t"]
                                       and a["ok"] == d["ok"] for a, d in zip(answers, direct))
        st["request_ms_median"], st["request_ms_max"] = statistics.median(ms), max(ms)
        st["service_ms_median"] = statistics.median(a["ms"] for a in answers)
        st["answered"] = len(answers)
        if concurrent:
            got, errors = {}, []

            def client(c):
                for r in range(3):
                    k = (3 * c + r) % len(views)
                    try:
                        got[(c, r)] = (k, _http(httpd.server_port, "/localize",
                                                _npz_body(*views[k]))[0])
                    except Exception as e:  # noqa: BLE001 (recorded, then gated)
                        errors.append(repr(e))

            threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            st["concurrent_errors"] = errors
            st["concurrent_equal_sequential"] = (len(got) == 12 and not errors and all(
                a["R"] == direct[k]["R"] and a["t"] == direct[k]["t"] for k, a in got.values()))
        st["queries_served"] = _http(httpd.server_port, "/healthz")[0]["queries_served"]
    finally:
        httpd.shutdown()
        if ckpt is None:
            httpd.server_close()
        thread.join(timeout=60)
    st["answers"] = answers
    return st


def _city(rec, views_feats, scene_h, align, cam, wrappers):
    """BASELINE.json config 5's retrieval leg over the 120-frame map planted
    in a 4,000,000-row city bank; IVF parity at 262,144 rows."""
    import statistics

    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.containers import Descriptors
    from fastmatch_tpu_torch.matching.ann import build_index_sorted, match_pair_ann_big
    from fastmatch_tpu_torch.matching.matcher import match_pair
    from fastmatch_tpu_torch.pipeline.localize import (build_map_index, default_n_clusters,
                                                       localize, match_to_map)
    from fastmatch_tpu_torch.pipeline.serve import LocalizeService

    dev = torch.device(DEV)
    st = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(CITY["seed"])
    bank, _, _, _ = make_city(CITY["n_kf"], CITY["per_kf"], rng)
    M = bank.shape[0]
    r = rng.uniform(*CITY["radius"], M)
    u = rng.standard_normal((M, 3))
    pts = (u / np.linalg.norm(u, axis=1, keepdims=True) * r[:, None]).astype(np.float32)
    live = np.flatnonzero(rec.pt_mask)
    rows = rng.choice(M, live.size, replace=False)
    bank[rows] = rec.pt_desc[live]
    pts[rows] = rec.points[live]
    st["generate_seconds"] = time.perf_counter() - t0
    bank_t, pts_t = torch.from_numpy(bank).to(dev), torch.from_numpy(pts).to(dev)
    mask_t = torch.ones(M, dtype=torch.bool, device=dev)
    del bank, pts
    st.update(rows=M, planted=int(live.size), n_clusters=default_n_clusters(M))

    builds = []
    for _ in range(2):
        _reset_launches(wrappers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index = build_map_index(pts_t, bank_t, mask_t, device=DEV)
        torch.cuda.synchronize()
        builds.append((index, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
                       _read_launches(wrappers)))
    (ia, sa, pa, la), (ib, sb, pb, _) = builds
    fields = [(x.data, y.data) if isinstance(x, Descriptors) else (x, y)
              for x, y in zip(ia.ivf, ib.ivf)]
    st.update(index_build_seconds=[sa, sb], index_peak_bytes=max(pa, pb),
              index_builds_bit_identical=all(bool(torch.equal(x, y)) for x, y in fields),
              index_build_launches=la,
              largest_cluster=int((ia.ivf.starts[1:] - ia.ivf.starts[:-1]).max()))
    del ib, builds
    exact = build_map_index(pts_t, bank_t, mask_t, ann_threshold=M + 1, device=DEV)
    routes = {}
    for name, index in (("ivf", ia), ("exact", exact)):
        _reset_launches(wrappers)
        oks, good, ms, matches = 0, 0, [], []
        for k, (xy, d, m) in enumerate(views_feats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = localize(index, xy, d, m, cam)
            ok = bool(res.ok)
            ms.append(1e3 * (time.perf_counter() - t0))
            oks += ok
            if ok:
                good += _within(_view_errors(align, res.R.cpu().numpy(), res.t.cpu().numpy(),
                                             scene_h.R[k], scene_h.t[k]))
            matches.append(match_to_map(index, d, m))
        routes[name] = dict(localized=oks, within_gates=good, ms_median=statistics.median(ms),
                            ms_max=max(ms), launches=_read_launches(wrappers))
        routes[name]["_m"] = matches
    agree = [shortlist_agreement(e, i) for e, i in zip(routes["exact"].pop("_m"),
                                                       routes["ivf"].pop("_m"))]
    st["routes"] = routes
    st["route_agreement"] = [a for a, _ in agree]
    st["route_co_valid"] = [n for _, n in agree]
    log("map_services city routes", json.dumps(st))

    service = LocalizeService(ia, cam)
    st["served"] = _serve_views(views_feats[:CITY_SERVED], wrappers, service=service,
                                concurrent=False)
    st["served"].pop("answers")
    log("map_services city serve", json.dumps(st["served"]))

    # K2 at the city's exact shape: 2048 queries x 4,000,000 rows.
    xy, d, m = views_feats[0]
    st["k2_city_exact"] = _k2_at("city_exact", torch.from_numpy(d).to(dev),
                                 bank_t, torch.from_numpy(m).to(dev), mask_t,
                                 product_slab=250_000, time_plain=True)
    # K4 at k-means' cluster-sum shape, with the index's final assignment.
    st["k4_kmeans"] = _k4_kmeans_shape(ia.ivf.desc.data, ia.ivf.assign.long().clamp(
        max=st["n_clusters"] - 1), st["n_clusters"])
    del ia, exact, index, service, bank_t, pts_t
    torch.cuda.empty_cache()

    # IVF parity at 262,144 rows against the JAX package's figure.
    p = CITY_PARITY
    pbank, q, qmask, _ = make_city(p["n_kf"], p["per_kf"], np.random.default_rng(p["seed"]))
    pb = Descriptors(torch.from_numpy(pbank).to(dev),
                     torch.ones(pbank.shape[0], dtype=torch.bool, device=dev))
    qd = Descriptors(torch.from_numpy(q).to(dev), torch.from_numpy(qmask).to(dev))
    k = default_n_clusters(pbank.shape[0])
    idx = build_index_sorted(pb, k, generator=torch.Generator(dev).manual_seed(0))
    ex = match_pair(qd, pb, device=DEV)
    iv = match_pair_ann_big(qd, idx, budget=p["budget"], n_probe=p["n_probe"], device=DEV)
    a, n = shortlist_agreement(ex, iv)
    st["ivf_parity"] = dict(rows=int(pbank.shape[0]), n_clusters=k, agreement=a, co_valid=n,
                            exact_valid=int(ex.valid.sum()), ivf_valid=int(iv.valid.sum()),
                            jax_cpu=JAX_CITY, tol=IVF_PARITY_TOL,
                            exact_ms=cuda_ms(lambda: match_pair(qd, pb, device=DEV),
                                             batches=3, reps=5),
                            ivf_ms=cuda_ms(lambda: match_pair_ann_big(
                                qd, idx, budget=p["budget"], n_probe=p["n_probe"], device=DEV),
                                batches=3, reps=5))
    log("map_services ivf parity", json.dumps(st["ivf_parity"]))
    # K2 at the IVF compact bank's shape (2048 x budget) on its real rows.
    sizes = (idx.starts[1:] - idx.starts[:-1])
    st["k2_ivf_compact"] = _k2_at("ivf_compact", qd.data, pb.data[:p["budget"]], qd.mask,
                                  pb.mask[:p["budget"]], time_plain=True)
    st["k2_ivf_compact"]["largest_cluster"] = int(sizes.max())
    return st


def map_services(map120, feats56):
    """The life of a saved map on the card, at config 4's widths over the
    120-frame ``slam_device`` map of ``config4_device_slam``:

    - checkpoints: ``save_map``/``restore_map`` every array equal, a
      mismatched config raising under ``strict_config=True``, and the
      56-frame ``slam_device`` run saved by ``save_track_state`` after frame
      id RESUME_SNAPSHOT_FID and resumed from it bit-identical;
    - 12 held-out views (midpoints of the orbit, rendered, SIFT on the card)
      through ``localize`` (exact route: K2): at least LOCATE_MIN_OK within
      LOCATE_ROT_DEG and LOCATE_CENTER after the map's ATE alignment (the
      rotation error after ``R_orient``, the keyframes' own orientation
      alignment, is recorded beside it: the ATE alignment's rotation is fit
      to centres on a near-planar arc);
    - ``serve`` on the saved map, port 0, in a thread: K2 launched by the
      warmup before the socket opens, /healthz, the 12 views' answers
      equal to the direct ones (R and t bitwise), 4 client threads x 3
      requests equal to the sequential answers, ms per request;
    - ``locate --retrieval 4`` through the CLI on the saved map: at least as
      many views within the gates as the flat route, minus one;
    - ``merge_maps(refine=True)`` of two ``slam_device`` sessions (frames
      0-69 and 50-119, B moved by MERGE_SIM3): the recovered scale within
      MERGE_SCALE_TOL of the one the sessions' own alignments to ground
      truth imply, ``align_rmse`` < MERGE_RMSE scene units, K2, K4 and K5
      launched;
    - the city (``_city``): the map planted in a 4,000,000-row bank, the
      default IVF index (2048 clusters) built twice bit-identical under
      CITY_PEAK_BYTES, the views through both routes, 4 of them served
      from the IVF index, and the IVF agreement at 262,144 rows within
      IVF_PARITY_TOL of the JAX package's (JAX_CITY).

    Returns (launches summed over the phase's paths, stats)."""
    import shutil

    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu_torch.pipeline.georegister import apply_sim3
    from fastmatch_tpu_torch.pipeline.localize import build_map_index, localize
    from fastmatch_tpu_torch.pipeline.merge import merge_maps
    from fastmatch_tpu_torch.pipeline.reconstruct import detect_features
    from fastmatch_tpu_torch.pipeline.slam import SlamConfig
    from fastmatch_tpu_torch.pipeline.slam_device import slam_device

    wrappers = _kernel_wrappers()
    scene120, feats120, out120 = map120["scene"], map120["feats"], map120["out"]
    rec = out120.rec
    cam = Pinhole.from_K(scene120.K)
    tmp = os.path.join(ROOT, "chiprun_out", "map_services_tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    stats, launches, fails = {}, {k: 0 for k in wrappers}, []
    secs = {}

    def add(la):
        for k, v in la.items():
            launches[k] += v

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        return out

    try:
        _reset_launches(wrappers)
        stats["checkpoints"] = ck = timed("checkpoints", _checkpoints, rec, cam, feats56, tmp)
        add(_read_launches(wrappers))
        if not (ck["roundtrip_equal"] and ck["mismatch_raises"] and ck["resume_bit_identical"]):
            fails.append(f"checkpoints: {ck}")

        # Held-out views through localize (exact route).
        t0 = time.perf_counter()
        scene_h, views_h = render_held_out_views()
        _reset_launches(wrappers)
        feats_h = detect_features(views_h, PipelineConfig(), DEV)
        la = _read_launches(wrappers)
        add(la)
        secs["render_and_sift"] = time.perf_counter() - t0
        align = _map_alignment(rec, out120.frame_seq, scene120)
        index = build_map_index(rec.points, rec.pt_desc, rec.pt_mask, device=DEV)
        _reset_launches(wrappers)
        t0 = time.perf_counter()
        flat = []
        for k, (xy, d, m) in enumerate(feats_h):
            r = localize(index, xy, d, m, cam)
            ok = bool(r.ok)
            e = (_view_errors(align, r.R.cpu().numpy(), r.t.cpu().numpy(), scene_h.R[k],
                              scene_h.t[k]) if ok else None)
            flat.append(dict(view=HELD_OUT_KEYFRAMES[k], ok=ok, n_matches=int(r.n_matches),
                             n_inliers=int(r.n_inliers), errors=e, within=_within(e)))
        secs["locate"] = time.perf_counter() - t0
        la = _read_launches(wrappers)
        add(la)
        n_flat = sum(v["within"] for v in flat)
        stats["locate"] = dict(index="ivf" if index.ivf is not None else "exact",
                               bank_rows=int(index.bank.data.shape[0]),
                               map_alignment={k: v for k, v in align.items()
                                              if k in ("s", "keyframe_rot_err_median",
                                                       "keyframe_rot_err_orient_median")},
                               views=flat, within_gates=n_flat, launches=la)
        log("map_services locate", json.dumps(stats["locate"]))
        if n_flat < LOCATE_MIN_OK:
            fails.append(f"locate: {n_flat}/12 views within {LOCATE_ROT_DEG} deg and "
                         f"{LOCATE_CENTER}")
        if la["distance_topk"] < len(feats_h):
            fails.append(f"locate: K2 launches {la['distance_topk']}")

        # The service over the same index.
        views_q = [tuple(np.asarray(x) for x in f) for f in feats_h]
        t0 = time.perf_counter()
        sv = _serve_views(views_q, wrappers, ckpt=os.path.join(tmp, "map120"), cam=cam)
        secs["serve"] = time.perf_counter() - t0
        add(_read_launches(wrappers))
        sv.pop("answers")
        stats["serve"] = sv
        log("map_services serve", json.dumps(sv))
        if not (sv["k2_launches_before_bind"] > 0 and sv["http_equals_direct"]
                and sv["concurrent_equal_sequential"] and sv["healthz"]["index"] == "exact"):
            fails.append(f"serve: {sv}")

        # locate --retrieval 4 through the CLI on the saved map.
        t0 = time.perf_counter()
        npz = os.path.join(tmp, "views.npz")
        data = {"n_frames": len(feats_h), "image_size": np.array(CONFIG4_SCENE["image_size"])}
        for i, (xy, d, m) in enumerate(feats_h):
            data[f"xy_{i}"], data[f"desc_{i}"], data[f"mask_{i}"] = xy, d, m
        np.savez(npz, **data)
        _reset_launches(wrappers)
        lines, _ = _cli(["locate", os.path.join(tmp, "map120"), npz, "--focal",
                         str(float(scene120.K[0, 0])), "--retrieval", "4"])
        la = _read_launches(wrappers)
        add(la)
        hier = []
        for v in lines[:-1]:
            k = v["frame"]
            e = (_view_errors(align, v["R"], v["t"], scene_h.R[k], scene_h.t[k])
                 if v["ok"] else None)
            hier.append(dict(view=HELD_OUT_KEYFRAMES[k], ok=v["ok"], n_matches=v["n_matches"],
                             errors=e, within=_within(e)))
        n_hier = sum(v["within"] for v in hier)
        secs["hierarchical"] = time.perf_counter() - t0
        stats["hierarchical"] = dict(summary=lines[-1], views=hier, within_gates=n_hier,
                                     launches=la)
        log("map_services hierarchical", json.dumps(stats["hierarchical"]))
        if n_hier < n_flat - 1 or la["distance_topk"] <= 0:
            fails.append(f"hierarchical: {n_hier} within the gates against {n_flat} flat")

        # Merge two sessions.
        t0 = time.perf_counter()
        cfgm = PipelineConfig(map=MapConfig(max_frames=128))
        sessions = [slam_device(feats120[a:b], cam, cfgm, SlamConfig(), device=DEV)
                    for a, b in MERGE_SESSIONS]
        aligns = [_map_alignment(o.rec, [MERGE_SESSIONS[i][0] + f for f in o.frame_seq],
                                 scene120) for i, o in enumerate(sessions)]
        ms = MERGE_SIM3
        th = np.radians(ms["yaw_deg"])
        R0 = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        rec_b = sessions[1].rec
        apply_sim3(rec_b, ms["scale"], R0, np.array(ms["t"]))
        secs["merge_sessions"] = time.perf_counter() - t0
        _reset_launches(wrappers)
        t0 = time.perf_counter()
        merged, info = merge_maps(sessions[0].rec, rec_b, refine=True)
        secs["merge"] = time.perf_counter() - t0
        la = _read_launches(wrappers)
        add(la)
        want = aligns[1]["s"] / (aligns[0]["s"] * ms["scale"])
        info.update(expected_scale=want, scale_rel_err=abs(info["scale"] / want - 1),
                    align_rmse_scene=info["align_rmse"] * aligns[0]["s"],
                    session_scales=[a["s"] for a in aligns], n_frames=merged.n_frames,
                    n_points=merged.n_points, launches=la)
        stats["merge"] = info
        log("map_services merge", json.dumps(info))
        if not (info["scale_rel_err"] < MERGE_SCALE_TOL
                and info["align_rmse_scene"] < MERGE_RMSE):
            fails.append(f"merge: scale {info['scale']} against {want}, align_rmse "
                         f"{info['align_rmse_scene']} scene units")
        fails += [f"merge: {k} not launched" for k in
                  ("distance_topk", "sorted_segment_sum", "sorted_gather_rows") if la[k] <= 0]
        # K2 at merge's bank-by-bank shape, on the merge's own banks.
        from fastmatch_tpu_torch.pipeline.serve import _bucket

        rec_a = sessions[0].rec
        pad = [(np.zeros((_bucket(r.pt_desc.shape[0]), 128), np.float32),
                np.zeros(_bucket(r.pt_desc.shape[0]), bool)) for r in (rec_b, rec_a)]
        for (pd_, pm_), r in zip(pad, (rec_b, rec_a)):
            pd_[:r.pt_desc.shape[0]], pm_[:r.pt_mask.shape[0]] = r.pt_desc, r.pt_mask
        dv = torch.device(DEV)
        stats["k2_merge"] = _k2_at("merge_bank_by_bank", torch.from_numpy(pad[0][0]).to(dv),
                                   torch.from_numpy(pad[1][0]).to(dv),
                                   torch.from_numpy(pad[0][1]).to(dv),
                                   torch.from_numpy(pad[1][1]).to(dv), time_plain=True)
        del sessions, merged

        # The city.
        t0 = time.perf_counter()
        stats["city"] = city = _city(rec, views_q, scene_h, align, cam, wrappers)
        secs["city"] = time.perf_counter() - t0
        for part in ("index_build_launches",):
            add(city[part])
        for r in city["routes"].values():
            add(r["launches"])
        if not city["index_builds_bit_identical"] or city["index_peak_bytes"] >= CITY_PEAK_BYTES:
            fails.append(f"city index: bit-identical {city['index_builds_bit_identical']}, "
                         f"peak {city['index_peak_bytes']} bytes")
        if city["served"]["answered"] != CITY_SERVED or city["served"]["healthz"]["index"] != "ivf":
            fails.append(f"city serve: {city['served']}")
        par = city["ivf_parity"]
        if not abs(par["agreement"] - JAX_CITY["agreement"]) <= IVF_PARITY_TOL:
            fails.append(f"IVF parity: {par['agreement']} against the JAX package's {JAX_CITY}")
        for name in ("k2_city_exact", "k2_merge"):
            k2d = city.get(name) or stats.get(name)
            if not (k2d["idx1_equal"] and k2d["nnb_equal"]):
                fails.append(f"{name}: K2 differs from its plain version")
        if not (city["k4_kmeans"]["bit_identical_rerun"]
                and city["k4_kmeans"]["max_rel_err"] < 1e-5):
            fails.append(f"K4 at the k-means shape: {city['k4_kmeans']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stats["seconds"] = secs
    stats["launches"] = launches
    log("map_services seconds", json.dumps(secs))
    if fails:
        raise AssertionError(f"map services: {fails}")
    return launches, stats


# The JAX package's figures on the smoke scene, on a CPU
# (tools/jax_global_reference.py --seed S): global_reconstruct(images=...)
# at window 8 with the default PipelineConfig, its ATE over RANSAC seeds 0-2
# and seed 0's counts, and self_calibrate (3 rounds, fx and fy free) of the
# ground-truth map seen through fx, fy x 1.06. The JAX package's own global
# SfM does not reach ATE_GATE on this scene (the window-8 view graph of a
# 1.2-radian arc constrains scale weakly along the chain), so the port's
# ATE is held to the JAX package's largest over the seeds, as
# config4_device_slam holds the SLAM engines.
JAX_GLOBAL = dict(
    ate_seeds={0: 1.1986212730407715, 1: 1.3639470338821411,
               2: 1.0967719554901123},
    seed0=dict(frames=50, edges=308, tracks=5812, n_obs=15673,
               ba_cost0=0.07578925788402557, ba_cost=0.009515617974102497),
    selfcal=dict(vec=[500.0, 500.0, 320.0, 240.0, 0.0, 0.0, 0.0, 0.0, 0.0], fx_err0=30.0,
                 fx_err=0.0, history=[[2.0930907007610244e-10, 7.81445741449005e-12],
                                      [2.079520028397397e-10, 7.81445741449005e-12],
                                      [2.079520028397397e-10, 7.81445741449005e-12]]))
GLOBAL_WINDOW = 8
GLOBAL_ATE_MARGIN = 1.15   # the port's ATE at most this times the JAX package's largest
SELFCAL_RTOL = 1e-3        # refined vector against the JAX package's
SELFCAL_CUT = 3.0          # the fx error cut by more than this
SLAM_PLOT_FRAMES = 12      # frames of the ``slam --plot`` CLI run


def _selfcal_reconstruction(scene):
    """(Reconstruction, wrong camera, config, true (9,)) of
    ``selfcal_inputs``: the smoke scene's true map holding observations
    normalized with the wrong camera, on DEV."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction

    R, t, X, obs_f, obs_p, obs_uv, true, wrong = selfcal_inputs(scene)
    cam, cfg = Pinhole(*wrong), PipelineConfig()
    rec = Reconstruction(cfg=cfg, camera=cam, device=torch.device(DEV))
    F = R.shape[0]
    rec.R[:F], rec.t[:F], rec.pose_mask[:F], rec.n_frames = R, t, True, F
    rec.add_points(X, np.zeros((X.shape[0], cfg.map.desc_dim), np.float32))
    for f in range(F):
        sel = obs_f == f
        rec.add_observations(f, obs_p[sel], obs_uv[sel])
    return rec, cam, cfg, true


def _averaging_k4(g, keys):
    """K4 at the averaging's key-set shapes, (2E, 3) and (2E, 1) rows into
    F frames: against a float64 sum on the host (the largest error relative
    to the largest sum), a rerun bit for bit, wrapper ms, device us,
    ``segment_sum_plain`` and ``torch.segment_reduce`` (the library time)."""
    import torch

    from fastmatch_tpu_torch.kernels import segment_ops as k4

    gen = torch.Generator(DEV).manual_seed(11)
    out = {}
    for d in (3, 1):
        rows = keys.seg.shape[0]
        vals = torch.randn((rows, d), generator=gen, device=DEV).contiguous()
        call = lambda: k4.sorted_segment_sum(vals, keys.seg, keys.n, keys.offsets,  # noqa: E731
                                             keys.max_len)
        got = call()
        ref = torch.zeros((keys.n, d), dtype=torch.float64).index_add_(
            0, keys.seg.long().cpu(), vals.double().cpu())
        lengths = k4.segment_lengths(keys.offsets)
        e = dict(rows=rows, cols=d, segments=keys.n, longest_segment=keys.max_len,
                 edges=int(g.edge_i.shape[0]),
                 max_rel_err=float((got.double().cpu() - ref).abs().max()
                                   / ref.abs().max()),
                 bit_identical_rerun=bool(torch.equal(call(), got)),
                 ms=cuda_ms(call, batches=5, reps=HOST_REPS),
                 plain_ms=cuda_ms(lambda: k4.segment_sum_plain(vals, keys.seg, keys.n),
                                  batches=5, reps=HOST_REPS),
                 library_ms=cuda_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths),
                                    batches=5, reps=HOST_REPS))
        e.update(_device_time(call, {"segsum_short", "segsum_long"}, 1, 200))
        e["bound_ms"], e["bound_by"] = bound(4 * (vals.numel() + keys.n + 1 + keys.n * d),
                                             float(vals.numel()))
        out[f"{rows}x{d}"] = e
    return out


def global_sfm_selfcal(scene, views):
    """Global SfM and self-calibration at config 3's widths on the 50 smoke
    frames: ``global_reconstruct(images=...)`` twice (window 8, default
    PipelineConfig), ``self_calibrate`` of the scene's true map seen through
    fx, fy x 1.06 (3 rounds, fx and fy free), ``reconstruct --mode global
    --selfcal 2`` and ``slam --plot`` through the CLI. Each run has the
    launch counts set to 0 just before and read just after; the global runs
    count host synchronizations, and those inside ``rotation_averaging`` and
    ``translation_averaging`` apart. Gates: 50/50 frames, ATE at most
    GLOBAL_ATE_MARGIN x the JAX package's largest over seeds 0-2, the two runs
    bit-identical, no sync inside the averaging, K3 one launch a frame, K2
    at least one a view-graph pair attempted, K4 and K5 launched, K1 not,
    K4 at the averaging's key-set shapes against a float64 sum, the
    calibration's fx error cut by more than SELFCAL_CUT and its vector
    within SELFCAL_RTOL of the JAX package's, and ``slam --plot`` writing a
    PNG or naming the missing matplotlib."""
    import tempfile
    import warnings

    import numpy as np
    import torch

    from fastmatch_tpu_torch.ba.calibrate import param_indices, self_calibrate
    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.pipeline import global_sfm as gs
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import detect_features
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    wrappers = _kernel_wrappers()
    cam = Pinhole.from_K(scene.K)
    F = len(views)
    gt = -np.einsum("fji,fj->fi", scene.R[:F], scene.t[:F])
    pairs = sum(min(GLOBAL_WINDOW, F - 1 - i) for i in range(F))
    stats = dict(window=GLOBAL_WINDOW, pairs_attempted=pairs, jax_cpu=JAX_GLOBAL, runs={})
    fails = []
    captured = {}

    def run_global(name):
        caught = []
        inside = dict(rotation_averaging=0, translation_averaging=0)
        k4_inside = dict(inside)
        k4 = wrappers["sorted_segment_sum"]

        def watched(fn_name):
            fn = getattr(gs, fn_name)

            def call(g, *a, **kw):
                n0, l0 = len(caught), k4.launches
                out = fn(g, *a, **kw)
                inside[fn_name] += sum("synchroniz" in str(w.message) for w in caught[n0:])
                k4_inside[fn_name] += k4.launches - l0
                captured[fn_name] = (g, kw["keys"])
                return out
            return fn, call

        originals = {}
        for fn_name in inside:
            originals[fn_name], patched = watched(fn_name)
            setattr(gs, fn_name, patched)
        _reset_launches(wrappers)
        torch.cuda.reset_peak_memory_stats()
        try:
            with warnings.catch_warnings(record=True) as caught_list:
                warnings.simplefilter("always")
                caught = caught_list
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    rec = gs.global_reconstruct(None, cam, PipelineConfig(), images=views,
                                                window=GLOBAL_WINDOW, device=DEV)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            for fn_name, fn in originals.items():
                setattr(gs, fn_name, fn)
        launches = _read_launches(wrappers)
        centers = rec.camera_centers()
        st = rec.frame_stats[-1]
        stats["runs"][name] = dict(
            frames=F, frames_reconstructed=rec.n_frames, seconds=wall,
            stage_seconds=rec.stage_seconds, ate=float(ate_rmse(centers, gt[:rec.n_frames])),
            edges=st["edges"], tracks=st["tracks"], n_points=int(rec.n_points),
            n_obs=int(rec.n_obs), ba_cost0=st["ba_cost0"], ba_cost=st["ba_cost"],
            host_syncs=sum("synchroniz" in str(w.message) for w in caught),
            syncs_inside=inside, k4_launches_inside=k4_inside,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            launches=launches, finite=bool(np.isfinite(centers).all()
                                           and np.isfinite(rec.points[rec.pt_mask]).all()))
        log(f"global_sfm_selfcal {name}", json.dumps(stats["runs"][name]))
        return rec, launches

    rec_a, launches = run_global("global_reconstruct")
    rec_b, _ = run_global("global_reconstruct_rerun")
    ra = stats["runs"]["global_reconstruct"]
    stats["bit_identical"] = all(np.array_equal(getattr(rec_a, k), getattr(rec_b, k)) for k in (
        "R", "t", "points", "obs_cam", "obs_pt", "obs_uv", "obs_mask"))
    ate_limit = GLOBAL_ATE_MARGIN * max(JAX_GLOBAL["ate_seeds"].values())
    stats["ate_limit"] = ate_limit
    if ra["frames_reconstructed"] != F or not ra["finite"]:
        fails.append(f"global: {ra['frames_reconstructed']}/{F} frames, or non-finite output")
    if not ra["ate"] <= ate_limit:
        fails.append(f"global ATE {ra['ate']} above {ate_limit} (the JAX package's largest "
                     f"over seeds x {GLOBAL_ATE_MARGIN})")
    if not stats["bit_identical"]:
        fails.append("global: the two runs differ")
    for run in stats["runs"].values():
        if any(run["syncs_inside"].values()):
            fails.append(f"global: host syncs inside the averaging {run['syncs_inside']}")
    if (launches["gather_patch_sets"] != F or launches["gather_patches"]
            or launches["distance_topk"] < pairs or launches["sorted_segment_sum"] <= 0
            or launches["sorted_gather_rows"] <= 0 or launches["batch_match"]):
        fails.append(f"global: launches {launches} (want K3 {F}, K2 >= {pairs}, K4 and K5 "
                     "> 0, K1 0)")
    stats["k4_averaging"] = _averaging_k4(*captured["translation_averaging"])
    for shape, e in stats["k4_averaging"].items():
        log(f"global_sfm_selfcal K4 {shape}", json.dumps(e))
        if not (e["max_rel_err"] < 1e-5 and e["bit_identical_rerun"]):
            fails.append(f"K4 at the averaging's shape {shape}: {e}")

    # Self-calibration of the true map seen through the wrong focal.
    rec, wrong, cfg, true = _selfcal_reconstruction(scene)
    _reset_launches(wrappers)
    t0 = time.perf_counter()
    cam2, hist = self_calibrate(rec, wrong, cfg, rounds=SELFCAL_ROUNDS,
                                free=param_indices("pinhole", ("fx", "fy")))
    torch.cuda.synchronize()
    vec = np.asarray(cam2.intrinsics_vector(), np.float64)
    jvec = np.asarray(JAX_GLOBAL["selfcal"]["vec"])
    sc = dict(seconds=time.perf_counter() - t0, vec=vec.tolist(), jax_vec=jvec.tolist(),
              history=[list(h) for h in hist], n_obs=rec.n_obs,
              fx_err0=abs(wrong.fx - float(true[0])), fx_err=abs(vec[0] - float(true[0])),
              launches=_read_launches(wrappers))
    stats["self_calibrate"] = sc
    log("global_sfm_selfcal self_calibrate", json.dumps(sc))
    if not sc["fx_err"] < sc["fx_err0"] / SELFCAL_CUT:
        fails.append(f"self_calibrate: fx error {sc['fx_err']} from {sc['fx_err0']}")
    if not np.allclose(vec, jvec, rtol=SELFCAL_RTOL, atol=1e-6):
        fails.append(f"self_calibrate: {vec} against the JAX package's {jvec}")
    if sc["launches"]["sorted_segment_sum"] <= 0 or sc["launches"]["sorted_gather_rows"] <= 0:
        fails.append(f"self_calibrate: launches {sc['launches']}")

    # The CLI: reconstruct --mode global --selfcal 2, slam --plot.
    cfg = PipelineConfig()
    feats = detect_features(views, cfg, DEV)
    with tempfile.TemporaryDirectory() as tmp:
        def npz(n):
            arrays = {"n_frames": n, "image_size": np.array(views[0].shape[::-1])}
            for i, (xy, d, m) in enumerate(feats[:n]):
                arrays.update({f"xy_{i}": xy, f"desc_{i}": d, f"mask_{i}": m})
            path = os.path.join(tmp, f"features{n}.npz")
            np.savez(path, **arrays)
            return path

        _reset_launches(wrappers)
        reports, secs = _cli(["reconstruct", npz(F), "--mode", "global", "--window",
                              str(GLOBAL_WINDOW), "--selfcal", "2",
                              "--out", os.path.join(tmp, "rec.npz")])
        rep = reports[-1]
        centers = np.load(os.path.join(tmp, "rec.npz"))["centers"]
        stats["cli_reconstruct"] = dict(report=rep, seconds=secs,
                                        launches=_read_launches(wrappers),
                                        ate=float(ate_rmse(centers, gt[:len(centers)])))
        log("global_sfm_selfcal cli", json.dumps(stats["cli_reconstruct"]))
        if (rep.get("n_frames") != F or set(rep.get("selfcal", {})) != {
                "fx", "fy", "cx", "cy", "dist", "mean_px2"}
                or not stats["cli_reconstruct"]["ate"] <= ate_limit):
            fails.append(f"cli reconstruct --mode global --selfcal 2: {rep}")
        png = os.path.join(tmp, "traj.png")
        try:
            reports, secs = _cli(["slam", npz(min(SLAM_PLOT_FRAMES, F)), "--plot", png])
            plot = dict(outcome="png", bytes=os.path.getsize(png), seconds=secs,
                        report=reports[-1])
            if plot["bytes"] < 2000:
                fails.append(f"slam --plot wrote {plot['bytes']} bytes")
        except ImportError as e:
            plot = dict(outcome="ImportError", message=str(e))
            if "matplotlib" not in str(e):
                fails.append(f"slam --plot: {e}")
        stats["slam_plot"] = plot
        log("global_sfm_selfcal slam --plot", json.dumps(plot))
    if fails:
        raise AssertionError("global_sfm_selfcal: " + "; ".join(fails))
    return launches, stats


# -- phase 12: the distributed engine at world size 1 ------------------------------

# (a) the ring: 2048 queries against a 262,144 x 128 bank (its first
# DIST_BANK_LIVE rows live), whole through ``match_pair_sharded`` and as
# the ring steps of 4 and 8 slabs, from each owner in turn.
DIST_QUERIES = 2048
DIST_BANK = 262_144
DIST_BANK_LIVE = 250_000
DIST_SLABS = (4, 8)
# (b) and (c): rtol of the partitioned solve's cost against ``ba_solve``'s;
# camera centres against ``slam_device``'s; landmarks the run must hold.
DIST_PARTITION_RTOL = 1e-4
DIST_K2_ATOL = 1e-5          # K2 raw distances against distance_topk_plain
DIST_CENTER_TOL = 5e-2
DIST_MIN_LANDMARKS = 50
DIST_SNAPSHOT_FID = 28
# (e) VLAD-sized +-1 rows: every score an exact integer.
DIST_VLAD = dict(queries=16, rows=8192, dim=4096, topk=5, slabs=4)
# (f) the watchdog: its timeout, and the GPU cycles the stream sleeps.
WATCHDOG_TIMEOUT_S = 0.5
WATCHDOG_SLEEP_CYCLES = 4_000_000_000


def dist_paths(rec, scene56, feats56):
    """The distributed engine (``fastmatch_tpu_torch.dist``) on one H100 at
    world size 1 over NCCL, through ``initialize_distributed()`` with none
    of its variables set: the same code as on many ranks, with every
    collective a one-rank NCCL call. Each run has the kernels' launch
    counts set to 0 just before and read just after. Runs and gates:

    (a) ``match_pair_sharded``, 2048 queries against a 262,144 x 128 bank,
        at the defaults and as the SLAM retrieval calls it (ratio 1, no
        cross-check: every live query valid): decisions, idx and dist
        equal to the unsharded K2 route (``match_pair_fused``), one K2
        launch a call; then ``ring_step`` over 4
        and 8 slabs of the bank from each owner in turn, the slabs'
        ``nnb`` put together for the cross-check: the same Matches, K2
        launches = slabs x owners; K2 at the unsharded shape and at one
        slab of each count against its plain version (``_k2_at``: idx1 and
        nnb equal, distances within DIST_K2_ATOL), with its device time;
    (b) ``ba_solve_sharded`` on the main path's final BA problem
        (``jittered_ba_problem``, as ``grouped_ba`` takes it):
        bit-identical to ``ba_solve``; with ``partition_problem(.., 1)``
        (presorted) the cost within DIST_PARTITION_RTOL; K4 and K5
        launched;
    (c) ``slam_distributed`` on phase 7's 56-frame features (config 4's
        widths) with overlap on and snapshots, beside ``slam_device``:
        every frame tracked, the same frame sequence, camera centres
        within DIST_CENTER_TOL, more than DIST_MIN_LANDMARKS landmarks;
        resumed from the snapshot after frame id DIST_SNAPSHOT_FID:
        bit-identical; K2, K4 and K5 launched, K1 and K3 not;
    (d) ``match_batch_dp`` at config 2's size (64 x 2048, 1500 live):
        equal to ``match_batch`` (K1, exact); ``stereo_batch`` on the
        ``data`` axis' slices, gathered: bit-equal to ``stereo_batch``;
    (e) ``retrieve_sharded`` on +-1 rows: bit-equal to ``vlad.retrieve``,
        and so is the merge of 4 slabs' ``retrieve_local``;
    (f) the watchdog raises ``CollectiveTimeout`` on a stream kept busy
        past its timeout (``torch.cuda._sleep``), and passes a fast wait;
    (g) the CLI: ``slam --mesh bank=1 --no-overlap --checkpoint-interval``
        on the 56 frames' .npz: bit-identical to (c)'s overlapped run; then
        ``--resume``: bit-identical again;
    (h) ``OverlapScheduler`` (a product on the side stream, a reduction on
        the caller's) equal to the serial schedule bit for bit.

    Returns (the (c) run's launches, stats)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from fastmatch_tpu_torch.ba.lm import ba_solve
    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.core.containers import Descriptors
    from fastmatch_tpu_torch.dense.stereo import stereo_batch
    from fastmatch_tpu_torch.dist.bootstrap import initialize_distributed
    from fastmatch_tpu_torch.dist.dist_ba import ba_solve_sharded
    from fastmatch_tpu_torch.dist.mesh import batch_sharding, make_mesh
    from fastmatch_tpu_torch.dist.overlap import OverlapScheduler
    from fastmatch_tpu_torch.dist.partition import partition_problem
    from fastmatch_tpu_torch.dist.pipeline import DistConfig, slam_distributed
    from fastmatch_tpu_torch.dist.retrieve import (retrieve_local, retrieve_merge,
                                                   retrieve_sharded)
    from fastmatch_tpu_torch.dist.sharded_match import (match_batch_dp, match_pair_sharded,
                                                        ring_start, ring_step)
    from fastmatch_tpu_torch.dist.watchdog import CollectiveTimeout, Watchdog
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.matching.matcher import BIG, match_batch, ratio_sq
    from fastmatch_tpu_torch.matching.vlad import retrieve
    from fastmatch_tpu_torch.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu_torch.pipeline.slam import SlamConfig
    from fastmatch_tpu_torch.pipeline.slam_device import slam_device

    wrappers = _kernel_wrappers()
    dev = torch.device(DEV)
    fails, stats, seconds = [], {}, {}

    def counted(name, fn):
        _reset_launches(wrappers)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        la = _read_launches(wrappers)
        stats.setdefault("launches", {})[name] = la
        log(f"dist_paths {name}: {seconds[name]:.3f} s, launches {json.dumps(la)}")
        return out, la

    unset = [k for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID") if os.environ.get(k)]
    if unset:
        raise AssertionError(f"dist_paths: {unset} set; the phase runs at world size 1")
    t0 = time.perf_counter()
    status = initialize_distributed(device=DEV)
    stats["nccl_group_setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = make_mesh()
    stats["mesh_setup_s"] = time.perf_counter() - t0
    stats["status"] = dict(status, backend=dist.get_backend())
    if dist.get_backend() != "nccl" or status["process_count"] != 1:
        fails.append(f"process group {stats['status']}, want NCCL at world size 1")

    # (a) The ring.
    rng = np.random.default_rng(12)
    q, mq, bank, mb = _descriptor_sets(rng, DIST_QUERIES, DIST_BANK, DIST_BANK_LIVE,
                                       DIST_QUERIES * 3 // 4)
    da = Descriptors(torch.from_numpy(q).to(dev), torch.from_numpy(mq).to(dev))
    db = Descriptors(torch.from_numpy(bank).to(dev), torch.from_numpy(mb).to(dev))
    ref = k2.match_pair_fused(da, db)
    ref1 = k2.match_pair_fused(da, db, ratio=1.0, cross_check=False)
    (got, got1), la = counted("ring", lambda: (
        match_pair_sharded(da, db, mesh),
        match_pair_sharded(da, db, mesh, ratio=1.0, cross_check=False)))
    ring = dict(n_valid=int(ref.valid.sum()), n_valid_ratio1=int(ref1.valid.sum()),
                k2_launches=la["distance_topk"],
                equal=_decisions_equal(got, ref) and torch_all(got.dist == ref.dist),
                equal_ratio1=_decisions_equal(got1, ref1) and torch_all(got1.dist == ref1.dist))
    if not (ring["equal"] and ring["equal_ratio1"]) or la["distance_topk"] != 2:
        fails.append(f"(a) match_pair_sharded: {ring}")
    a, b = da.data, db.data
    a2m = torch.where(da.mask, (a * a).sum(-1), BIG).contiguous()
    b2m = torch.where(db.mask, (b * b).sum(-1), BIG).contiguous()
    n = a.shape[0]
    slabs_out = {}
    for slabs in DIST_SLABS:
        ms = DIST_BANK // slabs

        def run_ring(slabs=slabs, ms=ms):
            outs = []
            for start in range(slabs):
                acc, nnb = ring_start(n, dev), [None] * slabs
                for s in range(slabs):
                    owner = (start - s) % slabs
                    acc, nnb[owner] = ring_step(acc, a, a2m, b[owner * ms:(owner + 1) * ms],
                                                b2m[owner * ms:(owner + 1) * ms], owner)
                outs.append((acc, torch.cat(nnb)))
            return outs

        outs, la = counted(f"ring_steps_{slabs}", run_ring)
        same = True
        for (d1, i1, d2, _), nnb in outs:
            ok = da.mask & (d1 < ratio_sq(0.8) * d2) & (d2 < BIG)
            ok = ok & (nnb[i1.long()] == torch.arange(n, dtype=torch.int32, device=dev))
            same &= (torch_all(ok == ref.valid) and torch_all(i1[ok] == ref.idx[ok])
                     and torch_all(d1[ok] == ref.dist[ok]))
        slabs_out[slabs] = dict(equal=bool(same), k2_launches=la["distance_topk"],
                                want_launches=slabs * slabs,
                                slab_k2=_k2_at(f"ring_slab_{slabs}", a, b[:ms], da.mask,
                                               db.mask[:ms], time_plain=True))
        if not same or la["distance_topk"] != slabs * slabs:
            fails.append(f"(a) ring steps over {slabs} slabs: equal {same}, K2 launches "
                         f"{la['distance_topk']} != {slabs * slabs}")
    ring["unsharded_k2"] = _k2_at("ring_unsharded", a, b, da.mask, db.mask, time_plain=True)
    ring["slabs"] = slabs_out
    # K2 against its plain version at the ring's shapes: the ring itself is
    # held above against the same kernel, unsharded.
    for k2d in [ring["unsharded_k2"]] + [v["slab_k2"] for v in slabs_out.values()]:
        if not (k2d["idx1_equal"] and k2d["nnb_equal"]
                and k2d["max_abs_err"] <= DIST_K2_ATOL):
            fails.append(f"(a) K2 at {k2d['shape']} differs from its plain version: "
                         f"idx1 {k2d['idx1_equal']}, nnb {k2d['nnb_equal']}, "
                         f"max abs err {k2d['max_abs_err']} > {DIST_K2_ATOL}")
    stats["ring"] = ring
    log("dist_paths ring", json.dumps(ring))
    del da, db, a, b, a2m, b2m, ref, got, ref1, got1

    # (b) Sharded BA on the main path's final problem, jittered.
    cfg = rec.cfg.ba
    prob = jittered_ba_problem(rec)
    kw = dict(max_iters=cfg.max_iters, pcg_iters=cfg.pcg_iters,
              huber_delta_static=cfg.huber_px / float(rec.camera.fx))
    single = ba_solve(prob, device=DEV, **kw)
    sharded, la = counted("sharded_ba", lambda: ba_solve_sharded(prob, mesh, **kw))
    part_prob, _ = partition_problem(prob, 1)
    part = ba_solve_sharded(part_prob, mesh, presorted=True, **kw)
    same = all(torch.equal(x, y) for x, y in (
        (sharded.poses.R, single.poses.R), (sharded.poses.t, single.poses.t),
        (sharded.points, single.points), (sharded.cost, single.cost)))
    ba = dict(obs=int(prob.obs.mask.shape[0]), cost0=float(single.cost0),
              cost=float(single.cost), sharded_bit_identical=bool(same),
              partition_cost=float(part.cost), iters=single.iters,
              k4_launches=la["sorted_segment_sum"], k5_launches=la["sorted_gather_rows"])
    stats["sharded_ba"] = ba
    log("dist_paths sharded_ba", json.dumps(ba))
    if not same:
        fails.append("(b) ba_solve_sharded differs from ba_solve at world size 1")
    if not abs(ba["partition_cost"] - ba["cost"]) <= DIST_PARTITION_RTOL * abs(ba["cost"]):
        fails.append(f"(b) partitioned cost {ba['partition_cost']} vs {ba['cost']}")
    if la["sorted_segment_sum"] <= 0 or la["sorted_gather_rows"] <= 0:
        fails.append(f"(b) K4/K5 not launched: {la}")

    # (c) SLAM on the 56 frames, and (g) the CLI on their .npz.
    cfg56 = PipelineConfig(map=MapConfig(max_frames=64))
    scfg = SlamConfig()
    cam = Pinhole.from_K(scene56.K)
    N = len(feats56)

    def arrays(out):
        r = out.rec
        return dict(R=r.R[:r.n_frames], t=r.t[:r.n_frames], points=r.points[r.pt_mask],
                    centers=r.camera_centers())

    def same_arrays(x, y):
        return all(np.array_equal(x[k], y[k]) for k in ("R", "t", "points", "centers"))

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        ref_out, _ = counted("slam_device", lambda: slam_device(feats56, cam, cfg56, scfg,
                                                                device=DEV))
        over, la = counted("slam_distributed", lambda: slam_distributed(
            feats56, cam, cfg56, scfg, DistConfig(overlap=True, checkpoint_dir=ck,
                                                  checkpoint_interval=DIST_SNAPSHOT_FID),
            mesh=mesh))
        resumed, _ = counted("slam_distributed_resumed", lambda: slam_distributed(
            feats56, cam, cfg56, scfg, DistConfig(), mesh=mesh, resume_from=ck))
        centers, ref_centers = over.rec.camera_centers(), ref_out.rec.camera_centers()
        gt = -np.einsum("fji,fj->fi", scene56.R, scene56.t)[np.asarray(over.frame_seq)]
        from fastmatch_tpu_torch.utils.evaluation import ate_rmse

        slam = dict(frames=N, frames_tracked=over.rec.n_frames,
                    same_frame_seq=over.frame_seq == ref_out.frame_seq,
                    loop_edges=[[int(e[0]), int(e[1])] for e in over.loop_edges],
                    device_loop_edges=[[int(e[0]), int(e[1])] for e in ref_out.loop_edges],
                    pgo_runs=over.pgo_runs,
                    max_center_diff=float(np.abs(centers - ref_centers).max())
                    if centers.shape == ref_centers.shape else None,
                    landmarks=int(over.rec.pt_mask.sum()),
                    ate=float(ate_rmse(centers, gt)),
                    resumed_bit_identical=same_arrays(arrays(resumed), arrays(over)),
                    launches=la)
        if slam["frames_tracked"] != N or not np.isfinite(centers).all():
            fails.append(f"(c) {slam['frames_tracked']}/{N} frames tracked, or non-finite")
        if not slam["same_frame_seq"]:
            fails.append("(c) frame sequence differs from slam_device's")
        if slam["max_center_diff"] is None or not slam["max_center_diff"] <= DIST_CENTER_TOL:
            fails.append(f"(c) centres {slam['max_center_diff']} from slam_device's")
        if not slam["landmarks"] > DIST_MIN_LANDMARKS:
            fails.append(f"(c) {slam['landmarks']} landmarks")
        if not slam["resumed_bit_identical"]:
            fails.append("(c) the resumed run differs from the uninterrupted one")
        if la["batch_match"] or la["gather_patch_sets"] or la["gather_patches"]:
            fails.append(f"(c) K1 or K3 launched: {la}")
        fails += [f"(c) kernel {k} not launched" for k in
                  ("distance_topk", "sorted_segment_sum", "sorted_gather_rows") if la[k] <= 0]

        npz = os.path.join(tmp, "features.npz")
        data = {"n_frames": N, "image_size": np.array(CONFIG4_SCENE["image_size"])}
        for i, (xy, d, m) in enumerate(feats56):
            data.update({f"xy_{i}": xy, f"desc_{i}": d, f"mask_{i}": m})
        np.savez(npz, **data)
        ck2 = os.path.join(tmp, "ck2")
        base = ["--set", "map.max_frames=64", "slam", npz, "--focal", str(scene56.K[0, 0]),
                "--mesh", "bank=1"]
        serial_json, seconds["cli_slam_no_overlap"] = _cli(
            base + ["--no-overlap", "--checkpoint", ck2, "--checkpoint-interval",
                    str(DIST_SNAPSHOT_FID), "--out", os.path.join(tmp, "serial.npz")])
        resumed_json, seconds["cli_slam_resume"] = _cli(
            base + ["--resume", ck2, "--out", os.path.join(tmp, "resumed.npz")])
        serial = dict(np.load(os.path.join(tmp, "serial.npz")))
        cli_resumed = dict(np.load(os.path.join(tmp, "resumed.npz")))
        slam.update(cli_json=serial_json[-1], overlap_equals_serial=same_arrays(
            serial, arrays(over)), cli_resumed_bit_identical=same_arrays(cli_resumed, serial),
            cli_resumed_json=resumed_json[-1])
        if not slam["overlap_equals_serial"]:
            fails.append("(c, g) the serial (--no-overlap) run differs from the overlapped one")
        if not slam["cli_resumed_bit_identical"]:
            fails.append("(g) slam --resume differs from the uninterrupted CLI run")
    stats["slam"] = slam
    log("dist_paths slam", json.dumps(slam))

    # (d) Data-parallel routes.
    qs, bs = _config2_sets(rng, CONFIG2["batch"], matched=True)
    cap = CONFIG2["capacity"]

    def padded(sets):
        data = np.zeros((len(sets), cap, 128), np.float32)
        mask = np.zeros((len(sets), cap), bool)
        for i, s in enumerate(sets):
            data[i, :len(s)], mask[i, :len(s)] = s, True
        return Descriptors(torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev))

    A, B = padded(qs), padded(bs)
    ref = match_batch(A, B, device=DEV)
    got, la = counted("match_batch_dp", lambda: match_batch_dp(A, B, mesh))
    dp = dict(n_valid=int(ref.valid.sum()), decisions_equal=_decisions_equal(got, ref),
              bit_equal=torch_all(got.dist == ref.dist) and torch_all(got.idx == ref.idx),
              k1_launches=la["batch_match"])
    sh = batch_sharding(mesh)
    stats["dp"] = dp
    if not dp["decisions_equal"] or la["batch_match"] != 1:
        fails.append(f"(d) match_batch_dp: {dp}")
    del A, B, ref, got
    left, right = _stereo_inputs(dev)
    disp, valid = stereo_batch(left, right, device=DEV)

    def dp_stereo():
        d, v = stereo_batch(sh.shard(left), sh.shard(right), device=DEV)
        return sh.gather(d), sh.gather(v)

    (ddisp, dvalid), _ = counted("stereo_batch_dp", dp_stereo)
    dp["stereo_bit_equal"] = torch.equal(ddisp, disp) and torch.equal(dvalid, valid)
    dp["stereo_valid_share"] = float(valid.float().mean())
    if not dp["stereo_bit_equal"]:
        fails.append("(d) stereo_batch on the data axis differs from stereo_batch")
    log("dist_paths dp", json.dumps(dp))

    # (e) Retrieval on +-1 rows.
    v = DIST_VLAD
    g = torch.Generator(device=dev).manual_seed(12)
    qv = torch.randint(0, 2, (v["queries"], v["dim"]), generator=g, device=dev).float() * 2 - 1
    dbv = torch.randint(0, 2, (v["rows"], v["dim"]), generator=g, device=dev).float() * 2 - 1
    dbv[1::97] = dbv[0]  # repeated rows: equal scores
    dbm = torch.ones(v["rows"], dtype=torch.bool, device=dev)
    dbm[5::13] = False
    rv, rids = retrieve(qv, dbv, dbm, v["topk"])
    (sv, sids), _ = counted("retrieve_sharded", lambda: retrieve_sharded(qv, dbv, dbm, mesh,
                                                                         topk=v["topk"]))
    rows = v["rows"] // v["slabs"]
    parts = [retrieve_local(qv, dbv[i * rows:(i + 1) * rows], dbm[i * rows:(i + 1) * rows],
                            i * rows, v["topk"]) for i in range(v["slabs"])]
    mv, mids = retrieve_merge(torch.cat([p[0] for p in parts], 1),
                              torch.cat([p[1] for p in parts], 1), v["topk"])
    retr = dict(finite=torch_all(torch.isfinite(rv)),
                bit_equal=torch.equal(sv, rv) and torch.equal(sids, rids),
                slabs_bit_equal=torch.equal(mv, rv) and torch.equal(mids, rids),
                tied_scores=int(v["queries"] * v["topk"] - torch.unique(rv).numel()))
    stats["retrieve"] = retr
    log("dist_paths retrieve", json.dumps(retr))
    if not (retr["finite"] and retr["bit_equal"] and retr["slabs_bit_equal"]):
        fails.append(f"(e) retrieve_sharded: {retr}")

    # (f) The watchdog.
    x = torch.ones(4, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(WATCHDOG_SLEEP_CYCLES)
    y = x * 2
    try:
        Watchdog(WATCHDOG_TIMEOUT_S).wait(y)
        raised = False
    except CollectiveTimeout:
        raised = True
    detect_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    busy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = Watchdog(10.0).wait(x + 1)
    fast_s = time.perf_counter() - t0
    wd = dict(raised=raised, detect_s=detect_s, stream_busy_s=busy_s, fast_wait_s=fast_s,
              fast_ok=torch_all(fast == 2))
    stats["watchdog"] = wd
    log("dist_paths watchdog", json.dumps(wd))
    if not raised or busy_s <= WATCHDOG_TIMEOUT_S or not wd["fast_ok"]:
        fails.append(f"(f) watchdog: {wd}")

    # (h) The overlap scheduler's two streams against the serial schedule.
    blocks = [torch.randn(2048, 2048, generator=g, device=dev) for _ in range(6)]
    fa = lambda x: x @ x.T  # noqa: E731
    fb = lambda y: torch.tanh(y).sum(0)  # noqa: E731
    serial = [fb(fa(b)) for b in blocks]
    over, _ = counted("overlap_scheduler", lambda: OverlapScheduler(fa, fb, device=dev).run(
        blocks))
    stats["overlap_scheduler_equal"] = all(torch.equal(o, r) for o, r in zip(over, serial))
    if not stats["overlap_scheduler_equal"]:
        fails.append("(h) OverlapScheduler differs from the serial schedule")

    stats["seconds"] = seconds
    dist.destroy_process_group()
    if fails:
        raise AssertionError(f"dist paths: {fails}")
    return stats["launches"]["slam_distributed"], stats


def _stereo_inputs(dev):
    """Four rectified 640x480 pairs of the VO scene (left frames and the
    rig's right frames at VO_BASELINE), as (B, H, W) tensors."""
    import numpy as np
    import torch

    _, left, right = render_vo_scene(4)
    return (torch.from_numpy(np.stack(left[:4])).to(dev),
            torch.from_numpy(np.stack(right[:4])).to(dev))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np

    import fastmatch_tpu_torch  # noqa: F401  (sets the float32 matmul pin)
    from fastmatch_tpu_torch.kernels import _build

    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}")

    build_s = _build.build_all()
    log(f"kernels built in {build_s:.1f} s")
    for name in _build.SOURCES:
        log(f"ptxas {name}: " + " | ".join(
            line.strip() for line in _build.ptxas_report(name).splitlines()
            if "registers" in line or "spill" in line))

    phase_s = {"build": build_s}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    rng = np.random.default_rng(0)
    entries = {}
    details = {"sass": phase("sass_check", sass_check)}
    for name, fn in (("distance_topk", check_k2), ("gather_patch_sets", check_k3),
                     ("sorted_segment_sum", check_k4), ("batch_match", check_k1),
                     ("sorted_gather_rows", check_k5)):
        entries[name], details[name] = phase(f"check_{name}", fn, rng)
    details["edges"] = phase("check_edges", check_edges, rng)
    details["depth"] = phase("check_depth", check_depth, rng)
    details["host_breakdown_us"] = phase("host_breakdown", host_breakdown)

    phase("small_reference", small_reference)
    scene, views = phase("render", render_smoke_scene)
    launches = phase("config2_images", config2_images, views)
    main_launches, details["main_path"], rec = phase("main_path", main_path, scene, views)
    launches.update(main_launches)
    global_launches, details["global_sfm_selfcal"] = phase("global_sfm_selfcal",
                                                           global_sfm_selfcal, scene, views)
    details["config4_pgo"] = phase("config4_pgo", config4_pgo)
    config4_launches, details["config4_slam"], config4_inputs = phase("config4_slam",
                                                                      config4_slam)
    device_slam_launches, details["config4_device_slam"], map120 = phase(
        "config4_device_slam", config4_device_slam, *config4_inputs)
    details["cli"] = phase("cli", cli_phase, scene, views, details["main_path"])
    details["image_io"] = phase("image_io", image_io_phase, scene, views, details["cli"])
    vo_launches, details["vo_paths"] = phase("vo_paths", vo_paths)
    details["grouped_ba"] = phase("grouped_ba", grouped_ba, rec)
    details["five_point"] = phase("five_point", five_point, scene, views)
    map_launches, details["map_services"] = phase("map_services", map_services, map120,
                                                  config4_inputs[2])
    dist_launches, details["dist_paths"] = phase("dist_paths", dist_paths, rec,
                                                 config4_inputs[0], config4_inputs[2])
    details["launches_by_path"] = dict(main_path_and_config2=dict(launches),
                                       config4_slam=config4_launches,
                                       config4_device_slam_120=device_slam_launches,
                                       config4_pgo_k4=details["config4_pgo"][
                                           "k4_launches_on_the_path"],
                                       **{f"cli_{k}": details["cli"][k]["launches"] for k in (
                                           "reconstruct", "match", "evaluate_synth")},
                                       **{f"image_io_{k}": details["image_io"][k]["launches"]
                                          for k in ("reconstruct", "match", "match_arith",
                                                    "flow")},
                                       **{f"vo_{k}": v for k, v in vo_launches.items()},
                                       map_services=map_launches,
                                       global_sfm_selfcal=global_launches,
                                       dist_paths=dist_launches)
    log("phase_seconds", json.dumps(phase_s))

    meta = {
        "distance_topk": ("src/fastmatch_tpu_torch/csrc/distance_topk.cu",
                          "src/fastmatch_tpu/kernels/distance_topk.py:164"),
        "gather_patch_sets": ("src/fastmatch_tpu_torch/csrc/patch_gather.cu",
                              "src/fastmatch_tpu/kernels/patch_gather.py:117"),
        "sorted_segment_sum": ("src/fastmatch_tpu_torch/csrc/segment_sum.cu",
                               "src/fastmatch_tpu/kernels/segment_ops.py:133"),
        "batch_match": ("src/fastmatch_tpu_torch/csrc/batch_match.cu",
                        "src/fastmatch_tpu/kernels/batch_match.py:348"),
        "sorted_gather_rows": ("src/fastmatch_tpu_torch/csrc/gather_rows.cu",
                               "src/fastmatch_tpu/kernels/segment_ops.py:201"),
    }
    kernels = []
    for name, e in entries.items():
        source, replaces = meta[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **e,
                            map_services_launches=map_launches[name],
                            global_sfm_launches=global_launches[name],
                            dist_paths_launches=dist_launches[name]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_details.json"), "w") as fh:
        json.dump(dict(kernels=kernels, checks=details, phase_seconds=phase_s,
                       nvidia_smi=smi), fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
