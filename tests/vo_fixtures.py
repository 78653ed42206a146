"""Shared fixtures of the port's VO tests and the JAX package's figures on them.

The JAX package's visual odometry compiles several hundred XLA programs on
its first run (about 150 s on an 8-core CPU for tests/test_vo.py's scene,
3.4 s of it running), which no tier-1 test file can afford. So the port's
VO tests hold the port against ``JAX``, the JAX package's figures on the
same fixtures printed by ``python tools/jax_vo_reference.py --fixtures``,
and the ``slow`` test of each file re-derives its figures from the JAX
package live.
"""

from __future__ import annotations

import functools
import types

import numpy as np

from synth import SyntheticScene, render_scene_views

SIZE = (320, 240)
STEREO_BASELINE = 0.1

# tests/test_vo.py's and tests/test_vo_scan.py's configuration.
SMALL_CFG = dict(ba=dict(max_iters=10, pcg_iters=30),
                 map=dict(max_frames=32, max_points=4096, max_obs=32768))
STEREO_CFG = dict(ba=dict(max_iters=10, pcg_iters=30),
                  map=dict(max_frames=32, max_points=8192, max_obs=32768))
VO_CFG = dict(capacity=512, bootstrap_px=8.0, kf_px=6.0, min_parallax_px=4.0)


def pipeline_config(pkg, kw):
    """``pkg.pipeline.config.PipelineConfig`` from the nested dict ``kw``."""
    import importlib

    c = importlib.import_module(f"{pkg}.pipeline.config")
    return c.PipelineConfig(ba=c.BAConfig(**kw["ba"]), map=c.MapConfig(**kw["map"]))


@functools.cache
def vo_scene():
    """tests/test_vo.py's 24-frame 320x240 rendered orbit: (scene, views),
    rendered once a process (callers copy a view before changing it)."""
    rng = np.random.default_rng(3)
    scene = SyntheticScene(rng, n_points=220, n_frames=24, image_size=SIZE)
    return scene, render_scene_views(scene, rng, image_size=SIZE)


def occluded(views, frame=14):
    """The views with one frame blanked (test_recovers_through_brief_occlusion)."""
    out = [v.copy() for v in views]
    out[frame] = np.full_like(out[frame], 0.35)
    return out


def right_scene(scene, baseline):
    """tests/test_stereo_vo.py:_right_scene: the camera displaced by
    ``baseline`` along its own +x axis."""
    w, h = SIZE
    t_r = scene.t - np.array([baseline, 0.0, 0.0])
    cam = np.einsum("fij,pj->fpi", scene.R, scene.points) + t_r[:, None, :]
    z = cam[..., 2]
    uv = (cam[..., :2] / np.clip(z[..., None], 1e-9, None)) @ np.diag(
        [scene.K[0, 0], scene.K[1, 1]]) + scene.K[:2, 2]
    vis = (z > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
    return types.SimpleNamespace(points=scene.points, R=scene.R, t=t_r, K=scene.K, pixels=uv,
                                 visible=vis)


@functools.cache
def stereo_seq():
    """tests/test_stereo_vo.py's 28-frame rectified sequence: (scene, left,
    right), rendered once a process."""
    rng = np.random.default_rng(3)
    scene = SyntheticScene(rng, n_points=220, n_frames=28, image_size=SIZE)
    left = render_scene_views(scene, np.random.default_rng(11), image_size=SIZE)
    right = render_scene_views(right_scene(scene, STEREO_BASELINE), np.random.default_rng(11),
                               image_size=SIZE)
    return scene, left, right


def centers(R, t):
    return -np.einsum("fji,fj->fi", np.asarray(R, np.float64), np.asarray(t, np.float64))


def umeyama_np(X, Y, with_scale=True):
    """(s, R, t) minimizing |s R X + t - Y| (float64 numpy)."""
    mx, my = X.mean(0), Y.mean(0)
    Xc, Yc = X - mx, Y - my
    U, S, Vt = np.linalg.svd(Yc.T @ Xc / len(X))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D) / (Xc ** 2).sum(1).mean()) if with_scale else 1.0
    return s, R, my - s * R @ mx


def ate(est, gt, with_scale=True):
    """RMSE of camera centres after a sim(3) (or rigid) alignment."""
    s, R, t = umeyama_np(est, gt, with_scale)
    return float(np.sqrt(np.mean(np.sum((s * est @ R.T + t - gt) ** 2, -1))))


def summary(rec, gt_centers=None, keep=None):
    """The figures the tests compare: frames posed, flagged PnP fallbacks,
    keyframes, points, observations, boot frame, and the ATE (sim(3); for
    metric runs also the Umeyama scale and the rigid ATE)."""
    F = rec.n_frames
    out = dict(n_frames=int(F), posed=int(np.asarray(rec.pose_mask[:F]).sum()),
               pnp_failed=[int(s["frame"]) for s in rec.frame_stats if s.get("pnp_failed")],
               keyframes=sum(1 for s in rec.frame_stats if s.get("kf")),
               n_points=int(rec.n_points), n_obs=int(rec.n_obs),
               boot=[int(s["frame"]) for s in rec.frame_stats if s.get("booted")])
    if gt_centers is not None:
        est = centers(rec.R[:F], rec.t[:F])
        keep = np.ones(F, bool) if keep is None else keep
        out["ate"] = ate(est[keep], gt_centers[keep])
        out["scale"] = umeyama_np(est[keep], gt_centers[keep])[0]
        out["ate_rigid"] = ate(est[keep], gt_centers[keep], with_scale=False)
    return out


def write_pgm(path, img):
    h, w = img.shape
    path.write_bytes(f"P5\n{w} {h}\n255\n".encode()
                     + (np.clip(img, 0, 1) * 255).astype(np.uint8).tobytes())


# The JAX package's figures on these fixtures, as printed by
# ``python tools/jax_vo_reference.py --fixtures`` on an 8-core CPU (run
# times and output paths left out).
JAX = {'host': {'n_frames': 24,
          'posed': 24,
          'pnp_failed': [],
          'keyframes': 18,
          'n_points': 588,
          'n_obs': 3171,
          'boot': [5],
          'ate': 0.07282915515511688,
          'scale': 0.09830432972598141,
          'ate_rigid': 9.979210430372982},
 'host_occluded': {'n_frames': 24,
                   'posed': 24,
                   'pnp_failed': [14, 15, 16, 17, 18, 19, 21, 22, 23],
                   'keyframes': 20,
                   'n_points': 569,
                   'n_obs': 2599,
                   'boot': [5],
                   'ate': 0.4452323211578259,
                   'scale': 0.14890570462096875,
                   'ate_rigid': 6.189238578827347},
 'scan': {'n_frames': 24,
          'posed': 24,
          'pnp_failed': [],
          'keyframes': 18,
          'n_points': 588,
          'n_obs': 3172,
          'boot': [5],
          'ate': 0.08744214055277934,
          'scale': 0.10111297799425002,
          'ate_rigid': 9.662358683295412},
 'scan_occluded': {'n_frames': 24,
                   'posed': 24,
                   'pnp_failed': [14, 15, 16, 17, 18, 19, 20, 22, 23],
                   'keyframes': 20,
                   'n_points': 586,
                   'n_obs': 2645,
                   'boot': [5],
                   'ate': 0.4210364329487177,
                   'scale': 0.14932439513405218,
                   'ate_rigid': 6.222159717014925},
 'host_retro_fail': {'n_frames': 10,
                     'posed': 10,
                     'pnp_failed': [1, 2, 3, 4, 6, 7, 8, 9],
                     'keyframes': 6,
                     'n_points': 207,
                     'n_obs': 776,
                     'boot': [5]},
 'stereo': {'n_frames': 28,
            'posed': 28,
            'pnp_failed': [21, 25],
            'keyframes': 28,
            'n_points': 3389,
            'n_obs': 10123,
            'boot': [],
            'ate': 0.01568330669519703,
            'scale': 1.0069355080465385,
            'ate_rigid': 0.01736942220912517},
 'stereo_textureless': {'n_frames': 6,
                        'posed': 6,
                        'pnp_failed': [1, 2, 3, 4, 5],
                        'keyframes': 6,
                        'n_points': 0,
                        'n_obs': 0,
                        'boot': []},
 'cli': {'flow': {'n_corners': 512, 'n_tracked': 246, 'n_final': 246, 'mean_residual': 0.02287},
         'flow_verify': {'n_corners': 512,
                         'n_tracked': 246,
                         'verified': True,
                         'model_inliers': 246,
                         'n_final': 246,
                         'mean_residual': 0.02287},
         'vo_host': {'n_frames': 12,
                     'n_keyframes': 8,
                     'n_points': 198,
                     'n_obs': 802,
                     'pnp_failures': 0},
         'vo_scan': {'n_frames': 14,
                     'n_keyframes': 10,
                     'n_points': 235,
                     'n_obs': 1082,
                     'pnp_failures': 0},
         'vo_right': {'n_frames': 10,
                      'n_keyframes': 10,
                      'n_points': 1455,
                      'n_obs': 3763,
                      'pnp_failures': 0},
         'stereo': {'valid_frac': 0.6907, 'median_depth': 6.2718, 'n_points': 13291},
         'stereo_pose': {'valid_frac': 0.5142, 'median_depth': 6.6405},
         'densify': {'pairs_used': 7,
                     'pairs_considered': 7,
                     'n_points': 66712,
                     'voxel': 0.030468678474426268,
                     'median_depth': 6.093735694885254},
         'vialign': {'scale': 2.199961, 'gravity': [0.0008, -0.0002, -9.81], 'resid': 3.3e-05}}}


def cli_cases(tmp):
    """Write the CLI tests' inputs under ``tmp`` (a pathlib.Path) and return
    {name: argv} of each command, the same argv for both packages' CLIs."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import imu_circle

    scene, views = vo_scene()
    sscene, left, right = stereo_seq()
    f = str(float(scene.K[0, 0]))
    for name, frames in (("vo", views[:12]), ("scan", views[:14]), ("L", left[:10]),
                         ("R", right[:10]), ("dense", views[:8])):
        (tmp / name).mkdir()
        for i, img in enumerate(frames):
            write_pgm(tmp / name / f"f{i:03d}.pgm", img)
    write_pgm(tmp / "a.pgm", views[0])
    write_pgm(tmp / "b.pgm", views[1])
    write_pgm(tmp / "sl.pgm", left[0])
    write_pgm(tmp / "sr.pgm", right[0])
    write_pgm(tmp / "p3.pgm", views[3])
    R_ab = scene.R[3] @ scene.R[0].T
    np.savez(tmp / "pose.npz", R=R_ab, t=scene.t[3] - R_ab @ scene.t[0])
    np.savez(tmp / "gt.npz", R=scene.R[:8].astype(np.float32), t=scene.t[:8].astype(np.float32),
             points=scene.points.astype(np.float32))
    traj, imu, _ = imu_circle()
    np.savez(tmp / "traj.npz", **traj)
    np.savez(tmp / "imu.npz", **imu)
    o = str(tmp)
    vo = ["--bootstrap-px", "8.0", "--kf-px", "6.0", "--focal", f]
    return {
        "flow": ["flow", f"{o}/a.pgm", f"{o}/b.pgm", "--capacity", "512", "--out", f"{o}/flow.npz"],
        "flow_verify": ["flow", f"{o}/a.pgm", f"{o}/b.pgm", "--capacity", "512",
                        "--verify", "fundamental"],
        "vo_host": ["--set", "map.max_frames=32", "vo", f"{o}/vo", *vo, "--out", f"{o}/vo.npz",
                    "--export-kitti", f"{o}/vo.txt"],
        "vo_scan": ["--set", "map.max_frames=32", "vo", f"{o}/scan", *vo, "--engine", "scan",
                    "--out", f"{o}/scan.npz"],
        "vo_right": ["--set", "map.max_frames=32", "vo", f"{o}/L", "--right", f"{o}/R",
                     "--baseline", str(STEREO_BASELINE), "--focal", f, "--out", f"{o}/svo.npz"],
        "stereo": ["stereo", f"{o}/sl.pgm", f"{o}/sr.pgm", "--baseline", str(STEREO_BASELINE),
                   "--focal", f, "--out", f"{o}/st.npz", "--export-ply", f"{o}/st.ply"],
        "stereo_pose": ["stereo", f"{o}/a.pgm", f"{o}/p3.pgm", "--pose", f"{o}/pose.npz",
                        "--focal", f, "--max-disp", "48"],
        "densify": ["densify", f"{o}/dense", "--traj", f"{o}/gt.npz", "--focal", f,
                    "--export-ply", f"{o}/dense.ply"],
        "vialign": ["vialign", "--traj", f"{o}/traj.npz", "--imu", f"{o}/imu.npz",
                    "--out", f"{o}/metric.npz"],
    }
