"""The port's SLAM (fastmatch_tpu_torch.pipeline.slam, CPU) against the JAX
package's:

- ``_run_pgo_and_refine`` from one state carried to both packages by
  ``interop.slam_state_to_numpy``/``slam_state_from_numpy`` (a perturbed
  synthetic map with odometry edges and one loop edge): poses after the
  pose-graph solve within 1e-3, the global BA's costs within rtol 1e-3;
- loop retrieval on the same features and map: the same per-frame votes
  and the same candidate (matching decisions are exact, so the votes are);
- the whole ``slam`` on the 26-frame CircleScene of tests/test_slam.py
  (rebuilt here; 300 points, capacity 512, the same configs), held to that
  test's own bounds. RANSAC draws cannot be replayed across frameworks, so
  this compares outcomes, not bits;
- ``MetricsLogger``: the JAX package's event names and fields for "track",
  "loop_closure" (slam) and "frame" (reconstruct).
"""

import json

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline import config as jconfig
from fastmatch_tpu.pipeline import slam as jslam
from fastmatch_tpu.pipeline.reconstruct import Reconstruction as JReconstruction
from fastmatch_tpu.pipeline.reconstruct import _match as j_match
from fastmatch_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from synth import SyntheticScene, random_descriptors
from test_pipeline import synthetic_features

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.pipeline import config as tconfig
from fastmatch_tpu_torch.pipeline import slam as tslam
from fastmatch_tpu_torch.pipeline.reconstruct import _Run, reconstruct
from fastmatch_tpu_torch.utils.evaluation import ate_rmse
from fastmatch_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)


class CircleScene:
    """tests/test_slam.py's scene: cameras on a full circle looking inward,
    so late frames overlap early ones."""

    def __init__(self, rng, n_points=300, n_frames=26, radius=6.0):
        w, h = 640, 480
        self.K = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1.0]])
        self.points = rng.uniform(-1.5, 1.5, size=(n_points, 3))
        Rs, ts = [], []
        for k in range(n_frames):
            ang = 2 * np.pi * k / n_frames
            c, s = np.cos(ang), np.sin(ang)
            eye = np.array([radius * s, 0.3 * np.sin(2 * ang), -radius * c])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
            right /= np.linalg.norm(right)
            R_cw = np.stack([right, np.cross(fwd, right), fwd], axis=1).T
            Rs.append(R_cw)
            ts.append(-R_cw @ eye)
        self.R, self.t = np.stack(Rs), np.stack(ts)
        cam = np.einsum("fij,pj->fpi", self.R, self.points) + self.t[:, None, :]
        z = cam[..., 2]
        uv = (cam[..., :2] / np.clip(z[..., None], 1e-9, None)) * 500.0 + self.K[:2, 2]
        self.pixels = uv
        self.visible = ((z > 0.5) & (uv[..., 0] >= 0) & (uv[..., 0] < w)
                        & (uv[..., 1] >= 0) & (uv[..., 1] < h))


def features_of(rng, scene, noise_px=0.3, cap=512):
    """tests/test_slam.py's per-frame (xy, desc, mask) observations."""
    base = random_descriptors(rng, scene.points.shape[0])
    feats = []
    for f in range(scene.R.shape[0]):
        vis = np.where(scene.visible[f])[0]
        xy = scene.pixels[f, vis] + noise_px * rng.standard_normal((len(vis), 2))
        desc = np.abs(base[vis] + 0.05 * rng.standard_normal((len(vis), 128)).astype(np.float32))
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        n = len(vis)
        xy_p, d_p, m_p = np.zeros((cap, 2), np.float32), np.zeros((cap, 128), np.float32), \
            np.zeros(cap, bool)
        xy_p[:n], d_p[:n], m_p[:n] = xy, desc, True
        feats.append((xy_p, d_p, m_p))
    return feats


@pytest.fixture(scope="module")
def circle(tmp_path_factory):
    rng = np.random.default_rng(0)
    scene = CircleScene(rng)
    feats = features_of(rng, scene)
    cfg = tconfig.PipelineConfig(ba=tconfig.BAConfig(interval=5, max_iters=8, pcg_iters=30),
                                 map=tconfig.MapConfig(max_frames=32, max_points=4096,
                                                       max_obs=32768))
    scfg = tslam.SlamConfig(window=6, loop_gap=10, loop_min_votes=20)
    path = tmp_path_factory.mktemp("metrics") / "slam.jsonl"
    logger = MetricsLogger(str(path))
    out = tslam.slam(feats, Pinhole.from_K(scene.K), cfg, scfg, metrics=logger, device="cpu")
    logger.close()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    return scene, feats, cfg, scfg, out, events


def test_slam_circle_meets_the_jax_bounds(circle):
    scene, _, _, _, out, _ = circle
    assert out.rec.n_frames == 26 and out.rec.pose_mask[:26].all()
    assert len(out.loop_edges) >= 1
    f, c = out.loop_edges[0][:2]
    assert f - c >= 10
    assert out.pgo_runs >= 1
    assert len(out.odo_edges) == 25
    gt = -np.einsum("fji,fj->fi", scene.R, scene.t)
    ate = float(ate_rmse(out.rec.camera_centers(), gt))
    assert ate < 0.25, f"ATE {ate:.3f}"
    assert out.rec.stage_seconds["loop"] > 0 and out.rec.stage_seconds["pgo"] > 0


def test_loop_retrieval_votes_as_jax(circle):
    """Retrieval at the first loop closure's frame and at the last frame,
    the port's device bank against the JAX package's host concatenation
    (its slam.py:266-283), on one map."""
    _, feats, cfg, scfg, out, _ = circle
    for f in (out.loop_edges[0][0], len(feats) - 1):
        _hold_retrieval(f, feats, cfg, scfg, out.rec, closes=f == out.loop_edges[0][0])


def _hold_retrieval(f, feats, cfg, scfg, rec, closes):
    n_old = f - scfg.loop_gap
    per = feats[0][1].shape[0]
    jcfg = jconfig.PipelineConfig(ba=jconfig.BAConfig(interval=5, max_iters=8, pcg_iters=30))
    valid, idx = j_match(feats[f][1], feats[f][2],
                         np.concatenate([feats[k][1] for k in range(n_old)]),
                         np.concatenate([feats[k][2] for k in range(n_old)]), jcfg)
    jvotes = np.bincount(idx[valid] // per, minlength=n_old) if valid.any() else None
    votes = _port_votes(f, feats, cfg, rec, n_old, per)
    if jvotes is None:
        assert votes is None and not closes
        return
    jcand = -1
    for c in np.argsort(-jvotes)[:4]:
        if jvotes[c] < scfg.loop_min_votes:
            break
        if np.any(rec.obs_cam[: rec.n_obs] == c):
            jcand = int(c)
            break
    np.testing.assert_array_equal(votes, jvotes)
    assert tslam._loop_candidate(votes, rec, scfg.loop_min_votes) == jcand
    assert (jcand >= 0) == closes


def _port_votes(f, feats, cfg, rec, n_old, per):
    run = _Run(rec, 0)
    bank = tslam._Bank(run, cfg.map.max_frames, per, 128)
    for k, (_, d, m) in enumerate(feats):
        bank.put(k, run.tensor(d), run.tensor(m))
    return tslam._loop_votes(run, Descriptors(run.tensor(feats[f][1]), run.tensor(feats[f][2])),
                             bank, n_old, cfg)


def _slam_state(seed=7, n=12, drift=0.01):
    """A JAX SlamResult on a perturbed synthetic map: drifted poses
    integrated from noisy odometry edges (i, i - 1), one exact loop edge
    (n - 1, 0), every visible (frame, point) observed."""
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(rng, n_points=150, n_frames=n, noise_px=0.3, span=0.8)
    cfg = jconfig.PipelineConfig(ba=jconfig.BAConfig(max_iters=8, pcg_iters=30),
                                 map=jconfig.MapConfig(max_frames=16, max_points=1024,
                                                       max_obs=8192))
    rec = JReconstruction(cfg=cfg, camera=JPinhole.from_K(scene.K))
    out = jslam.SlamResult(rec=rec)
    R, t = [scene.R[0]], [scene.t[0]]
    for k in range(1, n):
        Rz = scene.R[k] @ scene.R[k - 1].T
        tz = scene.t[k] - Rz @ scene.t[k - 1] + drift * rng.standard_normal(3)
        R.append(Rz @ R[-1])
        t.append(Rz @ t[-1] + tz)
        out.odo_edges.append((k, k - 1, Rz.astype(np.float32), tz.astype(np.float32)))
    Rl = scene.R[n - 1] @ scene.R[0].T
    out.loop_edges.append((n - 1, 0, Rl.astype(np.float32),
                           (scene.t[n - 1] - Rl @ scene.t[0]).astype(np.float32)))
    rec.R[:n], rec.t[:n] = np.stack(R), np.stack(t)
    rec.pose_mask[:n] = True
    rec.n_frames = n
    seen = scene.visible.sum(0) >= 2
    X = scene.points[seen] + 0.02 * rng.standard_normal((seen.sum(), 3))
    ids = rec.add_points(X.astype(np.float32), np.zeros((seen.sum(), 128), np.float32))
    for f in range(n):
        vis = scene.visible[f][seen]
        uv = (scene.pixels[f][seen][vis] - scene.K[:2, 2]) / scene.K[0, 0]
        rec.add_observations(f, ids[vis], uv.astype(np.float32))
    return out, scene


def _record_run_ba(rec, seen):
    """Have rec.run_ba record the poses it starts from (the PGO's output)
    and the costs it returns."""
    run_ba = rec.run_ba

    def wrapped(*a, **k):
        seen["R"], seen["t"] = np.array(rec.R, copy=True), np.array(rec.t, copy=True)
        seen["costs"] = run_ba(*a, **k)
        return seen["costs"]

    rec.run_ba = wrapped


def test_run_pgo_and_refine_vs_jax():
    jout, scene = _slam_state()
    state = interop.slam_state_to_numpy(jout)
    tout, _ = interop.slam_state_from_numpy(state, interop.config_from(jout.rec.cfg),
                                            Pinhole.from_K(scene.K), device="cpu")
    back = interop.slam_state_to_numpy(tout)
    for k in ("odo_edges", "loop_edges"):
        for e, g in zip(state[k], back[k]):
            assert e[:2] == g[:2]
            np.testing.assert_array_equal(e[2], g[2])
            np.testing.assert_array_equal(e[3], g[3])
    jseen, tseen = {}, {}
    _record_run_ba(jout.rec, jseen)
    _record_run_ba(tout.rec, tseen)
    scfg = dict(pgo_iters=20, loop_kernel_delta=0.1)
    jslam._run_pgo_and_refine(jout.rec, jout, 11, jslam.SlamConfig(**scfg), jout.rec.cfg,
                              jout.rec.camera)
    tslam._run_pgo_and_refine(tout.rec, tout, 11, tslam.SlamConfig(**scfg), tout.rec.cfg,
                              tout.rec.camera)
    assert tout.pgo_runs == jout.pgo_runs == 1
    live = jout.rec.pose_mask
    np.testing.assert_allclose(tseen["R"][live], jseen["R"][live], atol=1e-3)
    np.testing.assert_allclose(tseen["t"][live], jseen["t"][live], atol=1e-3)
    np.testing.assert_allclose(tseen["costs"], jseen["costs"], rtol=1e-3)
    assert tseen["costs"][1] < tseen["costs"][0]
    np.testing.assert_allclose(tout.rec.t[live], jout.rec.t[live], atol=2e-3)


def test_metrics_events_as_jax(circle, tmp_path):
    """slam's "track" and "loop_closure" events and reconstruct's "frame" and
    "ba" events carry the JAX package's fields; a record of either logger
    is the same JSON object but for its time stamp."""
    *_, events = circle
    fields = {e["event"]: set(e) for e in events}
    assert fields["track"] == {"ts", "event", "step", "frame", "n_candidates", "n_inliers",
                               "keyframe", "n_points"}
    assert fields["loop_closure"] == {"ts", "event", "step", "frame", "candidate", "inliers"}
    assert [e["step"] for e in events] == list(range(len(events)))
    rng = np.random.default_rng(0)
    scene = SyntheticScene(rng, n_points=150, n_frames=4)
    feats = synthetic_features(rng, scene, noise_px=0.3)
    cfg = tconfig.PipelineConfig(ba=tconfig.BAConfig(interval=2, max_iters=5, pcg_iters=20),
                                 map=tconfig.MapConfig(max_frames=8, max_points=1024,
                                                       max_obs=8192))
    path = tmp_path / "rec.jsonl"
    logger = MetricsLogger(str(path))
    reconstruct(feats, Pinhole.from_K(scene.K), cfg, device="cpu", metrics=logger)
    logger.close()
    rec_events = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e["event"] for e in rec_events] == ["frame", "ba", "frame", "ba"]
    assert set(rec_events[0]) == {"ts", "event", "step", "frame", "n_kp", "n_pnp_inliers",
                                  "n_new_pts", "n_points"}
    assert rec_events[-1]["final"] is True
    for cls, name in ((JMetricsLogger, "j"), (MetricsLogger, "t")):
        lg = cls(str(tmp_path / f"{name}.jsonl"))
        lg.log("track", frame=3, n_candidates=10, n_inliers=8, keyframe=True, n_points=40)
        with lg.timer("stage", what="x"):
            pass
        lg.close()
    j, t = ([json.loads(line) for line in (tmp_path / f"{n}.jsonl").read_text().splitlines()]
            for n in ("j", "t"))
    for a, b in zip(j, t):
        a.pop("ts"), b.pop("ts"), a.pop("seconds", None), b.pop("seconds", None)
        assert a == b
