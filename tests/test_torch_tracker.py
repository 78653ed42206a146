"""The port's device tracker (fastmatch_tpu_torch.pipeline.tracker, CPU)
against the JAX package's, on tests/test_tracker.py's 26-frame CircleScene
(300 points, capacity 512, MapConfig(max_frames=32, max_points=4096,
max_obs=32768)):

- ``init_state`` and the carry of a state across and back
  (``interop.track_state_from_numpy``/``_to_numpy``), bit-equal, and
  ``_state_from_bootstrap`` of one bootstrap map bit-equal;
- ``_append_rows`` at and beyond capacity, ``obs_bucket``, and on one
  carried state ``ba_problem_from_state`` with both selections and
  ``compact_obs_local`` at two buckets, exactly;
- one ``track_step`` of each package from one carried JAX state (the JAX
  package's own steps over frames 2-12) on frame 13: the matching-only
  outputs (candidates, the dedup set, votes, loop candidates) exactly; and,
  with the port's RANSAC fed the JAX step's own minimal samples (torch
  cannot replay JAX's draws; on this frame's ~100 candidates the pose moves
  by up to a degree between draws), the pose to 1e-3 and the inliers and
  new points to 1%;
- ``loop_verify`` on the carried state, the same way;
- the interval BA (``SlamHooks.ba``) on the carried state, with the time
  window and with the covisibility selection, within 1e-3;
- the port's own contracts: a failed step leaves the state bit-equal, tied
  votes order as ``lax.top_k``, and duplicate scatter indices keep the
  lowest-index writer;
- ``pack_info``/``read_info``: TrackInfo comes back in one transfer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.geometry import ransac as jran
from fastmatch_tpu.pipeline import slam_device as jsd
from fastmatch_tpu.pipeline import tracker as jtr
from fastmatch_tpu.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu.pipeline.slam import SlamConfig
from test_slam import CircleScene, features_of

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.geometry import pnp as tpnp
from fastmatch_tpu_torch.pipeline import slam_device as tsd
from fastmatch_tpu_torch.pipeline import tracker as ttr

torch.set_num_threads(1)

CAP = 512
CARRIED_TO = 13  # the carried state has tracked frames 2..12


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    scene = CircleScene(rng, n_points=300, n_frames=26)
    feats = features_of(rng, scene)
    cfg = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                         map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
    scfg = SlamConfig(window=6, loop_gap=10, loop_min_votes=20)
    jcam = JPinhole.from_K(scene.K)
    jtcfg = jsd._static_from_cfg(cfg, scfg, CAP, jcam)
    thr = jnp.float32((cfg.ransac.thr_px / float(jcam.fx)) ** 2)
    return dict(scene=scene, feats=feats, cfg=cfg, scfg=scfg, jcam=jcam, jtcfg=jtcfg,
                tcfg=interop.tracker_static_from(jtcfg), cam=Pinhole.from_K(scene.K),
                thr=thr, thr_n=float(thr))


@pytest.fixture(scope="module")
def carried(setup):
    """The JAX package's state after its bootstrap and frames 2..12, and
    the JAX step's (state, info) on frame 13."""
    s = setup
    key = jax.random.PRNGKey(0)
    rec0, kp_lm1 = jsd._bootstrap_host(s["feats"], s["jcam"], s["cfg"], s["scfg"],
                                       jax.random.fold_in(key, 1))
    boot = jsd._state_from_bootstrap(rec0, s["feats"], kp_lm1, s["jcam"], s["jtcfg"])
    boot_np = interop.track_state_to_numpy(boot)
    state = boot
    for fi in range(2, CARRIED_TO):
        state, info = jtr.track_step(state, *map(jnp.asarray, s["feats"][fi]),
                                     jax.random.fold_in(key, fi), s["thr"],
                                     jnp.int32(s["scfg"].window), s["jtcfg"])
        assert bool(info.ok)
    before = interop.track_state_to_numpy(state)
    after, info = jtr.track_step(state, *map(jnp.asarray, s["feats"][CARRIED_TO]),
                                 jax.random.fold_in(key, CARRIED_TO), s["thr"],
                                 jnp.int32(s["scfg"].window), s["jtcfg"])
    return dict(rec0=rec0, kp_lm1=kp_lm1, boot=boot_np, state=before,
                after=interop.track_state_to_numpy(after),
                info=jax.tree_util.tree_map(np.asarray, info))


def _same_state(a: dict, b: dict):
    for name in ttr.TrackState._fields:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _tensors(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_init_state_and_carry_both_ways(setup, carried):
    s = setup
    jinit = interop.track_state_to_numpy(jtr.init_state(s["jtcfg"], s["jcam"]))
    _same_state(interop.track_state_to_numpy(ttr.init_state(s["tcfg"], s["cam"], "cpu")), jinit)
    for st in (jinit, carried["state"]):
        port = interop.track_state_from_numpy(st, device="cpu")
        assert all(t.device.type == "cpu" for t in port)
        _same_state(interop.track_state_to_numpy(port), st)


def test_state_from_bootstrap_as_jax(setup, carried):
    s = setup
    rec = interop.reconstruction_from_numpy(interop.reconstruction_to_numpy(carried["rec0"]),
                                            interop.config_from(s["cfg"]), s["cam"], "cpu")
    port = tsd._state_from_bootstrap(rec, s["feats"], carried["kp_lm1"], s["cam"], s["tcfg"],
                                     torch.device("cpu"))
    _same_state(interop.track_state_to_numpy(port), carried["boot"])


def test_tracker_static_as_jax(setup):
    s = setup
    got = tsd._static_from_cfg(interop.config_from(s["cfg"]), s["scfg"], CAP, s["cam"])
    assert got == s["tcfg"]
    assert dataclasses.asdict(got) == dataclasses.asdict(s["jtcfg"])


@pytest.mark.parametrize("count,n_sel", [(0, 10), (90, 10), (95, 10), (100, 7), (60, 0)])
def test_append_rows_at_and_beyond_capacity(count, n_sel):
    """A 100-row table: appends that fit, that end exactly at capacity,
    that overflow (rows dropped, flag raised) and that start full."""
    rng = np.random.default_rng(count + n_sel)
    cap, C = 100, 16
    arrays = [rng.integers(0, 50, cap).astype(np.int32),
              rng.standard_normal((cap, 2)).astype(np.float32), rng.random(cap) < 0.5]
    rows = [rng.integers(0, 50, C).astype(np.int32),
            rng.standard_normal((C, 2)).astype(np.float32), np.ones(C, bool)]
    sel = np.zeros(C, bool)
    sel[rng.choice(C, n_sel, replace=False)] = True
    jout, jn, jovf = jtr._append_rows([jnp.asarray(a) for a in arrays], jnp.asarray(sel),
                                      [jnp.asarray(r) for r in rows], jnp.int32(count))
    out, n, ovf = ttr._append_rows(_tensors(*arrays), torch.from_numpy(sel), _tensors(*rows),
                                   torch.tensor(count, dtype=torch.int32))
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (int(n), bool(ovf)) == (int(jn), bool(jovf))
    assert bool(ovf) == (count + n_sel > cap)


@pytest.mark.parametrize("n_obs", [0, 1, 2048, 2049, 5000, 40000, 70000])
def test_obs_bucket_as_jax(n_obs):
    assert ttr.obs_bucket(n_obs, 65536) == jtr.obs_bucket(n_obs, 65536)


def _problem_np(prob):
    """Every array of a BAProblem of either package, in field order."""
    return [np.asarray(prob.poses.R), np.asarray(prob.poses.t), np.asarray(prob.points),
            *(np.asarray(f) for f in prob.obs), np.asarray(prob.cam_mask),
            np.asarray(prob.pt_mask), np.asarray(prob.fixed_cams)]


@pytest.mark.parametrize("selection", ["window", "window-free2", "covis", "full"])
@pytest.mark.parametrize("bucket", [0, 600, 1 << 16])
def test_ba_problem_and_local_compaction_as_jax(setup, carried, selection, bucket):
    """The local BA problem of the carried state and its compaction to
    ``bucket`` rows (0: none; 600: fewer than the relevant rows, so the
    newest win; 65536: at least the table) equal the JAX package's."""
    st = carried["state"]
    jst = jtr.TrackState(**{k: jnp.asarray(v) for k, v in st.items()})
    port = interop.track_state_from_numpy(st, device="cpu")
    f, window = int(st["n_frames"]) - 1, setup["scfg"].window
    kw = dict(window={}, full={}, covis=dict(covis=carried["info"].covis, covis_thresh=40))
    kw["window-free2"] = dict(free_second_cam=True)
    if selection == "full":
        window = ttr.FULL_WINDOW
    jp = jtr.ba_problem_from_state(jst, jnp.int32(f), jnp.int32(window), **kw[selection])
    tp = ttr.ba_problem_from_state(port, f, window, **kw[selection])
    if bucket:
        jp = jtr.compact_obs_local(jp, bucket)
        tp = ttr.compact_obs_local(tp, bucket)
    for a, b in zip(_problem_np(tp), _problem_np(jp)):
        np.testing.assert_array_equal(a, b)
    if selection == "covis":  # the covisibility row frees old cameras too
        fixed = np.asarray(jp.fixed_cams)[: f + 1]
        assert not fixed[f - window:].any() and fixed[:2].all()


@pytest.mark.parametrize("selection", ["window", "covis"])
def test_local_ba_from_carried_state_as_jax(setup, carried, selection):
    """``SlamHooks.ba``, the interval BA of both drivers, on the carried
    state: the time window, or the covisibility union (threshold 40, which
    frees old co-observing frames); poses and points within 1e-3 of the
    JAX package's solve (BA moves them by ~0.17)."""
    s = setup
    st = carried["state"]
    f, window = int(st["n_frames"]) - 1, s["scfg"].window
    kw = dict(covis=carried["info"].covis, covis_thresh=40) if selection == "covis" else {}
    jst = jtr.TrackState(**{k: jnp.asarray(v) for k, v in st.items()})
    ref = jsd.SlamHooks().ba(jst, jnp.int32(f), jnp.int32(window), s["cfg"], s["jcam"], **kw)
    got = tsd.SlamHooks().ba(interop.track_state_from_numpy(st, device="cpu"), f, window,
                             interop.config_from(s["cfg"]), s["cam"], **kw)
    assert np.abs(np.asarray(ref.t) - st["t"]).max() > 0.05
    for name in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-3, err_msg=name)


def _jax_draws(monkeypatch, key):
    """Make the port's PnP sample what JAX's ``ransac_pnp(key, ...)``
    samples: its 6-point then its 4-point sets, from the port's own mask
    (which equals JAX's, matching being exact)."""
    keys = iter(jax.random.split(key))

    def draws(generator, mask, n_hyp, size):
        idx = jran._sample_minimal_sets(next(keys), jnp.asarray(mask.numpy()), n_hyp, size)
        return torch.from_numpy(np.asarray(idx)).long()

    monkeypatch.setattr(tpnp, "_sample_minimal_sets", draws)


def test_track_step_from_carried_state(setup, carried, monkeypatch):
    s = setup
    _jax_draws(monkeypatch, jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                                                 CARRIED_TO))[1])
    port = interop.track_state_from_numpy(carried["state"], device="cpu")
    frame = _tensors(*s["feats"][CARRIED_TO])
    new, info = ttr.track_step(port, *frame, ttr.frame_generator(0, CARRIED_TO, 0), s["thr_n"],
                               s["scfg"].window, s["tcfg"])
    got = ttr.read_info(info)
    ref = carried["info"]
    assert got.ok and bool(ref.ok) and got.is_kf == bool(ref.is_kf)
    # Matching alone decides these: exact.
    assert got.n_candidates == int(ref.n_candidates)
    np.testing.assert_array_equal(got.votes, np.asarray(ref.votes))
    np.testing.assert_array_equal(got.cands, np.asarray(ref.cands))
    assert got.votes[0] >= s["scfg"].loop_min_votes
    tcfg = s["tcfg"]
    mf = ttr._match(frame[1], frame[2], port.pt_desc, port.pt_mask, tcfg, 1.0, False)
    jst = jtr.TrackState(**{k: jnp.asarray(v) for k, v in carried["state"].items()})
    jmf = jtr._match(jnp.asarray(s["feats"][CARRIED_TO][1]), jnp.asarray(s["feats"][CARRIED_TO][2]),
                     jst.pt_desc, jst.pt_mask, s["jtcfg"], 1.0, False)
    known = (mf.valid & (mf.dist < tcfg.dedup_desc_d2)).numpy()
    np.testing.assert_array_equal(
        known, np.asarray(jmf.valid & (jmf.dist < s["jtcfg"].dedup_desc_d2)))
    assert known.sum() > 100
    np.testing.assert_allclose(got.R, np.asarray(ref.R), atol=1e-3)
    np.testing.assert_allclose(got.t, np.asarray(ref.t), atol=1e-3)
    for k in ("n_inliers", "n_new_points"):
        assert abs(int(getattr(got, k)) - int(getattr(ref, k))) <= 0.01 * int(getattr(ref, k)), k
    after = interop.track_state_to_numpy(new)
    for k in ("n_frames", "last_kf", "prev_f"):
        assert int(after[k]) == int(carried["after"][k]), k
    assert abs(int(after["n_obs"]) - int(carried["after"]["n_obs"])) <= 0.01 * int(
        carried["after"]["n_obs"])


def test_loop_verify_on_carried_state(setup, carried, monkeypatch):
    s = setup
    _jax_draws(monkeypatch, jax.random.PRNGKey(2))
    cand = int(carried["info"].cands[0])
    xy, d, m = s["feats"][CARRIED_TO]
    jst = jtr.TrackState(**{k: jnp.asarray(v) for k, v in carried["state"].items()})
    jpl, jn = jtr.loop_verify(jst, jnp.asarray(xy), jnp.asarray(d), jnp.asarray(m),
                              jnp.int32(cand), jax.random.PRNGKey(2), s["thr"], s["jtcfg"])
    port = interop.track_state_from_numpy(carried["state"], device="cpu")
    pl, n = ttr.loop_verify(port, *_tensors(xy, d, m), cand, ttr.frame_generator(0, 13, 2),
                            s["thr_n"], s["tcfg"])
    assert int(n) == int(jn) > 50
    assert bool(pl.ok) and bool(jpl.ok)
    np.testing.assert_allclose(pl.pose.R.numpy(), np.asarray(jpl.pose.R), atol=1e-3)
    np.testing.assert_allclose(pl.pose.t.numpy(), np.asarray(jpl.pose.t), atol=1e-3)
    assert abs(int(pl.n_inliers) - int(jpl.n_inliers)) <= 0.01 * int(jpl.n_inliers)


def test_failed_step_leaves_state_unchanged(setup, carried):
    """A frame of pure noise fails PnP; the state comes back bit-equal (the
    contract that relocalization relies on)."""
    s = setup
    port = interop.track_state_from_numpy(carried["state"], device="cpu")
    rng = np.random.default_rng(9)
    xy = rng.uniform(0, 600, (CAP, 2)).astype(np.float32)
    d = np.abs(rng.standard_normal((CAP, 128))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    new, info = ttr.track_step(port, *_tensors(xy, d, np.ones(CAP, bool)),
                               ttr.frame_generator(3, 0), s["thr_n"], s["scfg"].window,
                               s["tcfg"])
    assert not ttr.read_info(info).ok
    _same_state(interop.track_state_to_numpy(new), carried["state"])


@pytest.mark.parametrize("seed", range(4))
def test_tied_votes_order_as_lax_top_k(seed):
    """Vote counts with many ties (small integers, zeros): the same top 4
    values and frames as ``lax.top_k``, the lower frame first."""
    rng = np.random.default_rng(seed)
    votes = rng.integers(0, 4, 32).astype(np.int32)
    votes[rng.random(32) < 0.4] = 0
    if seed == 3:
        votes[:] = 7
    tv, tc = ttr._top4(torch.from_numpy(votes))
    jv, jc = jax.lax.top_k(jnp.asarray(votes), 4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("seed", range(3))
def test_duplicate_scatter_indices_keep_the_first_writer(seed):
    """Keypoints tracking one landmark more than once (possible without
    cross-check): the descriptor refresh keeps the lowest keypoint's row,
    whatever the order of the scatter; dropped rows (index P) go nowhere."""
    rng = np.random.default_rng(seed)
    P, C = 40, 64
    bank = torch.from_numpy(rng.standard_normal((P, 4)).astype(np.float32))
    rows = torch.from_numpy(rng.standard_normal((C, 4)).astype(np.float32))
    sel = rng.integers(0, 12, C).astype(np.int32)
    sel[rng.random(C) < 0.3] = P
    first = ttr._first_writers(torch.from_numpy(sel), P).numpy()
    want = bank.numpy().copy()
    for k in range(C)[::-1]:  # the lowest writer last, so it wins
        if sel[k] < P:
            want[sel[k]] = rows[k].numpy()
    np.testing.assert_array_equal(ttr._put(bank, torch.from_numpy(first), rows).numpy(), want)
    kept = first[first < P]
    assert len(kept) == len(set(kept)) == len(set(sel[sel < P]))


def test_track_info_comes_back_in_one_transfer(setup, carried, monkeypatch):
    """The counterpart of test_tracker.py's readback test: ``read_info``
    brings every TrackInfo field back with one device-to-host copy, and
    unpacks it exactly."""
    s = setup
    port = interop.track_state_from_numpy(carried["state"], device="cpu")
    _, info = ttr.track_step(port, *_tensors(*s["feats"][CARRIED_TO]),
                             ttr.frame_generator(0, 13, 0), s["thr_n"], s["scfg"].window,
                             s["tcfg"])
    copies = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: copies.append(1) or real(
        self, *a, **k))
    host = ttr.read_info(info)
    assert len(copies) == 1
    for name, v in zip(ttr.TrackInfo._fields, info):
        np.testing.assert_array_equal(np.asarray(getattr(host, name)), v.numpy(), err_msg=name)
