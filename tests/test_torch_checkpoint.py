"""The port's checkpoints (fastmatch_tpu_torch.pipeline.checkpoint, CPU):
``map.pt`` and ``track.pt`` in a directory, beside the JAX package's orbax
checkpoints.

- ``save_map`` / ``restore_map`` round trip, every array equal;
- the 16-byte config-hash guard: a config carried across by
  ``interop.config_from`` hashes as the JAX package's, a mismatch raises
  under ``strict_config=True``;
- a JAX ``save_map`` tree (an orbax directory, restored with orbax)
  converted by ``interop.map_checkpoint_from_numpy`` restores array-equal,
  and the orbax directory itself raises ``ValueError`` naming the
  converter; a file holding pickled code is refused (``weights_only``);
- ``drive_slam`` saved by ``save_track_state`` from ``SlamHooks.after_frame``
  and resumed from ``restore_track_state`` ends bit-identical to the
  uninterrupted run (tests/test_tracker.py's 26-frame CircleScene);
- ``restore_map`` then ``run_ba`` lowers the cost, as
  tests/test_checkpoint_cli.py checks;
- the CLI's ``slam --checkpoint --gps`` (the host engine on the CPU)
  writes the georegistered map.
"""

import json
import os

import numpy as np
import pytest
import torch

from fastmatch_tpu.pipeline import checkpoint as jckpt
from fastmatch_tpu.pipeline.config import (BAConfig as JBA, MapConfig as JMap,
                                           PipelineConfig as JCfg)
from synth import SyntheticScene
from test_pipeline import synthetic_features
from test_slam import CircleScene, features_of
from test_torch_localize import scene_map

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import checkpoint as ck
from fastmatch_tpu_torch.pipeline import slam_device as tsd
from fastmatch_tpu_torch.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction, reconstruct
from fastmatch_tpu_torch.pipeline.slam import SlamConfig

torch.set_num_threads(1)

CFG = PipelineConfig(ba=BAConfig(interval=4, max_iters=8),
                     map=MapConfig(max_frames=16, max_points=2048, max_obs=16384))
NAMES = ("R", "t", "pose_mask", "points", "pt_mask", "pt_desc", "obs_cam", "obs_pt",
         "obs_uv", "obs_mask")


@pytest.fixture(scope="module")
def small_map():
    rng = np.random.default_rng(0)
    scene = SyntheticScene(rng, n_points=200, n_frames=8)
    feats = synthetic_features(rng, scene, noise_px=0.4)
    cam = Pinhole.from_K(scene.K)
    return reconstruct(feats, cam, CFG, device="cpu"), cam


def _same(a, b):
    for name in NAMES:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.n_frames, a.n_points, a.n_obs) == (b.n_frames, b.n_points, b.n_obs)


def test_map_roundtrip(small_map, tmp_path):
    rec, cam = small_map
    ck.save_map(rec, str(tmp_path / "ckpt"))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["map.pt"]
    rec2 = ck.restore_map(Reconstruction(cfg=CFG, camera=cam), str(tmp_path / "ckpt"))
    _same(rec2, rec)


def test_config_hash_guard(small_map, tmp_path):
    rec, cam = small_map
    jcfg = JCfg(ba=JBA(interval=4, max_iters=8),
                map=JMap(max_frames=16, max_points=2048, max_obs=16384))
    assert CFG.config_hash() == jcfg.config_hash() == interop.config_from(jcfg).config_hash()
    ck.save_map(rec, str(tmp_path / "ckpt2"))
    other = PipelineConfig(ba=BAConfig(interval=3),
                           map=MapConfig(max_frames=16, max_points=2048, max_obs=16384))
    with pytest.raises(ValueError, match="config hash"):
        ck.restore_map(Reconstruction(cfg=other, camera=cam), str(tmp_path / "ckpt2"))
    loose = ck.restore_map(Reconstruction(cfg=other, camera=cam), str(tmp_path / "ckpt2"),
                           strict_config=False)
    np.testing.assert_array_equal(loose.points, rec.points)


def test_jax_checkpoint_converts(tmp_path):
    import orbax.checkpoint as ocp

    scene, _, jrec, _ = scene_map(n_frames=10)
    jckpt.save_map(jrec, str(tmp_path / "orbax"))
    tree = ocp.PyTreeCheckpointer().restore(str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match="interop.map_checkpoint_from_numpy"):
        ck.load_map_arrays(str(tmp_path / "orbax"))
    interop.map_checkpoint_from_numpy(tree, str(tmp_path / "port"))
    rec = Reconstruction(cfg=interop.config_from(jrec.cfg),
                         camera=Pinhole.from_K(scene.K.astype(np.float32)))
    ck.restore_map(rec, str(tmp_path / "port"))  # strict: the carried hash matches
    _same(rec, jrec)


def test_pickled_code_is_refused(tmp_path):
    class Payload:
        def __reduce__(self):
            return (os.getcwd, ())

    os.makedirs(tmp_path / "bad")
    torch.save({"format": ck.MAP_FORMAT, "x": Payload()}, str(tmp_path / "bad" / "map.pt"))
    with pytest.raises(Exception, match="[Ww]eights"):
        ck.load_map_arrays(str(tmp_path / "bad"))


def test_restore_then_ba_lowers_cost(small_map, tmp_path):
    rec, cam = small_map
    ck.save_map(rec, str(tmp_path / "ckpt3"))
    rec2 = ck.restore_map(Reconstruction(cfg=CFG, camera=cam), str(tmp_path / "ckpt3"))
    c0, c1 = rec2.run_ba()
    assert c1 <= c0 * 1.001


SLAM_CFG = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                          map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
SNAPSHOT_FID = 12


class _Saver(tsd.SlamHooks):
    def __init__(self, path):
        self.path = path

    def after_frame(self, state, fid, fi, out, book):
        if fid == SNAPSHOT_FID:
            ck.save_track_state(state, book, out, self.path)


def test_resume_from_track_checkpoint_is_bit_identical(tmp_path):
    rng = np.random.default_rng(0)
    scene = CircleScene(rng, n_points=300, n_frames=26)
    feats = features_of(rng, scene)
    scfg = SlamConfig(window=6, loop_gap=10, loop_min_votes=20)
    cam = Pinhole.from_K(scene.K)
    path = str(tmp_path / "track")
    full = tsd.drive_slam(feats, cam, SLAM_CFG, scfg, hooks=_Saver(path), device="cpu")
    assert os.listdir(path) == ["track.pt"]
    state, book, out0 = ck.restore_track_state(path, device="cpu")
    assert out0.rec is None and int(book["next_fid"]) == SNAPSHOT_FID + 1
    out = tsd.drive_slam(feats, cam, SLAM_CFG, scfg, resume=(state, book, out0), device="cpu")
    assert out.frame_seq == full.frame_seq
    for name in NAMES:
        np.testing.assert_array_equal(getattr(out.rec, name), getattr(full.rec, name),
                                      err_msg=name)
    assert [e[:2] for e in out.loop_edges] == [e[:2] for e in full.loop_edges]
    for a, b in zip(out.odo_edges + out.loop_edges, full.odo_edges + full.loop_edges):
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
    assert out.pgo_runs == full.pgo_runs


def _run_cli(capsys, argv):
    from fastmatch_tpu_torch import cli

    capsys.readouterr()
    rc = cli.main(argv)
    return rc, [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def test_slam_checkpoint_and_gps(tmp_path, capsys):
    """``slam --checkpoint --gps`` (the host engine on the CPU): the GPS
    summary in the JSON and the georegistered map in the checkpoint."""
    from test_torch_cli_map import _npz

    rng = np.random.default_rng(4)
    scene = CircleScene(rng, n_points=300, n_frames=10)
    _npz(tmp_path / "f.npz", features_of(rng, scene))
    gt = -np.einsum("fji,fj->fi", scene.R, scene.t)
    idx = np.arange(0, 10, 2)
    np.savez(tmp_path / "gps.npz", frames=idx, xyz=gt[idx])
    ckdir = str(tmp_path / "ck")
    rc, (o,) = _run_cli(capsys, ["--device", "cpu", "--set", "map.max_frames=16", "slam",
                                str(tmp_path / "f.npz"), "--checkpoint", ckdir, "--gps",
                                str(tmp_path / "gps.npz")])
    assert o["n_frames"] == 10 and o["gps"]["n_gps"] == 5 and o["gps"]["rmse_final"] < 0.05
    saved = ck.load_map_arrays(ckdir)
    c = -np.einsum("fji,fj->fi", saved["R"][:10], saved["t"][:10])
    assert np.sqrt(np.mean(np.sum((c - gt) ** 2, -1))) < 0.1
