"""``slam --mesh`` in the port's CLI (``python -m fastmatch_tpu_torch.cli``)
at world size 1 — the configuration of one card — on
tests/test_dist_pipeline.py's 26-frame CircleScene features (.npz), driven
in-process with ``--device cpu`` (a world-size-1 gloo group):

- ``--mesh bank=1 --checkpoint DIR --checkpoint-interval 10`` maps every
  frame with loops and PGO, writes the map and the tracker snapshots, and
  its JSON line has the JAX CLI's keys;
- ``--resume DIR`` on features whose first 15 frames are destroyed ends
  with the uninterrupted run's camera centres bit for bit;
- ``--no-overlap`` gives the same centres bit for bit;
- two gloo ranks (processes) running ``--mesh bank=2`` on 12 frames print
  the same figures, and rank 0 alone writes the map;
- a mesh larger than the world, a bad ``--mesh`` spec, and the mesh
  options without ``--mesh`` are refused.

The runs are made once a session (``dist_ranks.once``), in the process
that gets there first; the group is destroyed after them.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dist_fixtures as fx
import dist_ranks

from fastmatch_tpu_torch import cli

torch.set_num_threads(1)

SETS = ["--set", "ba.interval=5", "--set", "ba.max_iters=8", "--set", "ba.pcg_iters=30",
        "--set", "map.max_frames=32", "--set", "map.max_points=4096",
        "--set", "map.max_obs=32768"]
SLAM = ["--window", "6", "--loop-gap", "10", "--loop-min-votes", "20"]


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--device", "cpu", *SETS, *argv])
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def _npz(path, feats):
    data = {"n_frames": np.int64(len(feats)), "image_size": np.array([640, 480])}
    for i, (xy, d, m) in enumerate(feats):
        data[f"xy_{i}"], data[f"desc_{i}"], data[f"mask_{i}"] = xy, d, m
    np.savez(path, **data)
    return str(path)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory, monkeypatch_module):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch_module.delenv(k, raising=False)
    tmp = tmp_path_factory.mktemp("cli_dist")
    return dist_ranks.once(request, tmp_path_factory, "torch_cli_dist", lambda: _compute(tmp))


def _compute(tmp):
    scene, feats = fx.scene_and_features()
    wrecked = list(feats)
    for k in range(15):
        xy, d, m = wrecked[k]
        wrecked[k] = (xy, np.zeros_like(d), np.zeros_like(m))
    full_npz, wrecked_npz = _npz(tmp / "f.npz", feats), _npz(tmp / "w.npz", wrecked)
    ck = str(tmp / "ck")
    focal = ["--focal", str(scene.K[0, 0])]
    # Two gloo ranks run the same command on the first 12 frames meanwhile.
    short_npz = _npz(tmp / "s.npz", feats[:12])
    two = dist_ranks.Ranks(dist_ranks.cli_case, 2, [
        "--device", "cpu", *SETS, "slam", short_npz, *focal, *SLAM, "--mesh", "bank=2",
        "--out", str(tmp / "two.npz")])
    try:
        got = {
            "full": _run(["slam", full_npz, *focal, *SLAM, "--mesh", "bank=1", "--checkpoint",
                          ck, "--checkpoint-interval", "10", "--out", str(tmp / "full.npz")]),
            "resumed": _run(["slam", wrecked_npz, *focal, *SLAM, "--mesh", "bank=1", "--resume",
                             ck, "--out", str(tmp / "resumed.npz")]),
            "serial": _run(["slam", full_npz, *focal, *SLAM, "--mesh", "data=1,bank=1",
                            "--no-overlap", "--out", str(tmp / "serial.npz")]),
        }
        with pytest.raises(ValueError, match="mesh 1x2 != 1 devices"):
            _run(["slam", full_npz, *focal, "--mesh", "bank=2"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    got["two"] = two.results()
    maps = {k: dict(np.load(tmp / f"{k}.npz")) for k in got}
    return dict(json=got, maps=maps, ck=ck, npz=full_npz, scene=scene)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_slam_mesh_maps_every_frame(runs):
    line = runs["json"]["full"][-1]
    assert set(line) == {"n_frames", "n_points", "loop_closures", "pgo_runs", "engine", "out"}
    assert line["engine"] == "mesh" and line["n_frames"] == 26
    assert line["loop_closures"] >= 1 and line["pgo_runs"] >= 1
    centers = runs["maps"]["full"]["centers"]
    assert centers.shape == (26, 3)
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    assert float(ate_rmse(centers, fx.gt_centers(runs["scene"], range(26)))) < 0.25


def test_checkpoint_interval_and_resume(runs):
    import os

    assert os.path.exists(os.path.join(runs["ck"], "track.pt"))
    assert os.path.exists(os.path.join(runs["ck"], "map.pt"))
    full, resumed = runs["maps"]["full"], runs["maps"]["resumed"]
    for k in ("centers", "R", "t", "points"):
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)
    assert runs["json"]["resumed"][-1]["n_frames"] == 26


def test_no_overlap_equals_overlap(runs):
    for k in ("centers", "R", "t", "points"):
        np.testing.assert_array_equal(runs["maps"]["serial"][k], runs["maps"]["full"][k])


def test_slam_mesh_on_two_ranks(runs):
    """``slam --mesh bank=2`` in two processes: both print the same
    figures, rank 0 writes the map (rank 1 reports no ``out``)."""
    (a,), (b,) = runs["json"]["two"]
    assert a["out"].endswith("two.npz") and b["out"] is None
    assert {**a, "out": None} == b and a["engine"] == "mesh" and a["n_frames"] == 12
    assert runs["maps"]["two"]["centers"].shape == (12, 3)


@pytest.mark.parametrize("argv", [["--mesh", "bank=x"], ["--mesh", "rows=2"],
                                  ["--no-overlap"], ["--resume", "ck"],
                                  ["--checkpoint-interval", "5"]])
def test_mesh_options_refused(runs, argv):
    with pytest.raises(SystemExit):
        _run(["slam", runs["npz"], "--focal", "500", *argv])
