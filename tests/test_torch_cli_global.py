"""The port's CLI options of global SfM, self-calibration and figures
(``main(argv)``, ``--device cpu``): ``reconstruct --mode global --selfcal 2``
on a .npz feature dump of tests/test_global_sfm.py's 10-frame fixture
(JSON keys as the JAX CLI's, every frame, the trajectory within ATE 0.05 of
the scene's, the selfcal summary's focal near the true 500), ``slam
--plot``, ``evaluate --plot-dir``, and the ``dist/`` options still raising
with their ROADMAP item. The JAX package's global SfM takes ~90 s on this
fixture (tests/global_sfm_fixtures.py), so the JSON is held to the keys the
JAX CLI prints (fastmatch_tpu/cli.py ``cmd_reconstruct``) rather than a live
run."""

import json
import os

import numpy as np
import pytest
import torch

import global_sfm_fixtures as fx
from test_torch_cli import run

from fastmatch_tpu_torch import cli
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)

CFG = ["--set", "ba.max_iters=15", "--set", "ba.pcg_iters=30", "--set", "map.max_frames=16",
       "--set", "map.max_points=2048", "--set", "map.max_obs=16384"]


def _fixture_npz(path):
    scene, feats = fx.scene_and_features()
    arrays = {"n_frames": len(feats), "image_size": np.array([640, 480])}
    for i, (xy, desc, mask) in enumerate(feats):
        arrays.update({f"xy_{i}": xy, f"desc_{i}": desc, f"mask_{i}": mask})
    np.savez(path, **arrays)
    return scene


def test_reconstruct_global_selfcal(tmp_path):
    scene = _fixture_npz(tmp_path / "f.npz")
    [rep], _ = run(cli.main, ["--device", "cpu", *CFG, "reconstruct", str(tmp_path / "f.npz"),
                              "--mode", "global", "--window", str(fx.WINDOW),
                              "--selfcal", "2", "--out", str(tmp_path / "m.npz"),
                              "--metrics", str(tmp_path / "m.jsonl")])
    assert set(rep) == {"n_frames", "n_points", "n_obs", "out", "selfcal"}
    assert set(rep["selfcal"]) == {"fx", "fy", "cx", "cy", "dist", "mean_px2"}
    assert rep["n_frames"] == 10 and rep["n_points"] > 100 and rep["n_obs"] > 500
    sc = rep["selfcal"]
    assert abs(sc["fx"] - 500.0) < 15.0 and abs(sc["fy"] - 500.0) < 15.0, sc
    assert len(sc["dist"]) == 5 and sc["mean_px2"] < 1.0, sc
    centers = np.load(tmp_path / "m.npz")["centers"]
    assert float(ate_rmse(centers, fx.gt_centers(scene))) < 0.05
    events = [json.loads(line)["event"] for line in open(tmp_path / "m.jsonl")]
    for e in ("view_graph", "global_ba", "self_calibrate", "stage_seconds"):
        assert e in events, e


def test_slam_plot(tmp_path):
    pytest.importorskip("matplotlib", reason="matplotlib is not installed")
    _fixture_npz(tmp_path / "f.npz")
    [rep], _ = run(cli.main, ["--device", "cpu", *CFG, "slam", str(tmp_path / "f.npz"),
                              "--engine", "host", "--plot", str(tmp_path / "traj.png")])
    assert rep["n_frames"] == 10
    assert os.path.getsize(tmp_path / "traj.png") > 2000


def test_evaluate_plot_dir(tmp_path):
    pytest.importorskip("matplotlib", reason="matplotlib is not installed")
    d = tmp_path / "plots"
    argv = ["--device", "cpu", "--set", "sift.capacity=256", "evaluate", "synth",
            "--n-synth", "1", "--resize", "160"]
    lines, _ = run(cli.main, [*argv, "--plot-dir", str(d)])
    plain, _ = run(cli.main, argv)
    assert lines == plain and "aggregate" in lines[-1]
    files = sorted(os.listdir(d))
    assert "summary.png" in files and len(files) == 2


@pytest.mark.parametrize("argv", [
    ["slam", "d", "--mesh", "bank=4"],
    ["slam", "d", "--resume", "ck"],
    ["bench"],
])
def test_dist_options_still_raise(argv):
    """``bench`` still waits for its ROADMAP item; ``slam --mesh`` and
    ``--resume`` are ported (dist/pipeline.py) and raise on their input,
    which "d" is not."""
    if argv == ["bench"]:
        with pytest.raises(NotImplementedError,
                           match="not yet ported .ROADMAP Queue 1 item 2"):
            cli.main(["--device", "cpu", *argv])
    else:
        with pytest.raises(ValueError, match="need at least 2 frames"):
            cli.main(["--device", "cpu", *argv])
