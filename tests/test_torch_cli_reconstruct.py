"""The port's ``reconstruct`` and ``evaluate traj`` subcommands end to end
(``main(argv)``, ``--device cpu``) beside the JAX package's CLI on the same
inputs: a rendered directory of 8-bit PGM frames (the native decode, SIFT,
the pipeline) with ``--metrics``, then ``evaluate traj`` of each CLI's
output against the scene's TUM trajectory. (``--camera-model fisheye``:
tests/test_torch_cli_fisheye.py.)

The packages' RANSAC draws its samples with different generators, so the
runs are compared by outcome: the same JSON keys and frame count, point and
observation counts within 5% of the JAX CLI's, each trajectory within the
reference's ATE gate (0.35), and the two trajectories within 0.05 of each
other (the ATE of one against the other).
"""

import json

import numpy as np
import pytest
import torch
from test_torch_cli import run, write_pgm

from fastmatch_tpu import cli as jcli
from synth import SyntheticScene, render_scene_views

from fastmatch_tpu_torch import cli
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)

SMALL = ["--set", "sift.capacity=512", "--set", "ba.interval=2", "--set",
         "ransac.min_inliers=10", "--set", "ransac.thr_px=3.0", "--set", "matching.ratio=0.85"]


def write_tum(path, R, t):
    """Ground-truth centres as a TUM file (identity quaternions: the
    evaluation reads the centres)."""
    c = -np.einsum("fji,fj->fi", R, t)
    with open(path, "w") as fh:
        for f, x in enumerate(c):
            fh.write(f"{f} {x[0]:.7f} {x[1]:.7f} {x[2]:.7f} 0 0 0 1\n")


def centers(R, t):
    return -np.einsum("fji,fj->fi", R, t)


def beside(got, ref, out, jout, gt):
    """The outcome comparison of two reconstruct runs (module docstring)."""
    assert set(got) == set(ref) == {"n_frames", "n_points", "n_obs", "out"}
    assert got["n_frames"] == ref["n_frames"]
    for k in ("n_points", "n_obs"):
        assert abs(got[k] - ref[k]) <= 0.05 * ref[k], (k, got[k], ref[k])
    c, jc = np.load(out)["centers"], np.load(jout)["centers"]
    assert float(ate_rmse(c, gt)) < 0.35 and float(ate_rmse(jc, gt)) < 0.35
    assert float(ate_rmse(c, jc)) < 0.05


def test_reconstruct_images_and_evaluate_traj(tmp_path):
    rng = np.random.default_rng(4)
    scene = SyntheticScene(rng, n_points=60, n_frames=5, image_size=(480, 360))
    d = tmp_path / "frames"
    d.mkdir()
    for i, img in enumerate(render_scene_views(scene, rng, image_size=(480, 360))):
        write_pgm(d / f"frame{i:03d}.pgm", img)
    gt = str(tmp_path / "gt_tum.txt")
    write_tum(gt, scene.R, scene.t)
    out, jout, metrics = tmp_path / "rec.npz", tmp_path / "jrec.npz", tmp_path / "m.jsonl"
    argv = [*SMALL, "reconstruct", str(d), "--focal", "500.0"]
    [rep], rv = run(cli.main, ["--device", "cpu", *argv, "--out", str(out),
                               "--metrics", str(metrics)])
    [ref], _ = run(jcli.main, [*argv, "--out", str(jout)])
    assert rv is None
    assert rep["n_frames"] == 5 and rep["n_points"] > 30
    beside(rep, ref, out, jout, centers(scene.R, scene.t))
    events = [json.loads(line) for line in open(metrics)]
    stages = [e for e in events if e["event"] == "stage_seconds"]
    assert len(stages) == 1 and {"decode", "sift", "match", "ba"} <= set(stages[0])
    assert sum(e["event"] == "ba" for e in events) >= 2
    for est in (out, jout):
        argv = ["evaluate", "traj", "--est", str(est), "--gt", gt]
        [got], _ = run(cli.main, ["--device", "cpu", *argv])
        [want], _ = run(jcli.main, argv)
        assert set(got) == set(want) and got["n_frames"] == want["n_frames"] == 5
        for k in ("ate_rmse", "rpe_rmse", "rpe_median"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
        assert got["ate_rmse"] < 0.35
    with pytest.raises(ValueError, match="rpe delta"):
        cli.main(["--device", "cpu", *argv, "--rpe-delta", "5"])
