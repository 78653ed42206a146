"""The port's ``slam`` subcommand end to end (``main(argv)``, ``--device
cpu``) beside the JAX package's CLI on the same .npz feature dump, with
``--trajectory``: the host engine (``auto`` on the CPU) and ``--engine
device``, ``scan`` and ``chunked``. The packages' RANSAC draws its samples
with different generators, so the runs are compared by outcome: the same
JSON keys (the port's adds ``engine``, the engine that ran), equal frame,
loop-closure and PGO counts, the point count within 5% of the JAX CLI's,
unit quaternions in both TUM files, each trajectory within 0.1 of the
scene's (ATE), and the two within 0.05 of each other.
"""

import numpy as np
import pytest
import torch
from test_pipeline import synthetic_features
from test_torch_cli import run

from fastmatch_tpu import cli as jcli
from synth import SyntheticScene

from fastmatch_tpu_torch import cli
from fastmatch_tpu_torch.datasets import load_tum_trajectory
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)


def _feature_npz(path, n_frames=8):
    rng = np.random.default_rng(1)
    scene = SyntheticScene(rng, n_points=300, n_frames=n_frames)
    feats = synthetic_features(rng, scene, noise_px=0.3)
    arrays = {"n_frames": n_frames, "image_size": np.array([640, 480])}
    for i, (xy, desc, mask) in enumerate(feats):
        arrays.update({f"xy_{i}": xy, f"desc_{i}": desc, f"mask_{i}": mask})
    np.savez(path, **arrays)
    return scene


CFG = ["--set", "ba.max_iters=6", "--set", "ba.pcg_iters=20", "--set", "map.max_frames=16",
       "--set", "map.max_points=2048", "--set", "map.max_obs=16384"]


def _compare(tmp_path, engine_args, engine):
    scene = _feature_npz(tmp_path / "f.npz")
    argv = [*CFG, "slam", str(tmp_path / "f.npz")]
    [rep], _ = run(cli.main, ["--device", "cpu", *argv, *engine_args, "--trajectory",
                              str(tmp_path / "t.txt")])
    [ref], _ = run(jcli.main, [*argv, *(engine_args or ["--engine", "host"]), "--trajectory",
                               str(tmp_path / "j.txt")])
    assert set(rep) == set(ref) | {"engine"}
    assert set(ref) == {"n_frames", "n_points", "loop_closures", "pgo_runs", "out"}
    assert rep["n_frames"] == 8 and rep["engine"] == engine
    for k in ("n_frames", "loop_closures", "pgo_runs"):
        assert rep[k] == ref[k], k
    assert abs(rep["n_points"] - ref["n_points"]) <= 0.05 * ref["n_points"]
    gt = -np.einsum("fji,fj->fi", scene.R, scene.t)
    centers = {}
    for who in ("t", "j"):
        _, centers[who], quats = load_tum_trajectory(str(tmp_path / f"{who}.txt"))
        assert centers[who].shape == (8, 3)
        assert np.allclose(np.linalg.norm(quats, axis=1), 1, atol=1e-5)
        assert float(ate_rmse(centers[who], gt)) < 0.1
    assert float(ate_rmse(centers["t"], centers["j"])) < 0.05


def test_slam_from_features(tmp_path):
    """``--engine auto`` (the default) runs the host engine on the CPU."""
    _compare(tmp_path, [], "host")


@pytest.mark.parametrize("engine", ["device", "scan", "chunked"])
def test_slam_engines_from_features(tmp_path, engine):
    _compare(tmp_path, ["--engine", engine, *(["--chunk", "3"] if engine == "chunked" else [])],
             engine)
