"""The port's ``reconstruct --camera-model fisheye`` end to end
(``main(argv)``, ``--device cpu``) beside the JAX package's CLI on the same
.npz feature dump, whose coefficients make the equidistant model agree
with the pinhole projection that made the features (r = tan(theta) to its
theta^9 term: under 0.05 px at these fields of view). Compared by outcome,
as in tests/test_torch_cli_reconstruct.py: the same JSON keys and frame
count, point and observation counts within 5% of the JAX CLI's, each
trajectory within the reference's ATE gate (0.35), and the two
trajectories within 0.05 of each other.
"""

import numpy as np
import torch
from test_pipeline import synthetic_features
from test_torch_cli import run
from test_torch_cli_reconstruct import SMALL, beside, centers

from fastmatch_tpu import cli as jcli
from synth import SyntheticScene

from fastmatch_tpu_torch import cli

torch.set_num_threads(1)

# tan(theta) = theta (1 + th^2/3 + 2 th^4/15 + 17 th^6/315 + 62 th^8/2835 + ...)
TAN_SERIES = "0.3333333,0.1333333,0.0539683,0.0218695"


def test_reconstruct_fisheye_beside_jax(tmp_path):
    rng = np.random.default_rng(6)
    scene = SyntheticScene(rng, n_points=300, n_frames=5, image_size=(480, 360))
    arrays = {"n_frames": 5, "image_size": np.array([480, 360])}
    for i, (xy, desc, mask) in enumerate(synthetic_features(rng, scene, noise_px=0.3)):
        arrays.update({f"xy_{i}": xy, f"desc_{i}": desc, f"mask_{i}": mask})
    np.savez(tmp_path / "f.npz", **arrays)
    out, jout = tmp_path / "rec.npz", tmp_path / "jrec.npz"
    argv = [*SMALL, "reconstruct", str(tmp_path / "f.npz"), "--camera-model", "fisheye",
            "--dist", TAN_SERIES]
    [rep], _ = run(cli.main, ["--device", "cpu", *argv, "--out", str(out)])
    [ref], _ = run(jcli.main, [*argv, "--out", str(jout)])
    assert rep["n_frames"] == 5
    beside(rep, ref, out, jout, centers(scene.R, scene.t))
