"""The port CLI's flow, vo (host, scan, --right), stereo, densify and
vialign commands beside the JAX CLI's JSON on the same files
(``vo_fixtures.cli_cases``: .pgm frames and .npz inputs written by the
test). The JAX CLI's JSON is ``vo_fixtures.JAX["cli"]`` (``slow``:
``test_jax_cli_live`` re-derives it).

Tolerances: corner and track counts equal or within 2% (the tracks of the
two packages agree to 1e-3 px, tests/test_torch_klt.py); VO frames and PnP
failures equal, keyframes within 1, points and observations within 10%
(RANSAC draws differ); stereo valid fraction within 0.02, median depth
within 1% and PLY points within 4%, densify's pairs equal and points within
6%: next to flat background the port validates ~1% more pixels
(tests/test_torch_stereo.py says why; measured 0.7017 against 0.6907); vialign's scale and gravity within
1e-4 of the vector's size.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import vo_fixtures as fx
from vo_fixtures import JAX

from fastmatch_tpu_torch import cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return fx.cli_cases(tmp_path_factory.mktemp("cli_vo"))


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", *argv])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    out.pop("out", None)
    out.pop("ply", None)
    return out


def _within(a, b, rel):
    return abs(a - b) <= rel * abs(b)


@pytest.mark.parametrize("name", ["flow", "flow_verify"])
def test_flow(cases, name):
    t, j = _run(cases[name]), JAX["cli"][name]
    assert t["n_corners"] == j["n_corners"]
    assert _within(t["n_tracked"], j["n_tracked"], 0.02)
    assert _within(t["n_final"], j["n_final"], 0.02)
    assert t["mean_residual"] == pytest.approx(j["mean_residual"], abs=1e-3)
    if name == "flow_verify":
        assert t["verified"] == j["verified"]
        assert _within(t["model_inliers"], j["model_inliers"], 0.05)
    else:
        data = np.load(cases[name][-1])
        assert data["xy_a"].shape == (t["n_final"], 2) == data["xy_b"].shape


@pytest.mark.parametrize("name", ["vo_host", "vo_scan", "vo_right"])
def test_vo(cases, name):
    t, j = _run(cases[name]), JAX["cli"][name]
    assert t["n_frames"] == j["n_frames"]
    assert t["pnp_failures"] == j["pnp_failures"]
    assert abs(t["n_keyframes"] - j["n_keyframes"]) <= 1
    assert _within(t["n_points"], j["n_points"], 0.1)
    assert _within(t["n_obs"], j["n_obs"], 0.1)
    out = np.load(cases[name][cases[name].index("--out") + 1])
    assert out["centers"].shape == (t["n_frames"], 3)
    if name == "vo_host":
        kitti = cases[name][-1]
        assert len(open(kitti).read().splitlines()) == t["n_frames"]


def test_vo_right_with_scan_engine_raises(cases):
    argv = cases["vo_right"] + ["--engine", "scan"]
    with pytest.raises(ValueError, match="--right"):
        _run(argv)


@pytest.mark.parametrize("name", ["stereo", "stereo_pose"])
def test_stereo(cases, name):
    t, j = _run(cases[name]), JAX["cli"][name]
    assert t["valid_frac"] == pytest.approx(j["valid_frac"], abs=0.02)
    assert t["median_depth"] == pytest.approx(j["median_depth"], rel=0.01)
    if name == "stereo":
        assert _within(t["n_points"], j["n_points"], 0.04)
        data = np.load(cases[name][cases[name].index("--out") + 1])
        assert data["disparity"].shape == data["valid"].shape == data["depth"].shape


def test_densify(cases):
    t, j = _run(cases["densify"]), JAX["cli"]["densify"]
    assert t["pairs_used"] == j["pairs_used"] and t["pairs_considered"] == j["pairs_considered"]
    assert _within(t["n_points"], j["n_points"], 0.06)
    assert t["median_depth"] == pytest.approx(j["median_depth"], rel=1e-6)


def test_vialign(cases):
    t, j = _run(cases["vialign"]), JAX["cli"]["vialign"]
    assert t["scale"] == pytest.approx(j["scale"], rel=1e-4)
    assert t["scale"] == pytest.approx(2.2, rel=0.02)
    np.testing.assert_allclose(t["gravity"], j["gravity"], rtol=0, atol=1e-4 * 9.81)
    m = np.load(cases["vialign"][-1])
    assert set(m.files) == {"R", "t", "centers", "points"}


@pytest.mark.parametrize("argv", [["flow", "a.pgm", "b.pgm"], ["vo", "d"],
                                  ["stereo", "l.pgm", "r.pgm", "--baseline", "0.1"],
                                  ["densify", "d", "--traj", "t.npz"],
                                  ["vialign", "--traj", "t.npz", "--imu", "i.npz", "--out",
                                   "o.npz"]])
def test_commands_need_cuda_unless_cpu(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


@pytest.mark.slow
def test_jax_cli_live(tmp_path):
    """The JAX CLI on these inputs still prints ``JAX["cli"]``."""
    from fastmatch_tpu.cli import main

    for name, argv in fx.cli_cases(tmp_path).items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        got = json.loads(buf.getvalue().strip().splitlines()[-1])
        got.pop("out", None)
        got.pop("ply", None)
        assert got == JAX["cli"][name], name
