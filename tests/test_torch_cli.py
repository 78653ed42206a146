"""The port's CLI (``python -m fastmatch_tpu_torch.cli``), driven in-process
through ``main(argv)`` with ``--device cpu``, beside the JAX package's CLI
(``fastmatch_tpu.cli.main``) on the same inputs: ``match`` on descriptor
dumps and on rendered images with ``--verify fundamental``; the CLI's own
glue for ``reconstruct`` and ``slam`` (decoding and resizing an image
directory, loading .npz features, the camera from ``--focal``,
``--camera-model`` and ``--dist`` with the principal point at w/2, h/2,
and the SLAM options), held exactly by stopping both CLIs where they hand
their inputs to the engine; a decode error; ``info`` and ``--config``/
``--set``; and every option and subcommand whose module is not ported
raising ``NotImplementedError`` with its ROADMAP item (the options ported
since, ``slam --mesh`` and its options among them, reaching their input
instead). (``reconstruct`` and
``evaluate traj`` end to end: tests/test_torch_cli_reconstruct.py; ``slam``
end to end: tests/test_torch_cli_slam.py; ``evaluate synth`` and a
VGG-layout directory: tests/test_torch_cli_eval.py.)

Outputs are compared as JSON: the same keys as the JAX CLI's, equal
counts where the computation is deterministic (matching on descriptor
dumps), and counts within 5% of the JAX CLI's where RANSAC's draws differ
between the packages (the fundamental-matrix verification).
"""

import contextlib
import importlib
import io
import json
import types

import numpy as np
import pytest
import torch

from fastmatch_tpu import cli as jcli
from synth import SyntheticScene, random_descriptors, render_scene_views

from fastmatch_tpu_torch import cli

torch.set_num_threads(1)


def run(main, argv):
    """(JSON lines printed, return value) of one in-process CLI call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rv = main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")], rv


def write_pgm(path, img):
    h, w = img.shape
    with open(path, "wb") as fh:
        fh.write(f"P5\n{w} {h}\n255\n".encode() + (img * 255).astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(4)
    scene = SyntheticScene(rng, n_points=60, n_frames=5, image_size=(480, 360))
    for i, img in enumerate(render_scene_views(scene, rng, image_size=(480, 360))):
        write_pgm(d / f"frame{i:03d}.pgm", img)
    return d, scene


def test_match_descriptor_dumps_beside_jax(tmp_path):
    rng = np.random.default_rng(0)
    base = random_descriptors(rng, 300)
    noisy = np.abs(base + 0.05 * rng.standard_normal(base.shape)).astype(np.float32)
    noisy /= np.linalg.norm(noisy, axis=1, keepdims=True)
    np.save(tmp_path / "a.npy", base)
    np.save(tmp_path / "b.npy", noisy[rng.permutation(300)])
    args = [str(tmp_path / "a.npy"), str(tmp_path / "b.npy")]
    [got], _ = run(cli.main, ["--device", "cpu", "match", *args, "--out", str(tmp_path / "t.npy")])
    [ref], _ = run(jcli.main, ["match", *args, "--out", str(tmp_path / "j.npy")])
    assert set(got) == set(ref) and got["n_matches"] == ref["n_matches"] > 250
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))
    with pytest.raises(ValueError, match="orb"):
        cli.main(["--device", "cpu", "match", *args, "--feature", "orb"])


def test_match_images_verified(rendered, tmp_path):
    """``match --verify fundamental`` on two rendered frames beside the JAX
    CLI: the same keys, ``verified`` alike, and the match and inlier counts
    within 5% of the JAX CLI's (its RANSAC draws its samples with another
    generator); the exported pairs agree on at least 90% of the JAX CLI's."""
    d, _ = rendered
    argv = ["--set", "sift.capacity=512", "match", str(d / "frame000.pgm"),
            str(d / "frame001.pgm"), "--verify", "fundamental"]
    [rep], _ = run(cli.main, ["--device", "cpu", *argv, "--out", str(tmp_path / "m.npz")])
    [ref], _ = run(jcli.main, [*argv, "--out", str(tmp_path / "j.npz")])
    assert set(rep) == set(ref) == {"n_matches", "out", "verified", "model_inliers"}
    assert rep["verified"] and ref["verified"]
    assert rep["model_inliers"] >= 15 and rep["n_matches"] >= 15
    for k in ("n_matches", "model_inliers"):
        assert abs(rep[k] - ref[k]) <= 0.05 * ref[k], (k, rep[k], ref[k])
    data, jdata = np.load(tmp_path / "m.npz"), np.load(tmp_path / "j.npz")
    assert data["pairs"].shape == (rep["n_matches"], 2)
    assert data["xy_a"].shape == data["xy_b"].shape == (rep["n_matches"], 2)
    shared = {tuple(p) for p in data["pairs"]} & {tuple(p) for p in jdata["pairs"]}
    assert len(shared) >= 0.9 * len(jdata["pairs"])


def test_decode_error_is_loud(rendered, tmp_path):
    d, _ = rendered
    for i in range(3):
        (tmp_path / f"frame{i:03d}.pgm").write_bytes((d / f"frame{i:03d}.pgm").read_bytes())
    (tmp_path / "frame001.pgm").write_bytes(b"truncated junk")
    with pytest.raises(IOError, match="frame001"):
        cli.main(["--device", "cpu", "--set", "sift.capacity=256", "reconstruct",
                  str(tmp_path)])


class _Handed(Exception):
    """Raised by a stand-in engine with the inputs the CLI handed it."""


def _stop_at_the_engine(monkeypatch):
    """Stand-ins for both packages' SIFT (records the frame it is given and
    returns no features) and for their ``reconstruct`` and ``slam`` (raise
    ``_Handed`` with their arguments). Returns the recorded frames by
    package."""
    # The modules, not the functions that the packages re-export under
    # the same names.
    jsift, jrec, jslam, tsift, trec, tslam = (importlib.import_module(f"{pkg}.{mod}") for pkg in (
        "fastmatch_tpu", "fastmatch_tpu_torch") for mod in (
        "features.sift", "pipeline.reconstruct", "pipeline.slam"))
    frames = {"jax": [], "torch": []}

    def jax_sift(im, cfg):
        frames["jax"].append(np.asarray(im))
        return (types.SimpleNamespace(xy=np.zeros((4, 2), np.float32)),
                types.SimpleNamespace(data=np.zeros((4, 128), np.float32),
                                      mask=np.zeros(4, bool)))

    def torch_sift(im, cfg, device=None):
        frames["torch"].append(im.numpy())
        return (types.SimpleNamespace(xy=torch.zeros((4, 2))),
                types.SimpleNamespace(data=torch.zeros((4, 128)),
                                      mask=torch.zeros(4, dtype=torch.bool)))

    def handed(*args, **kwargs):
        raise _Handed(*args)

    monkeypatch.setattr(jsift, "detect_and_describe", jax_sift)
    monkeypatch.setattr(tsift, "detect_and_describe", torch_sift)
    for mod, name in ((jrec, "reconstruct"), (trec, "reconstruct"), (jslam, "slam"),
                      (tslam, "slam")):
        monkeypatch.setattr(mod, name, handed)
    return frames


def _handed(main, argv):
    with pytest.raises(_Handed) as e:
        main(argv)
    return e.value.args


@pytest.fixture(scope="module")
def glue_inputs(tmp_path_factory):
    """A directory of three 8-bit PGM frames, the last at another size (the
    loader resizes it to the first's), and a .npz feature dump."""
    root = tmp_path_factory.mktemp("glue")
    rng = np.random.default_rng(5)
    d = root / "frames"
    d.mkdir()
    for i, (w, h) in enumerate([(96, 72), (96, 72), (120, 80)]):
        write_pgm(d / f"f{i}.pgm", rng.random((h, w)))
    arrays = {"n_frames": 3, "image_size": np.array([640, 480])}
    for i in range(3):
        arrays.update({f"xy_{i}": rng.random((8, 2), dtype=np.float32) * 400,
                       f"desc_{i}": rng.random((8, 128), dtype=np.float32),
                       f"mask_{i}": rng.random(8) < 0.7})
    np.savez(root / "f.npz", **arrays)
    return {"dir": str(d), "npz": str(root / "f.npz")}


@pytest.mark.parametrize("command,source,options", [
    ("reconstruct", "dir", []),
    ("reconstruct", "dir", ["--focal", "420", "--camera-model", "fisheye",
                            "--dist", "0.01,-0.002,0.001,0.0005"]),
    ("reconstruct", "npz", ["--focal", "610.5", "--dist=-0.28,0.07,0.001,0.0002,-0.0003"]),
    ("slam", "npz", ["--camera-model", "fisheye", "--dist", "0.02", "--window", "5",
                     "--loop-gap", "7", "--loop-min-votes", "9"]),
    ("slam", "dir", ["--focal", "450", "--dist=-0.1"]),
])
def test_inputs_handed_to_the_engine_as_jax(monkeypatch, glue_inputs, command, source,
                                           options):
    """What the two CLIs hand to ``reconstruct`` or ``slam`` for the same
    arguments: the same decoded (and resized) frames, bit for bit, given to
    SIFT in the same order; the same features from a .npz; the same camera
    model with equal fields; and for ``slam`` the same SlamConfig
    options."""
    frames = _stop_at_the_engine(monkeypatch)
    argv = [command, glue_inputs[source], *options]
    got = _handed(cli.main, ["--device", "cpu", *argv])
    ref = _handed(jcli.main, argv)
    assert len(frames["torch"]) == len(frames["jax"]) == (3 if source == "dir" else 0)
    for a, b in zip(frames["torch"], frames["jax"]):
        assert a.dtype == b.dtype and a.shape == b.shape == (72, 96)
        np.testing.assert_array_equal(a, b)
    (feats, cam), (jfeats, jcam) = got[:2], ref[:2]
    assert len(feats) == len(jfeats) == 3
    for f, jf in zip(feats, jfeats):
        for a, b in zip(f, jf):
            np.testing.assert_array_equal(a, b)
    assert (type(cam).__name__, cam.model) == (type(jcam).__name__, jcam.model)
    assert cam._fields == jcam._fields
    for field in cam._fields:
        assert float(getattr(cam, field)) == float(getattr(jcam, field)), field
    size = (96, 72) if source == "dir" else (640, 480)
    assert (float(cam.cx), float(cam.cy)) == (size[0] / 2, size[1] / 2)
    if command == "slam":
        scfg, jscfg = got[3], ref[3]
        for field in ("window", "loop_gap", "loop_min_votes"):
            assert getattr(scfg, field) == getattr(jscfg, field), field


def test_info_and_config(tmp_path):
    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        cli.main(["info"])
    assert lines.getvalue().startswith(f"torch {torch.__version__}")
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"matching": {"ratio": 0.7}, "ba": {"interval": 3}}))
    args = type("A", (), {"config": str(cfg), "set": ["sift.capacity=256"]})
    c = cli._load_config(args)
    assert (c.matching.ratio, c.ba.interval, c.sift.capacity) == (0.7, 3, 256)
    args.set = ["ba.nope=1"]
    with pytest.raises(KeyError, match="nope"):
        cli._load_config(args)


# item: the ROADMAP Queue 1 item an option waited for, or None for an
# option that is ported now (--selfcal, --mode global, --plot and --plot-dir
# since global SfM, self-calibration and utils/viz.py landed). An option of
# an item in DONE_ITEMS or None passes the not-ported gate and reaches the
# input, which "d" is not. Item 1 (dist/: --mesh, --no-overlap, --resume,
# --checkpoint-interval) is done since dist/pipeline.py landed.
DONE_ITEMS = (1,)
@pytest.mark.parametrize("argv,item", [
    (["slam", "d", "--no-overlap"], 1),
    (["reconstruct", "d", "--selfcal", "2"], None),
    (["slam", "d", "--selfcal", "2"], None),
    (["reconstruct", "d", "--selfcal", "1", "--checkpoint", "ck"], None),
    (["reconstruct", "d", "--mode", "global"], None),
    (["slam", "d", "--mesh", "bank=4"], 1),
    (["slam", "d", "--resume", "ck"], 1),
    (["slam", "d", "--plot", "p.png"], None),
    (["slam", "d", "--checkpoint-interval", "5"], 1),
    (["evaluate", "synth", "--n-synth", "0", "--plot-dir", "p"], None),
    (["slam", "d", "--mesh", "bank=4", "--checkpoint", "ck"], 1),
])
def test_unported_options_raise(argv, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if item is not None and item not in DONE_ITEMS:
        with pytest.raises(NotImplementedError,
                           match=f"not yet ported .ROADMAP Queue 1 item {item}"):
            cli.main(["--device", "cpu", *argv])
    elif argv[0] == "evaluate":
        lines, _ = run(cli.main, ["--device", "cpu", *argv])
        assert lines[-1]["aggregate"]["pairs"] == 0 and not (tmp_path / "p").exists()
    else:
        with pytest.raises(ValueError, match="need at least 2 frames"):
            cli.main(["--device", "cpu", *argv])


def test_bench_is_not_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(["bench"])
