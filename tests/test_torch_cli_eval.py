"""The port's ``evaluate`` subcommand (``main(argv)``, ``--device cpu``)
beside the JAX package's CLI on the same inputs: ``evaluate synth`` (one
synthetic warped pair) and an Oxford-VGG-layout directory (``img1.pgm``,
``img2.pgm``, ``H1to2p``) written from synthetic pairs, since no VGG data
is in the repository. SIFT, matching and scoring make the same decisions
on both sides here: the per-pair counts are equal and precision and
recall agree to 1e-6. Also the datasets helpers (``load_vgg_dataset``'s
discovery and its error, ``load_tum_trajectory``) and the native image
loader against numpy.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from fastmatch_tpu import cli as jcli
from fastmatch_tpu import datasets as jdata

from fastmatch_tpu_torch import cli, datasets
from fastmatch_tpu_torch.utils import imageio

torch.set_num_threads(1)

CAP = ["--set", "sift.capacity=512"]


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        if "aggregate" in g:
            g, r = g["aggregate"], r["aggregate"]
        for k, v in r.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=1e-6)
            else:
                assert g[k] == v, k


def test_evaluate_synth_beside_jax():
    argv = [*CAP, "evaluate", "synth", "--n-synth", "1"]
    got = run(cli.main, ["--device", "cpu", *argv])
    _same(got, run(jcli.main, argv))
    assert got[-1]["aggregate"]["mean_precision"] > 0.9


def test_evaluate_vgg_layout_beside_jax(tmp_path):
    for k, seed in ((2, 0), (3, 1)):
        pair = datasets.synthesize_warped_pair(seed)
        a = (pair.image_a * 255).astype(np.uint8)
        (tmp_path / "img1.pgm").write_bytes(b"P5\n256 256\n255\n" + a.tobytes())
        b = (pair.image_b * 255).astype(np.uint8)
        (tmp_path / f"img{k}.pgm").write_bytes(b"P5\n256 256\n255\n" + b.tobytes())
        np.savetxt(tmp_path / f"H1to{k}p", pair.H_ab)
    # img1 was written twice: keep the seed-0 texture for both pairs.
    pair0 = datasets.synthesize_warped_pair(0)
    (tmp_path / "img1.pgm").write_bytes(
        b"P5\n256 256\n255\n" + (pair0.image_a * 255).astype(np.uint8).tobytes())
    pairs = datasets.load_vgg_dataset(str(tmp_path))
    jpairs = jdata.load_vgg_dataset(str(tmp_path))
    assert [p.name for p in pairs] == [p.name for p in jpairs] == [
        f"{tmp_path.name}:1to2", f"{tmp_path.name}:1to3"]
    argv = [*CAP, "evaluate", str(tmp_path)]
    got = run(cli.main, ["--device", "cpu", *argv])
    _same(got, run(jcli.main, argv))
    assert got[0]["n_predicted"] > 20
    with pytest.raises(FileNotFoundError):
        datasets.load_vgg_dataset(str(tmp_path / "missing"))


def test_synthetic_pair_and_tum_beside_jax(tmp_path):
    p, jp = datasets.synthesize_warped_pair(3), jdata.synthesize_warped_pair(3)
    np.testing.assert_array_equal(p.image_a, jp.image_a)
    np.testing.assert_array_equal(p.image_b, jp.image_b)
    np.testing.assert_array_equal(p.H_ab, jp.H_ab)
    f = tmp_path / "t.txt"
    f.write_text("# ts tx ty tz qx qy qz qw\n0 1 2 3 0 0 0 1\n1.5 4 5 6 0 0 1 0\n")
    for a, b in zip(datasets.load_tum_trajectory(str(f)), jdata.load_tum_trajectory(str(f))):
        np.testing.assert_array_equal(a, b)
    f.write_text("0 1 2 3\n")
    with pytest.raises(ValueError, match="8 columns"):
        datasets.load_tum_trajectory(str(f))


def test_native_loader_and_resize(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    path = tmp_path / "a.pgm"
    path.write_bytes(b"P5\n64 48\n255\n" + img.tobytes())
    got = imageio.load_gray(str(path))
    np.testing.assert_allclose(got, img / 255.0, atol=1e-6)
    small = imageio.load_gray(str(path), size=(32, 24))
    np.testing.assert_allclose(small, datasets._resize_np(got, 32, 24), atol=1e-5)
    with imageio.FrameLoader([str(path)] * 3, size=(32, 24)) as frames:
        seen = [(i, x.shape) for i, x in frames]
    assert seen == [(i, (24, 32)) for i in range(3)]
    with pytest.raises(IOError, match="fm_load_gray"):
        imageio.load_gray(str(tmp_path / "missing.pgm"))
