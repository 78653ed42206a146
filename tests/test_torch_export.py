"""The port's map export (fastmatch_tpu_torch/utils/export.py) against the
JAX package's: the bytes of every file written from one reconstruction are
identical, the readers round-trip, and the CLI's --export-ply,
--export-colmap and --export-kitti write what the JAX CLI's write.

One exception: with the fisheye model, points3D.txt's ERROR column (a mean
reprojection error in pixels, printed to 6 digits) is held within 1e-5
relative, not byte for byte: the float32 arctan of the fisheye projection
differs by an ulp between the frameworks (measured: 3 of 60 lines differ in
the 6th digit). Every other byte of that file is compared.
"""

import types

import numpy as np
import pytest

from fastmatch_tpu import cli as jcli
from fastmatch_tpu.core.camera import Fisheye as JFisheye
from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.utils import export as jexp
from synth import SyntheticScene

from fastmatch_tpu_torch import cli as tcli
from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Fisheye, Pinhole
from fastmatch_tpu_torch.core.camera import normalize_np
from fastmatch_tpu_torch.pipeline.config import MapConfig, PipelineConfig
from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction
from fastmatch_tpu_torch.utils import export as texp


def _rec(dist=(), model="pinhole"):
    """A map of a synthetic scene: 5 posed frames, their visible points, and
    the normalized observations of each."""
    rng = np.random.default_rng(2)
    scene = SyntheticScene(rng, n_points=60, n_frames=5, span=0.8)
    cam = (Fisheye if model == "fisheye" else Pinhole).from_K(scene.K, dist)
    rec = Reconstruction(cfg=PipelineConfig(map=MapConfig(max_frames=8, max_points=128,
                                                          max_obs=1024)), camera=cam)
    F = scene.R.shape[0]
    rec.R[:F], rec.t[:F] = scene.R, scene.t
    rec.pose_mask[:F] = True
    rec.n_frames = F
    vis = scene.visible.any(axis=0)
    ids = rec.add_points(scene.points[vis].astype(np.float32),
                         np.zeros((int(vis.sum()), 128), np.float32))
    remap = -np.ones(scene.points.shape[0], np.int64)
    remap[np.nonzero(vis)[0]] = ids
    for f in range(F):
        p = np.nonzero(scene.visible[f])[0]
        rec.add_observations(f, remap[p].astype(np.int32),
                             normalize_np(scene.pixels[f, p] + 0.3, cam))
    jcam = (JFisheye if model == "fisheye" else JPinhole).from_K(scene.K, dist)
    return rec, cam, jcam


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("dist,model", [((), "pinhole"), ((-0.2, 0.05, 0.0, 1e-3, -2e-3),
                                                        "pinhole"),
                                        ((0.1, -0.02, 0.003, 0.0), "fisheye")])
def test_colmap_text_byte_identical(tmp_path, dist, model):
    rec, cam, jcam = _rec(dist, model)
    texp.save_colmap_text(str(tmp_path / "t"), rec, cam, image_size=(640, 480))
    jexp.save_colmap_text(str(tmp_path / "j"), rec, jcam, image_size=(640, 480))
    t, j = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(t) == ["cameras.txt", "images.txt", "points3D.txt"]
    if model == "pinhole":
        assert t == j
        return
    assert t["cameras.txt"] == j["cameras.txt"] and t["images.txt"] == j["images.txt"]
    tl, jl = t["points3D.txt"].splitlines(), j["points3D.txt"].splitlines()
    assert len(tl) == len(jl) > 50 and tl[0] == jl[0]
    for a, b in zip(tl[1:], jl[1:]):
        a, b = a.split(), b.split()
        assert a[:7] + a[8:] == b[:7] + b[8:]
        assert float(a[7]) == pytest.approx(float(b[7]), rel=1e-5)


def test_ply_and_kitti_byte_identical_and_round_trip(tmp_path):
    rec, _, _ = _rec()
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((37, 3))
    cols = rng.integers(0, 256, (37, 3)).astype(np.uint8)
    nrm = rng.standard_normal((37, 3))
    for kw in (dict(), dict(colors=cols), dict(colors=cols, normals=nrm)):
        texp.save_ply(str(tmp_path / "t.ply"), pts, **kw)
        jexp.save_ply(str(tmp_path / "j.ply"), pts, **kw)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    texp.save_ply(str(tmp_path / "c.ply"), pts, colors=cols)
    back, cback = texp.load_ply(str(tmp_path / "c.ply"))
    np.testing.assert_allclose(back, pts, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cback, cols)
    texp.save_kitti_trajectory(str(tmp_path / "t.txt"), rec)
    jexp.save_kitti_trajectory(str(tmp_path / "j.txt"), rec)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    R_wc, C = texp.load_kitti_trajectory(str(tmp_path / "t.txt"))
    np.testing.assert_allclose(R_wc, rec.R[:5].transpose(0, 2, 1), atol=1e-8)
    np.testing.assert_allclose(C, -np.einsum("fji,fj->fi", rec.R[:5], rec.t[:5]), atol=1e-6)


def test_qvec_as_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        Q[:, 0] *= np.sign(np.linalg.det(Q))
        np.testing.assert_array_equal(texp._rot_to_qvec(Q), jexp._rot_to_qvec(Q))


@pytest.mark.parametrize("option", ["export_ply", "export_colmap", "export_kitti"])
def test_cli_export_option_as_jax(tmp_path, option):
    """Each --export-* option of reconstruct, slam and vo: the port CLI's
    files are the JAX CLI's, byte for byte, on one map."""
    rec, cam, jcam = _rec()
    jrec = types.SimpleNamespace(**interop.reconstruction_to_numpy(rec))
    out = {}
    for side, fn, c, r in (("t", tcli._run_exports, cam, rec), ("j", jcli._run_exports, jcam,
                                                                  jrec)):
        target = tmp_path / side / ("colmap" if option == "export_colmap" else "f")
        target.parent.mkdir()
        fn(types.SimpleNamespace(**{option: str(target)}), r, c)
        out[side] = _files(target) if target.is_dir() else target.read_bytes()
    assert out["t"] == out["j"] and out["t"]
