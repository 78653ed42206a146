"""The port's dense stereo and densify (fastmatch_tpu_torch/dense/, CPU)
against the JAX package's, on the same numpy inputs.

Tolerances: ``stereo_disparity`` valid masks equal on >= 0.999 of the
pixels; where both are valid, disparities within 1e-4 px on >= 0.98 of the
pixels and within 0.05 px on all. The JAX package's window sums are float32
prefix-sum differences (a parallel scan on the CPU), which lose up to
~2.3e-4 of a window's sum to cancellation; the port adds each window's
values in a fixed order; a near-flat subpixel parabola amplifies the
difference (measured on this pair: 126 of 14,492 pixels beyond 1e-4 px, the
largest 0.034 px, every mask equal). ``rectify_pair`` within 1e-5;
``depth_from_disparity`` within 1e-5 relative. ``densify`` the same pairs,
a point count within 8% and a cloud as close to the scene's landmarks as
the JAX package's: next to a flat background the JAX package's float32
window variances are cancellation noise (up to 4.6e-4 where the true value
is 0) that the ZNCC divides by, so its winners there are noise; measured on
these frames: 40,665 points (JAX) against 43,308, median distance to the
nearest landmark 0.2303 against 0.2298, share within 0.5 0.912 against
0.922.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from synth import SyntheticScene, render_scene_views


# The packages' __init__ re-exports ``densify`` the function over the module.
jdensify = importlib.import_module("fastmatch_tpu.dense.densify")
jstereo = importlib.import_module("fastmatch_tpu.dense.stereo")
tdensify = importlib.import_module("fastmatch_tpu_torch.dense.densify")
tstereo = importlib.import_module("fastmatch_tpu_torch.dense.stereo")

torch.set_num_threads(1)

H, W = 120, 160
CFG32 = dict(max_disp=32, win=9)


def _wave(rng, xs, ys, n_waves=32):
    freq = rng.uniform(0.02, 0.18, (n_waves, 2))
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    amp = rng.uniform(0.3, 1.0, n_waves)
    img = np.zeros_like(xs, np.float64)
    for (fy, fx), p, a in zip(freq, phase, amp):
        img += a * np.cos(2 * np.pi * (fx * xs + fy * ys) + p)
    return img


def _pair():
    """A rectified pair with a slanted disparity (6 to 20 px) and a flat band."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    d = 6.0 + 14.0 * xx / (W - 1)
    xl = xx + d
    for _ in range(25):
        xl = xx + 6.0 + 14.0 * xl / (W - 1)
    left = _wave(np.random.default_rng(2), xx, yy)
    right = _wave(np.random.default_rng(2), xl, yy)
    lo, span = left.min(), left.max() - left.min()
    left, right = ((left - lo) / span).astype(np.float32), ((right - lo) / span).astype(np.float32)
    left[:, :20] = 0.5
    right[:, :20] = 0.5
    return left, right


LEFT, RIGHT = _pair()
K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1.0]])


@pytest.fixture(scope="module")
def jax_stereo():
    cfg = jstereo.StereoConfig(**CFG32)
    disp, valid = jstereo.stereo_disparity(jnp.asarray(LEFT), jnp.asarray(RIGHT), cfg)
    return np.asarray(disp), np.asarray(valid)


def _agree(tdisp, tvalid, jdisp, jvalid):
    assert (tvalid == jvalid).mean() >= 0.999
    both = tvalid & jvalid
    assert both.mean() > 0.4
    err = np.abs(tdisp[both] - jdisp[both])
    assert (err <= 1e-4).mean() >= 0.98
    assert err.max() <= 0.05


def test_stereo_disparity_vs_jax(jax_stereo):
    disp, valid = tstereo.stereo_disparity(LEFT, RIGHT, tstereo.StereoConfig(**CFG32),
                                           device="cpu")
    _agree(disp.numpy(), valid.numpy(), *jax_stereo)
    assert not valid.numpy()[:, 5:15].any()       # the flat band is rejected


def test_stereo_batch_and_depth(jax_stereo):
    cfg = tstereo.StereoConfig(**CFG32)
    L = np.stack([LEFT, RIGHT[:, ::-1].copy()])
    R = np.stack([RIGHT, LEFT[:, ::-1].copy()])
    bd, bv = tstereo.stereo_batch(L, R, cfg, device="cpu")
    jd, jv = jstereo.stereo_batch(jnp.asarray(L), jnp.asarray(R), jstereo.StereoConfig(**CFG32))
    assert bd.shape == (2, H, W)
    for i in range(2):
        _agree(bd[i].numpy(), bv[i].numpy(), np.asarray(jd[i]), np.asarray(jv[i]))
    jdisp, jvalid = jax_stereo
    td = tstereo.depth_from_disparity(torch.from_numpy(jdisp), torch.from_numpy(jvalid),
                                      200.0, 0.1)
    jdep = np.asarray(jstereo.depth_from_disparity(jnp.asarray(jdisp), jnp.asarray(jvalid),
                                                   200.0, 0.1))
    np.testing.assert_allclose(td.numpy(), jdep, rtol=1e-5, atol=0)
    tp, ti = tstereo.disparity_to_points(torch.from_numpy(jdisp), torch.from_numpy(jvalid),
                                         K, 0.1, image=torch.from_numpy(LEFT), stride=2,
                                         max_depth=3.0)
    jp, ji = jstereo.disparity_to_points(jdisp, jvalid, K, 0.1, image=LEFT, stride=2,
                                         max_depth=3.0)
    assert len(tp) > 500
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ti, ji)


def test_rectify_pair_vs_jax():
    rng = np.random.default_rng(4)
    scene = SyntheticScene(rng, n_points=200, n_frames=2, image_size=(W, H))
    v0, v1 = render_scene_views(scene, rng, image_size=(W, H))
    Kc = scene.K
    R_ab = scene.R[1] @ scene.R[0].T
    t_ab = scene.t[1] - R_ab @ scene.t[0]
    ja, jb, jinfo = jstereo.rectify_pair(jnp.asarray(v0), jnp.asarray(v1), Kc, R_ab, t_ab)
    ta, tb, tinfo = tstereo.rectify_pair(v0, v1, Kc, R_ab, t_ab, device="cpu")
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5, rtol=0)
    assert tinfo["baseline"] == jinfo["baseline"]
    np.testing.assert_array_equal(tinfo["R_rect_a"], jinfo["R_rect_a"])


@pytest.mark.parametrize("t", [[0.0, 0.0, -0.5], [0.05, 0.0, -1.0], [0.0, 0.0, 0.0]])
def test_rectify_pair_raises_as_jax(t):
    img = np.zeros((H, W), np.float32)
    with pytest.raises(ValueError) as je:
        jstereo.rectify_pair(jnp.asarray(img), jnp.asarray(img), K, np.eye(3), np.array(t))
    with pytest.raises(ValueError) as te:
        tstereo.rectify_pair(img, img, K, np.eye(3), np.array(t), device="cpu")
    assert str(te.value) == str(je.value)


def test_select_pairs_as_jax():
    rng = np.random.default_rng(0)
    F = 9
    R = np.tile(np.eye(3), (F, 1, 1))
    C = np.cumsum(rng.uniform(0.0, 0.12, (F, 3)), axis=0)
    t = -np.einsum("fij,fj->fi", R, C)
    for kw in (dict(), dict(min_ratio=0.04), dict(min_ratio=0.08, max_ratio=0.1)):
        assert tdensify.select_pairs(R, t, 2.0, **kw) == jdensify.select_pairs(R, t, 2.0, **kw)


def test_densify_vs_jax():
    rng = np.random.default_rng(5)
    scene = SyntheticScene(rng, n_points=200, n_frames=12, image_size=(320, 240))
    views = [np.asarray(v, np.float32) for v in render_scene_views(
        scene, rng, image_size=(320, 240), frames=list(range(6)))]
    R, t = scene.R[:6], scene.t[:6]
    jp, ji, jrep = jdensify.densify(views, R, t, scene.K, sparse_points=scene.points)
    tp, ti, trep = tdensify.densify(views, R, t, scene.K, sparse_points=scene.points,
                                    device="cpu")
    assert trep["pairs_used"] == jrep["pairs_used"] >= 2
    assert trep["pairs_considered"] == jrep["pairs_considered"]
    assert jrep["n_points"] > 300
    assert abs(trep["n_points"] - jrep["n_points"]) <= 0.08 * jrep["n_points"]
    assert trep["voxel"] == jrep["voxel"] and trep["median_depth"] == jrep["median_depth"]
    assert tp.shape == (trep["n_points"], 3) and ti.shape == (trep["n_points"],)

    def near(pts):
        d = np.linalg.norm(pts[:, None, :] - scene.points[None, :, :], axis=-1).min(axis=1)
        return np.median(d), (d < 0.5).mean()

    (tmed, tshare), (jmed, jshare) = near(tp), near(jp)
    assert tmed <= jmed + 0.01 and tshare >= jshare - 0.01


def test_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstereo.stereo_disparity(LEFT, RIGHT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdensify.densify([LEFT, RIGHT], np.tile(np.eye(3), (2, 1, 1)), np.zeros((2, 3)), K)
