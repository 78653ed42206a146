"""The port's SIFT (fastmatch_tpu_torch, CPU) against the JAX package's.

Same numpy images into both ``detect_and_describe``s. Two measures:

- the share of JAX keypoints the port reproduces at the same scale (1e-3
  relative) within 1e-3 px: >= 0.98. Measured on these inputs: 1.0 on the
  blob image and 259/260 on the rendered frame, whose odd keypoint sits on a
  near-tied selection score;
- the descriptor max-abs difference on the reproduced keypoints: 99th
  percentile < 1e-4 (measured 1.2e-5 and 2.2e-5), every one < 0.05. The
  orientation histogram sums its 289 votes in another order in each
  framework, which moves an interpolated peak by up to 0.008 rad on a
  near-flat histogram (measured on 2 of the 260 frame keypoints) and with
  it that keypoint's descriptor by up to 0.009.

The K3 patch gather's plain version is compared bit for bit with
``gather_patches(interpret=True)``, clamped edges included.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.features import sift as jsift
from fastmatch_tpu.kernels.patch_gather import gather_patches as j_gather
from synth import SyntheticScene, render_blob_image, render_scene_views

from fastmatch_tpu_torch.features import sift as tsift
from fastmatch_tpu_torch.kernels import patch_gather as k3

torch.set_num_threads(1)

CAPACITY = 512


def _images():
    rng = np.random.default_rng(0)
    blob = render_blob_image(rng, (256, 256), 60)
    rng = np.random.default_rng(1)
    scene = SyntheticScene(rng, n_points=120, n_frames=2, image_size=(320, 240))
    frame = render_scene_views(scene, rng, image_size=(320, 240), frames=[0])[0]
    return {"blob": blob, "frame": frame}


IMAGES = _images()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_detect_and_describe_vs_jax(name):
    img = IMAGES[name]
    jk, jd = jsift.detect_and_describe(jnp.asarray(img), jsift.SIFTConfig(capacity=CAPACITY))
    tk, td = tsift.detect_and_describe(img, tsift.SIFTConfig(capacity=CAPACITY),
                                       device="cpu")
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert tk.xy.shape == (CAPACITY, 2) and td.data.shape == (CAPACITY, 128)
    assert abs(int(jm.sum()) - int(tm.sum())) <= max(2, int(0.02 * jm.sum()))
    jxy, txy = np.asarray(jk.xy)[jm], tk.xy.numpy()[tm]
    js, ts = np.asarray(jk.scale)[jm], tk.scale.numpy()[tm]
    d = np.abs(jxy[:, None] - txy[None]).max(-1)
    d = np.where(np.abs(js[:, None] - ts[None]) <= 1e-3 * js[:, None], d, np.inf)
    nn = d.argmin(1)
    hit = d[np.arange(len(nn)), nn] < 1e-3
    assert hit.mean() >= 0.98, hit.mean()
    err = np.abs(np.asarray(jd.data)[jm][hit] - td.data.numpy()[tm][nn[hit]]).max(1)
    assert np.percentile(err, 99) < 1e-4, np.percentile(err, 99)
    assert err.max() < 0.05, err.max()
    # Padded slots are zero, live descriptors unit norm.
    assert np.all(td.data.numpy()[~tm] == 0)
    np.testing.assert_allclose(np.linalg.norm(td.data.numpy()[tm], axis=1), 1.0, atol=1e-5)


def test_gaussian_pyramid_vs_jax():
    img = IMAGES["blob"][:96, :80]
    cfg_j, cfg_t = jsift.SIFTConfig(n_octaves=3), tsift.SIFTConfig(n_octaves=3)
    jo, js = jsift._gaussian_pyramid(jnp.asarray(img), cfg_j)
    to, ts = tsift._gaussian_pyramid(torch.from_numpy(img), cfg_t)
    assert js == ts
    for a, b in zip(jo, to):
        assert tuple(a.shape) == tuple(b.shape)
        # Shift-and-add with the same taps in the same order: exact f32,
        # up to the fused multiply-adds either compiler may choose.
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_gauss_kernel_and_weights_match():
    for sigma in (0.5, 1.2263, 1.6, 2.5):
        np.testing.assert_array_equal(tsift._gauss_kernel1d(sigma),
                                      jsift._gauss_kernel1d(sigma))
    np.testing.assert_array_equal(tsift._descriptor_weights(tsift.SIFTConfig()),
                                  jsift._descriptor_weights(jsift.SIFTConfig()))


def _ref(stack, lyx, P):
    L, H, W = stack.shape
    out = []
    for l, y, x in lyx:
        out.append(stack[np.clip(l, 0, L - 1), np.clip(y, 0, H - P):np.clip(y, 0, H - P) + P,
                         np.clip(x, 0, W - P):np.clip(x, 0, W - P) + P])
    return np.stack(out)


def test_patch_gather_plain_vs_jax_kernel():
    rng = np.random.default_rng(0)
    stack = rng.random((3, 123, 251)).astype(np.float32)
    P = 24
    lyx = np.array([[0, 0, 0], [2, 99, 227], [1, 98, 226], [0, 7, 1],
                    [1, 8, 128], [2, 95, 120], [5, 500, 500], [0, -3, -3]] * 16,
                   np.int32)  # out-of-range rows are clamped
    ref = np.asarray(j_gather(jnp.asarray(stack), jnp.asarray(lyx), P, interpret=True))
    before = k3.gather_patches.launches
    out = k3.gather_patches(torch.from_numpy(stack), torch.from_numpy(lyx), P)
    assert k3.gather_patches.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), _ref(stack, lyx, P))


@pytest.mark.parametrize("P", [19, 35, 40])
def test_patch_gather_plain_random(P):
    # The orientation (2R+3 = 19) and descriptor patch sizes of SIFT.
    rng = np.random.default_rng(P)
    stack = rng.random((6, 90, 130)).astype(np.float32)
    K = 200
    lyx = np.column_stack([rng.integers(-1, 7, K), rng.integers(-5, 95, K),
                           rng.integers(-5, 135, K)]).astype(np.int32)
    out = k3.gather_patches_plain(torch.from_numpy(stack), torch.from_numpy(lyx), P)
    np.testing.assert_array_equal(out.numpy(), _ref(stack, lyx, P))


def test_patch_larger_than_stack_rejected():
    with pytest.raises(ValueError, match="patch"):
        k3.gather_patches(torch.zeros((1, 8, 8)), torch.zeros((1, 3), dtype=torch.int32), 9)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsift.detect_and_describe(IMAGES["blob"])
