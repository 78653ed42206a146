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
``gather_patches(interpret=True)``, clamped edges included; its patch-set
form (virtual replicate padding, many segments) with the JAX kernel on the
``jnp.pad(..., "edge")`` stack, or with the JAX package's ``dynamic_slice``
path where the kernel's packing limits refuse the shape.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

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


# (name, stack (L, H, W), P, pad, reference): SIFT's orientation set (pad
# R+1 = 9, P = 2R+3 = 19) and descriptor set (pad 2, P = 88, and P = H + 2
# pad where the stack is small), ORB's (pad P // 2 = 20, P = 40) and the
# unpadded case. "kernel": the JAX Pallas kernel in interpret mode on the
# edge-padded stack; "slice": the JAX package's dynamic_slice path
# (jsift._extract_patches on the CPU), where the kernel refuses the shape
# (its aligned row slab is taller than the padded stack).
PATCH_SETS = [
    ("unpadded", (3, 123, 251), 24, 0, "kernel"),
    ("sift_orientation", (6, 40, 50), 19, 9, "kernel"),
    ("sift_descriptor", (6, 100, 120), 88, 2, "kernel"),
    ("sift_descriptor_whole_height", (6, 30, 41), 34, 2, "slice"),
    ("orb", (1, 60, 80), 40, 20, "kernel"),
]


def _starts(rng, shape, P, pad, K=32):
    """(K, 3) int32 starts beyond both edges of the padded stack, levels
    out of range, the four corners first."""
    L, H, W = shape
    Hp, Wp = H + 2 * pad, W + 2 * pad
    lyx = np.column_stack([rng.integers(-1, L + 1, K), rng.integers(-P - 4, Hp + 4, K),
                           rng.integers(-P - 4, Wp + 4, K)])
    corners = [[0, -7, -7], [L - 1, Hp, Wp], [L, -1, Wp - P], [-1, Hp - P, -2]]
    if K:
        lyx[:min(K, 4)] = corners[:K]
    return lyx.astype(np.int32)


def _padded_gather(seg):
    """The padded route: a replicate-padded copy of the stack, then the
    unpadded gather."""
    padded = F.pad(seg.stack[None], (seg.pad,) * 4, mode="replicate")[0]
    return k3.gather_patches_plain(padded, seg.lyx, seg.patch)


@pytest.mark.parametrize("name, shape, P, pad, via", PATCH_SETS,
                         ids=[c[0] for c in PATCH_SETS])
def test_patch_sets_plain_vs_jax(name, shape, P, pad, via):
    rng = np.random.default_rng(len(name))
    stack = rng.random(shape, dtype=np.float32)
    lyx = _starts(rng, shape, P, pad)
    padded = jnp.pad(jnp.asarray(stack), ((0, 0), (pad, pad), (pad, pad)), mode="edge")
    if via == "kernel":
        ref = j_gather(padded, jnp.asarray(lyx), P, block_k=32, interpret=True)
    else:
        with pytest.raises(ValueError, match="too large"):
            j_gather(padded, jnp.asarray(lyx), P, block_k=32, interpret=True)
        # dynamic_slice wraps a negative start as Python indexing does and
        # clamps only from there; SIFT's descriptor starts are >= 0.
        lyx = np.maximum(lyx, 0)
        j = jnp.asarray(lyx)
        ref = jsift._extract_patches(padded, j[:, 0], j[:, 1], j[:, 2], P)
    seg = k3.PatchSet(torch.from_numpy(stack), torch.from_numpy(lyx), P, pad)
    before = k3.gather_patch_sets.launches
    out = k3.gather_patch_sets([seg])[0]
    assert k3.gather_patch_sets.launches == before  # CPU tensors take the plain version
    assert out.shape == (32, P, P)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(k3.gather_patch_sets_plain([seg])[0].numpy(), np.asarray(ref))
    assert torch.equal(out, _padded_gather(seg))


def test_patch_sets_multi_segment_and_plan():
    rng = np.random.default_rng(5)
    # Different stacks, L, K (0 and K*P*P not a multiple of 4 included), P
    # and pad; two sets share a stack, as an octave's two SIFT sets do.
    shared = rng.random((6, 40, 50), dtype=np.float32)
    specs = [(shared, 19, 9, 33), (shared, 34, 2, 0), (shared, 40, 2, 5),
             (rng.random((1, 30, 45), dtype=np.float32), 40, 20, 7),
             (rng.random((3, 20, 25), dtype=np.float32), 1, 0, 5),
             (rng.random((2, 12, 9), dtype=np.float32), 13, 2, 3)]
    segs = [k3.PatchSet(torch.from_numpy(st), torch.from_numpy(_starts(rng, st.shape, P, pad, K)),
                        P, pad) for st, P, pad, K in specs]
    outs = k3.gather_patch_sets(segs)
    assert len(outs) == len(segs)
    for seg, out in zip(segs, outs):
        assert out.shape == (seg.lyx.shape[0], seg.patch, seg.patch)
        assert torch.equal(out, k3.gather_patch_sets([seg])[0])
        assert torch.equal(out, _padded_gather(seg))

    sizes = [(s.lyx.shape[0], s.patch) for s in segs] * 6  # 36 > MAX_SEGMENTS
    offsets, first_blocks, total, launches = k3.plan_patch_sets(sizes)
    n = [K * P * P for K, P in sizes]
    assert all(o * 4 % 512 == 0 for o in offsets)  # 512-byte aligned views
    assert all(offsets[i] + n[i] <= offsets[i + 1] for i in range(len(sizes) - 1))
    assert offsets[-1] + n[-1] <= total < offsets[-1] + n[-1] + k3.ALIGN_FLOATS
    m = k3.MAX_SEGMENTS
    assert launches == [(0, m, sum(-(-x // k3.BLOCK_FLOATS) for x in n[:m])),
                        (m, len(sizes), sum(-(-x // k3.BLOCK_FLOATS) for x in n[m:]))]
    for a, b in ((0, m), (m, len(sizes))):
        assert first_blocks[a] == 0
        for i in range(a + 1, b):
            assert first_blocks[i] - first_blocks[i - 1] == -(-n[i - 1] // k3.BLOCK_FLOATS)


def _bad_sets():
    f32, i32 = torch.float32, torch.int32
    lyx = torch.zeros((2, 3), dtype=i32)
    return {
        "patch_taller": ([k3.PatchSet(torch.zeros(1, 8, 20), lyx, 11, 1)], "patch 11 larger"),
        "patch_wider": ([k3.PatchSet(torch.zeros(1, 20, 8), lyx, 11, 1)], "patch 11 larger"),
        "negative_pad": ([k3.PatchSet(torch.zeros(1, 8, 8), lyx, 3, -1)], "pad"),
        "empty_patch": ([k3.PatchSet(torch.zeros(1, 8, 8), lyx, 0, 0)], "patch"),
        "stack_2d": ([k3.PatchSet(torch.zeros(8, 8), lyx, 3, 0)], "stack"),
        "stack_dtype": ([k3.PatchSet(torch.zeros(1, 8, 8, dtype=torch.float64), lyx, 3, 0)],
                        "float32"),
        "stack_strided": ([k3.PatchSet(torch.zeros(1, 8, 16)[:, :, ::2], lyx, 3, 0)],
                          "contiguous"),
        "lyx_dtype": ([k3.PatchSet(torch.zeros(1, 8, 8), lyx.long(), 3, 0)], "int32"),
        "lyx_shape": ([k3.PatchSet(torch.zeros(1, 8, 8), lyx[:, :2].contiguous(), 3, 0)],
                      "lyx"),
        "mixed_devices": ([k3.PatchSet(torch.zeros(1, 8, 8), lyx, 3, 0),
                           k3.PatchSet(torch.zeros(1, 8, 8, device="meta"),
                                       lyx.to("meta"), 3, 0)], "on cpu"),
        "device": ([k3.PatchSet(torch.zeros(1, 8, 8, dtype=f32, device="meta"),
                                lyx.to("meta"), 3, 0)], "unsupported device"),
    }


@pytest.mark.parametrize("case", sorted(_bad_sets()))
def test_patch_sets_rejected(case):
    segs, match = _bad_sets()[case]
    with pytest.raises(ValueError, match=match):
        k3.gather_patch_sets(segs)


def test_detect_and_describe_one_k3_call(monkeypatch):
    calls = []

    def record(segments):
        calls.append(list(segments))
        return k3.gather_patch_sets(segments)

    monkeypatch.setattr(tsift, "gather_patch_sets", record)
    cfg = tsift.SIFTConfig(capacity=256, n_octaves=3)
    before = (k3.gather_patch_sets.launches, k3.gather_patches.launches)
    tsift.detect_and_describe(IMAGES["blob"], cfg, device="cpu")
    assert (k3.gather_patch_sets.launches, k3.gather_patches.launches) == before
    assert len(calls) == 1 and len(calls[0]) == 2 * cfg.n_octaves
    sets = calls[0]
    R = cfg.ori_radius
    assert [(s.patch, s.pad) for s in sets[:3]] == [(2 * R + 3, R + 1)] * 3
    assert [s.pad for s in sets[3:]] == [2] * 3
    for o in range(3):  # each octave's two sets read its stack, unpadded
        assert sets[o].stack is sets[3 + o].stack
        assert tuple(sets[o].stack.shape) == (6, 256 >> o, 256 >> o)
    for seg in sets:  # as a padded copy and the unpadded gather, bit for bit
        assert torch.equal(k3.gather_patch_sets([seg])[0], _padded_gather(seg))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsift.detect_and_describe(IMAGES["blob"])
