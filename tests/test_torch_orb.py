"""The port's ORB features (fastmatch_tpu_torch, CPU) against the JAX package's.

Same numpy images into both ``detect_and_describe_orb``s, on the blob image
of tests/test_orb.py (capacity 256, 2 levels) and a rendered 320x240 frame
(capacity 512, 4 levels). Measured on these inputs:

- keypoint xy, scale and mask: identical (every slot);
- orientation: at most 2.4e-7 rad (blob) and 1.2e-6 rad (frame) apart; the
  two centroid moments sum 1600 products in another order in each
  framework. Gate 1e-4 rad;
- rBRIEF bits: 1.0 (blob) and 0.99998 (frame) of the live bits agree; each
  bit compares two bilinear samples whose (512, 40) @ (40, 40) products sum
  in another order, so a near-equal pair can flip. Gate 0.995.

On ORB descriptors of consecutive rendered frames, the batched binary
matcher (K1's plain version on the CPU) equals the JAX package's
``match_batch_hamming(backend="mxu")`` bit for bit; both keep the fast
kernel's value-based mutual test, so they differ from the popcount matcher
exactly where a bank row's minimum distance is attained by more than one
query (both pass; the popcount matcher keeps the lowest).

The pyramid levels rebuild ``jax.image.resize(..., "linear")``'s weights in
numpy; XLA sums each weight column in its own order, so a level differs
from JAX's by at most 3e-7 on [0, 1] images (gate 1e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.core.containers import BinaryDescriptors as JBinary
from fastmatch_tpu.features import orb as jorb
from fastmatch_tpu.matching import hamming as jham
from synth import SyntheticScene, render_scene_views
from test_orb import blob_image

from fastmatch_tpu_torch.core.containers import BinaryDescriptors
from fastmatch_tpu_torch.features import orb as torb
from fastmatch_tpu_torch.kernels import patch_gather as k3
from fastmatch_tpu_torch.matching import hamming as tham

torch.set_num_threads(1)


def _images():
    rng = np.random.default_rng(1)
    scene = SyntheticScene(rng, n_points=120, n_frames=2, image_size=(320, 240))
    frame = render_scene_views(scene, rng, image_size=(320, 240), frames=[0])[0]
    return {"blob": (blob_image(np.random.default_rng(4)), dict(capacity=256, n_levels=2)),
            "frame": (frame, dict(capacity=512))}


IMAGES = _images()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_detect_and_describe_orb_vs_jax(name):
    img, kw = IMAGES[name]
    jk, jd = jorb.detect_and_describe_orb(jnp.asarray(img), jorb.ORBConfig(**kw))
    before = k3.gather_patches.launches
    tk, td = torb.detect_and_describe_orb(img, torb.ORBConfig(**kw), device="cpu")
    assert k3.gather_patches.launches == before  # CPU: K3's plain version
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert tm.sum() > 100
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tk.xy.numpy(), np.asarray(jk.xy))
    np.testing.assert_array_equal(tk.scale.numpy(), np.asarray(jk.scale))
    np.testing.assert_allclose(tk.score.numpy(), np.asarray(jk.score), rtol=1e-5, atol=1e-5)
    assert np.abs(tk.angle.numpy() - np.asarray(jk.angle))[tm].max() < 1e-4
    assert td.packed.shape == (kw["capacity"], 8) and td.packed.dtype == torch.int32
    jbits = np.unpackbits(np.asarray(jd.packed).view(np.uint8), axis=1)
    tbits = np.unpackbits(td.packed.numpy().view(np.uint8), axis=1)
    assert (jbits[tm] == tbits[tm]).mean() >= 0.995
    assert (td.packed.numpy()[~tm] == 0).all()


@pytest.mark.parametrize("level", [1, 2, 3])
def test_pyramid_level_vs_jax_resize(level):
    img = IMAGES["frame"][0]  # 240 x 320
    sh = (int(round(240 / 1.25 ** level)), int(round(320 / 1.25 ** level)))
    ref = np.asarray(jax.image.resize(jnp.asarray(img), sh, "linear"))
    got = torb._resize_linear(torch.from_numpy(img), sh).numpy()
    assert got.shape == ref.shape == sh
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_detect_level_vs_jax():
    img = IMAGES["frame"][0]
    cfg_j, cfg_t = jorb.ORBConfig(), torb.ORBConfig()
    jxy, jvals, jmask, jyy, jxx = jorb._detect_level(jnp.asarray(img), cfg_j, 512)
    txy, tvals, tmask, tyy, txx = torb._detect_level(torch.from_numpy(img), cfg_t, 512)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(tyy.numpy(), np.asarray(jyy))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=1e-5, atol=1e-5)


def test_brief_pattern_and_config_as_jax():
    cfg = torb.ORBConfig()
    assert tuple(cfg) == tuple(jorb.ORBConfig())
    np.testing.assert_array_equal(
        torb._brief_pattern(cfg.n_bits, cfg.pattern_radius, cfg.pattern_seed),
        jorb._brief_pattern(cfg.n_bits, cfg.pattern_radius, cfg.pattern_seed))
    assert torb._CIRCLE == jorb._CIRCLE


def test_frame_pairs_batch_match_vs_jax():
    rng = np.random.default_rng(2)
    scene = SyntheticScene(rng, n_points=150, n_frames=3, image_size=(320, 240))
    views = render_scene_views(scene, rng, image_size=(320, 240), frames=[0, 1, 2])
    descs = [torb.detect_and_describe_orb(v, torb.ORBConfig(capacity=512), device="cpu")[1]
             for v in views]
    pa = torch.stack([d.packed for d in descs[:-1]])
    pb = torch.stack([d.packed for d in descs[1:]])
    ma = torch.stack([d.mask for d in descs[:-1]])
    mb = torch.stack([d.mask for d in descs[1:]])
    port = tham.match_batch_hamming(BinaryDescriptors(pa, ma), BinaryDescriptors(pb, mb),
                                    backend="mxu", device="cpu")
    j = lambda p, m: JBinary(jnp.asarray(p.numpy().view(np.uint32)), jnp.asarray(m.numpy()))
    ref = jham.match_batch_hamming(j(pa, ma), j(pb, mb), backend="mxu")
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(port.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(port.dist.numpy(), np.asarray(ref.dist))
    anchor = tham.match_batch_hamming(BinaryDescriptors(pa, ma), BinaryDescriptors(pb, mb),
                                      backend="popcount", device="cpu")
    v, av = port.valid.numpy(), anchor.valid.numpy()
    assert v.sum(-1).min() > 10 and not (av & ~v).any()
    np.testing.assert_array_equal(port.idx.numpy()[av], anchor.idx.numpy()[av])
    for p, q in zip(*np.nonzero(v & ~av)):  # column ties only
        h = tham.hamming_distance_matrix(pa[p], pb[p]).numpy()
        i1 = port.idx.numpy()[p, q]
        assert h[q, i1] == h[ma[p].numpy(), i1].min()


def test_detect_and_describe_orb_one_k3_call(monkeypatch):
    calls = []

    def record(segments):
        calls.append(list(segments))
        return k3.gather_patch_sets(segments)

    monkeypatch.setattr(torb, "gather_patch_sets", record)
    img, kw = IMAGES["blob"]
    cfg = torb.ORBConfig(**kw)
    before = (k3.gather_patch_sets.launches, k3.gather_patches.launches)
    torb.detect_and_describe_orb(img, cfg, device="cpu")
    assert (k3.gather_patch_sets.launches, k3.gather_patches.launches) == before
    assert len(calls) == 1 and len(calls[0]) == cfg.n_levels
    for seg in calls[0]:  # each level's blurred image, padded by P // 2 in the reads
        assert (seg.patch, seg.pad, seg.stack.shape[0]) == (cfg.patch, cfg.patch // 2, 1)
        padded = torch.nn.functional.pad(seg.stack[None], (seg.pad,) * 4, mode="replicate")[0]
        assert torch.equal(k3.gather_patch_sets([seg])[0],
                           k3.gather_patches_plain(padded, seg.lyx, seg.patch))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        torb.detect_and_describe_orb(IMAGES["blob"][0])
