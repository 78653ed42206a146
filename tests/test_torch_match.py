"""The port's matcher (fastmatch_tpu_torch, CPU) against the JAX package's.

Both sides get the same numpy inputs from a seed. The JAX side runs its
plain reference ``match_pair_jnp`` and its fused kernel
``match_pair_pallas(interpret=True)`` as tests/test_kernels.py does; the
port runs ``match_pair(device="cpu")`` and the K2 wrapper
``distance_topk`` on CPU tensors, which take the kernel's plain version.

Tolerances: decisions (valid, idx) are compared exactly on fixtures without
near-ties; distances to rtol/atol 1e-5 (the two frameworks sum the 128-term
dot products in different orders, a few float32 ulps apart). Tie-heavy
fixtures and bf16 ("fast") mode need only >= 99% decision agreement, the
JAX package's own gate for its fast path.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.core.containers import Descriptors as JDescriptors
from fastmatch_tpu.core.containers import descriptors_from_numpy as j_descriptors_from_numpy
from fastmatch_tpu.kernels.distance_topk import _chunked_topk as j_chunked_topk
from fastmatch_tpu.kernels.distance_topk import distance_topk as j_distance_topk
from fastmatch_tpu.kernels.distance_topk import match_pair_pallas
from fastmatch_tpu.matching.hamming import hamming_distance_matrix as j_hamming_distance_matrix
from fastmatch_tpu.matching.matcher import BIG as J_BIG
from fastmatch_tpu.matching.matcher import match_pair_jnp
from synth import corresponding_descriptors, random_descriptors

from fastmatch_tpu.core.containers import binary_descriptors_from_numpy as j_binary_from_numpy
from fastmatch_tpu_torch.core.containers import BinaryDescriptors, Descriptors
from fastmatch_tpu_torch.interop import (binary_descriptors_from_arrays, descriptors_from_arrays,
                                         descriptors_from_numpy)
from fastmatch_tpu_torch.kernels import batch_match as k1
from fastmatch_tpu_torch.kernels import distance_topk as k2
from fastmatch_tpu_torch.matching import hamming as tham
from fastmatch_tpu_torch.matching.matcher import BIG, match_pair, match_pair_plain

torch.set_num_threads(1)


def _both(a, b, mask_a=None, mask_b=None):
    mask_a = np.ones(len(a), bool) if mask_a is None else mask_a
    mask_b = np.ones(len(b), bool) if mask_b is None else mask_b
    jd = (JDescriptors(jnp.asarray(a), jnp.asarray(mask_a)),
          JDescriptors(jnp.asarray(b), jnp.asarray(mask_b)))
    td = (descriptors_from_arrays(a, mask_a, device="cpu"),
          descriptors_from_arrays(b, mask_b, device="cpu"))
    return jd, td


def _assert_same(port, ref):
    valid = port.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    np.testing.assert_array_equal(port.idx.numpy()[valid], np.asarray(ref.idx)[valid])
    np.testing.assert_allclose(port.dist.numpy()[valid], np.asarray(ref.dist)[valid],
                               rtol=1e-5, atol=1e-5)


def _agreement(port, ref):
    pv, rv = port.valid.numpy(), np.asarray(ref.valid)
    pi, ri = port.idx.numpy(), np.asarray(ref.idx)
    same = (pv == rv) & (~rv | (pi == ri))
    return same.mean()


def _padded(a, cap):
    data = np.zeros((cap, a.shape[1]), np.float32)
    data[:len(a)] = a
    mask = np.zeros(cap, bool)
    mask[:len(a)] = True
    return data, mask


@pytest.mark.parametrize("n", [0, 300, 600])
def test_descriptors_from_numpy_vs_jax(rng, n):
    desc = random_descriptors(rng, n)
    ref = j_descriptors_from_numpy(desc, capacity=512)
    port = descriptors_from_numpy(desc, capacity=512, device="cpu")
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    with pytest.raises(ValueError, match="descriptors"):
        descriptors_from_numpy(desc[:, :64])


def test_big_is_the_jax_constant():
    assert BIG == J_BIG
    assert np.float32(BIG) == np.float32(3.0e38)


@pytest.mark.parametrize("cross_check", [False, True])
@pytest.mark.parametrize("backend", ["plain", "kernel"])
def test_random_parity(rng, cross_check, backend):
    a, b, _ = corresponding_descriptors(rng, 400, noise=0.1, n_distract=112)
    (pa, ma), (pb, mb) = _padded(a, 512), _padded(b, 512)
    (ja, jb), (ta, tb) = _both(pa, pb, ma, mb)
    ref = match_pair_jnp(ja, jb, cross_check=cross_check)
    port = match_pair(ta, tb, cross_check=cross_check, backend=backend, device="cpu")
    _assert_same(port, ref)
    _assert_same(port, match_pair_pallas(ja, jb, cross_check=cross_check, interpret=True))


def test_recovers_ground_truth(rng):
    a, b, gt = corresponding_descriptors(rng, 300, noise=0.05, n_distract=50)
    _, (ta, tb) = _both(a, b)
    m = match_pair(ta, tb, device="cpu")
    valid = m.valid.numpy()
    assert valid.sum() > 250
    assert (m.idx.numpy()[valid] == gt[valid]).mean() > 0.99


def test_rectangular(rng):
    a = random_descriptors(rng, 700)
    b = random_descriptors(rng, 300)
    (ja, jb), (ta, tb) = _both(a, b)
    _assert_same(match_pair(ta, tb, device="cpu"), match_pair_jnp(ja, jb))


def test_adversarial_masks(rng):
    a = random_descriptors(rng, 512)
    b = random_descriptors(rng, 512)
    keep_a = np.arange(512) % 5 != 0
    keep_b = np.arange(512) % 7 != 3
    (ja, jb), (ta, tb) = _both(a, b, keep_a, keep_b)
    ref = match_pair_jnp(ja, jb)
    for backend in ("plain", "kernel"):
        port = match_pair(ta, tb, backend=backend, device="cpu")
        _assert_same(port, ref)
        assert not port.valid.numpy()[~keep_a].any()
        assert np.all(keep_b[port.idx.numpy()[port.valid.numpy()]])


@pytest.mark.parametrize("backend", ["plain", "kernel"])
def test_all_b_masked(rng, backend):
    a = random_descriptors(rng, 100)
    b = random_descriptors(rng, 100)
    (ja, jb), (ta, tb) = _both(a, b, None, np.zeros(100, bool))
    port = match_pair(ta, tb, backend=backend, device="cpu")
    assert int(port.count()) == 0
    assert int(match_pair_pallas(ja, jb, interpret=True).count()) == 0
    # Invalid rows carry the finite BIG, never inf.
    assert np.all(port.dist.numpy() == np.float32(BIG))


def test_single_live_column_has_no_ratio(rng):
    a = random_descriptors(rng, 64)
    b = random_descriptors(rng, 64)
    mask_b = np.zeros(64, bool)
    mask_b[5] = True
    (ja, jb), (ta, tb) = _both(a, b, None, mask_b)
    port = match_pair(ta, tb, cross_check=False, ratio=1.5, device="cpu")
    assert int(port.count()) == 0
    _assert_same(port, match_pair_jnp(ja, jb, cross_check=False, ratio=1.5))


@pytest.mark.parametrize("backend", ["plain", "kernel"])
def test_duplicate_descriptor_ties(backend):
    # Identical rows in B: both packages pick the lowest index, and the
    # column argmin picks the lowest row.
    a = np.tile(np.eye(8, 128, dtype=np.float32), (32, 1))
    b = np.tile(np.eye(8, 128, dtype=np.float32), (64, 1))
    (ja, jb), (ta, tb) = _both(a, b)
    for cc in (False, True):
        ref = match_pair_jnp(ja, jb, cross_check=cc, ratio=1.5)
        port = match_pair(ta, tb, cross_check=cc, ratio=1.5, backend=backend,
                          device="cpu")
        np.testing.assert_array_equal(port.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    assert np.all(port.idx.numpy() == np.arange(256) % 8)


def test_tie_heavy_agreement(rng):
    # Quantized descriptors: many exact distance ties across rows and columns.
    a = np.round(random_descriptors(rng, 600) * 8) / 8
    b = np.round(random_descriptors(rng, 900) * 8) / 8
    (ja, jb), (ta, tb) = _both(a.astype(np.float32), b.astype(np.float32))
    ref = match_pair_jnp(ja, jb, ratio=0.95)
    port = match_pair(ta, tb, ratio=0.95, device="cpu")
    assert _agreement(port, ref) >= 0.99


def test_large_bank_above_tpu_limit(rng):
    # 5000 bank rows: above the TPU kernel's 4096-row VMEM limit, so the
    # JAX side takes its chunked merge; the port has no such limit.
    a, b, gt = corresponding_descriptors(rng, 256, noise=0.05, n_distract=4744)
    (ja, jb), (ta, tb) = _both(a, b)
    ref_kernel = match_pair_pallas(ja, jb, interpret=True)
    ref_plain = match_pair_jnp(ja, jb)
    for backend in ("plain", "kernel"):
        port = match_pair(ta, tb, backend=backend, device="cpu")
        _assert_same(port, ref_plain)
        _assert_same(port, ref_kernel)
    valid = port.valid.numpy()
    assert valid.sum() > 200
    assert np.all(port.idx.numpy()[valid] == gt[valid])


def test_kernel_raw_outputs_vs_jax(rng):
    a = random_descriptors(rng, 256)
    b = random_descriptors(rng, 384)
    a2 = (a * a).sum(1)
    b2 = (b * b).sum(1)
    b2[::11] = J_BIG  # dead bank rows
    ji1, jd1, jd2, jnnb = j_distance_topk(jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(b2), jnp.asarray(a2),
                                          interpret=True)
    before = k2.distance_topk.launches
    ti1, td1, td2, tnnb = k2.distance_topk(*(torch.from_numpy(x) for x in (a, b, b2, a2)))
    assert k2.distance_topk.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(ti1.numpy(), np.asarray(ji1))
    np.testing.assert_array_equal(tnnb.numpy(), np.asarray(jnnb))
    np.testing.assert_allclose(td1.numpy(), np.asarray(jd1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-5)
    d2_full = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    d2_full[:, ::11] = np.inf
    np.testing.assert_array_equal(ti1.numpy(), d2_full.argmin(1))


def test_fast_precision_agreement(rng):
    # bf16 inputs with fp32 accumulation on a near-tie-heavy workload.
    n = 1024
    base = random_descriptors(rng, n)
    q = base[: n // 2] + 0.15 * np.abs(rng.standard_normal((n // 2, 128))).astype(np.float32)
    q = np.vstack([q, np.abs(rng.standard_normal((n // 2, 128))).astype(np.float32)])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    (ja, jb), (ta, tb) = _both(q, base)
    ref = match_pair_jnp(ja, jb)
    fast = match_pair(ta, tb, backend="kernel", precision="fast", device="cpu")
    assert _agreement(fast, ref) >= 0.99
    jfast = match_pair_pallas(ja, jb, precision="fast", interpret=True)
    assert _agreement(fast, jfast) >= 0.99


def test_plain_is_the_anchor(rng):
    a = random_descriptors(rng, 200)
    b = random_descriptors(rng, 220)
    _, (ta, tb) = _both(a, b)
    p = match_pair_plain(ta, tb)
    k = match_pair(ta, tb, backend="kernel", device="cpu")
    np.testing.assert_array_equal(p.valid.numpy(), k.valid.numpy())
    np.testing.assert_array_equal(p.idx.numpy()[p.valid.numpy()],
                                  k.idx.numpy()[k.valid.numpy()])


def test_bad_arguments_rejected(rng):
    _, (ta, tb) = _both(random_descriptors(rng, 8), random_descriptors(rng, 8))
    with pytest.raises(ValueError, match="precision"):
        match_pair(ta, tb, backend="kernel", precision="bf16", device="cpu")
    # "pallas" and "jnp" are the JAX package's names and are taken
    # (test_backend_names_route_as_jax); an unknown name is refused.
    with pytest.raises(ValueError, match="backend"):
        match_pair(ta, tb, backend="mxu", device="cpu")


def test_default_device_is_cuda(rng):
    # The entry point runs on cuda unless asked for the CPU, and never
    # falls back: without a card it raises.
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    _, (ta, tb) = _both(random_descriptors(rng, 8), random_descriptors(rng, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        match_pair(ta, tb)


def _exact_sets(rng, n, m, w):
    """Queries and a bank whose entries are multiples of 1/4, so every dot
    product and norm is exact in float32 whatever the summation order: the
    JAX package, the plain versions and the split model must agree bit for
    bit. Bank rows repeat across every split boundary k * w (a tie the
    lower index must win), queries 0 and 1 are equal (a column tie the
    lower query must win), and every fifth bank row is dead."""
    a = rng.integers(0, 4, (n, 128)).astype(np.float32) / 4
    b = rng.integers(0, 4, (m, 128)).astype(np.float32) / 4
    a[1] = a[0]
    for k in range(w, m, w):
        b[k] = b[k - 1]
    a2 = (a * a).sum(1)
    b2 = (b * b).sum(1)
    b2[2::5] = J_BIG
    return a, b, b2, a2


@pytest.mark.parametrize("w", [1, 63, 64, 65, 4097])
def test_split_model_vs_jax(w):
    # K2's split-and-merge (distance_topk_split_plain) at width w and at the
    # kernel's own plan for this shape (132 SMs, both modes), against the
    # unsplit plain version and the JAX kernel (its 4096-row chunked merge
    # above MAX_RESIDENT_M), all exactly.
    rng = np.random.default_rng(w)
    n, m = 24, 2 * w + 3
    a, b, b2, a2 = _exact_sets(rng, n, m, w)
    if m <= 4096:
        jout = j_distance_topk(*(jnp.asarray(x) for x in (a, b, b2, a2)), interpret=True)
    else:
        jout = j_chunked_topk(*(jnp.asarray(x) for x in (a, b, b2, a2)), n, True)
    ta, tb, tb2, ta2 = (torch.from_numpy(x) for x in (a, b, b2, a2))
    plain = k2.distance_topk_plain(ta, tb, tb2, ta2)
    widths = {w} | {k2.split_plan(1, n, m, 132 * k2._BLOCKS_PER_SM[f])[1] for f in (False, True)}
    for width in sorted(widths):
        split = k2.distance_topk_split_plain(ta, tb, tb2, ta2, width)
        for got, ref, jref in zip(split, plain, jout):
            np.testing.assert_array_equal(got.numpy(), ref.numpy())
            # the chunked path's nnb runs over its dead padding rows too
            np.testing.assert_array_equal(got.numpy(), np.asarray(jref)[:len(got)])
    assert plain[0][0] == plain[0][1]  # the equal queries picked the same row


def test_split_plan_fills_the_card():
    # The main path's shapes give one wave of whole-tile splits.
    for m, fast, want in ((8192, False, (8, 1024)), (2048, False, (8, 256)),
                          (8192, True, (16, 512)), (2048, True, (16, 128))):
        assert k2.split_plan(1, 2048, m, 132 * k2._BLOCKS_PER_SM[fast]) == want
    assert k2.split_plan(1, 1, 1, 132) == (1, 128)
    assert k2.split_plan(64, 2048, 2048, 132) == (1, 2048)  # config 2: no split
    assert k2.split_plan(2, 256, 2048, 264) == (16, 128)  # a small batch splits
    splits, width = k2.split_plan(1, 1, 8193, 132)
    assert width % 128 == 0 and (splits - 1) * width < 8193 <= splits * width


@pytest.mark.parametrize("words", [4, 8, 64])
def test_binary_route_is_popcount(words):
    # K1's binary route: +-1 int8 operands summed in int32 give -2 * dot =
    # 4 * hamming - 2 * n_bits, bit for bit, against both packages' popcount.
    rng = np.random.default_rng(words)
    pa = rng.integers(0, 2 ** 32, (2, 9, words), dtype=np.uint64).astype(np.uint32)
    pb = rng.integers(0, 2 ** 32, (2, 11, words), dtype=np.uint64).astype(np.uint32)
    pb[:, 3] = pa[:, 4]  # distance 0
    pb[:, 5] = ~pa[:, 2]  # distance n_bits
    neg2 = k1.binary_neg2_plain(*(torch.from_numpy(x.view(np.int32)) for x in (pa, pb)))
    assert neg2.dtype == torch.int32
    for p in range(2):
        h = tham.hamming_distance_matrix(*(torch.from_numpy(x[p].view(np.int32))
                                           for x in (pa, pb)))
        jh = np.asarray(j_hamming_distance_matrix(jnp.asarray(pa[p]), jnp.asarray(pb[p])))
        np.testing.assert_array_equal(h.numpy(), jh)
        np.testing.assert_array_equal(neg2[p].numpy(), 4 * jh - 2 * 32 * words)
    assert int(neg2[0, 4, 3]) == -64 * words and int(neg2[0, 2, 5]) == 64 * words


# -- depth past 256 (the tile engine's depth loop) and the backend names ---------


@pytest.mark.parametrize("dim", [384, 512])
def test_depth_beyond_256_vs_jax_kernel(dim):
    """The plain version of K2 (the reference the depth loop is held to on
    the card) against the JAX kernel in interpret mode at D = 384 and 512:
    raw outputs and matcher decisions identical."""
    rng = np.random.default_rng(dim)
    a, b, gt = corresponding_descriptors(rng, 200, noise=0.02, n_distract=56)
    a = np.abs(np.concatenate([a, rng.standard_normal((200, dim - 128)) * 0.05], 1))
    b = np.abs(np.concatenate([b, rng.standard_normal((256, dim - 128)) * 0.05], 1))
    a = (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    b = (b / np.linalg.norm(b, axis=1, keepdims=True)).astype(np.float32)
    a2, b2 = (a * a).sum(1), (b * b).sum(1)
    b2[::7] = J_BIG
    ji1, jd1, jd2, jnnb = j_distance_topk(*(jnp.asarray(x) for x in (a, b, b2, a2)),
                                          interpret=True)
    k2._check_inputs(*(torch.from_numpy(x) for x in (a, b, b2, a2)))  # accepted
    ti1, td1, td2, tnnb = k2.distance_topk(*(torch.from_numpy(x) for x in (a, b, b2, a2)))
    np.testing.assert_array_equal(ti1.numpy(), np.asarray(ji1))
    np.testing.assert_array_equal(tnnb.numpy(), np.asarray(jnnb))
    np.testing.assert_allclose(td1.numpy(), np.asarray(jd1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-5)
    (ja, jb), (ta, tb) = _both(a, b)
    port = match_pair(ta, tb, backend="kernel", device="cpu")
    _assert_same(port, match_pair_pallas(ja, jb, interpret=True))
    assert port.valid.numpy().sum() > 100


def test_depth_checks_as_jax():
    """K2's input checks: D = 384 and 512 taken (the card runs them through
    the depth loop), D = 100 refused, as the JAX kernel refuses it."""
    def arrays(d):
        a, b = np.zeros((8, d), np.float32), np.zeros((16, d), np.float32)
        return a, b, np.zeros(16, np.float32), np.zeros(8, np.float32)

    for d in (384, 512):
        k2._check_inputs(*(torch.from_numpy(x) for x in arrays(d)))
    with pytest.raises(ValueError, match="dim"):
        j_distance_topk(*(jnp.asarray(x) for x in arrays(100)), interpret=True)
    with pytest.raises(ValueError, match="dim"):
        k2._check_inputs(*(torch.from_numpy(x) for x in arrays(100)))


def test_backend_names_route_as_jax(rng, monkeypatch):
    """The JAX package's backend names reach the port's routes: "jnp" the
    plain matcher, "pallas" the kernel wrapper, and the Hamming matcher's
    "mxu_jnp" the +-1 vectors through the plain matcher, equal to the JAX
    package's "mxu_jnp" bit for bit."""
    from fastmatch_tpu.matching import hamming as jham
    from fastmatch_tpu_torch.matching import matcher as tmatcher

    calls = []
    plain, fused = tmatcher.match_pair_plain, k2.match_pair_fused
    monkeypatch.setattr(tmatcher, "match_pair_plain",
                        lambda *a, **k: calls.append("plain") or plain(*a, **k))
    monkeypatch.setattr(k2, "match_pair_fused",
                        lambda *a, **k: calls.append("kernel") or fused(*a, **k))
    a, b = random_descriptors(rng, 64), random_descriptors(rng, 80)
    _, (ta, tb) = _both(a, b)
    for name, route in (("jnp", "plain"), ("plain", "plain"), ("pallas", "kernel"),
                        ("kernel", "kernel")):
        calls.clear()
        match_pair(ta, tb, backend=name, device="cpu")
        assert calls == [route], (name, calls)
    stack = lambda d: Descriptors(d.data[None], d.mask[None])  # noqa: E731
    for name, route in (("jnp", "plain"), ("pallas", "kernel")):
        calls.clear()
        tmatcher.match_batch(stack(ta), stack(tb), backend=name, device="cpu")
        assert calls == ([route] if route == "plain" else []), (name, calls)
    bits = rng.integers(0, 2 ** 32, size=(2, 300, 8), dtype=np.uint64).astype(np.uint32)
    bits[1, :150] = bits[0, :150]
    ja, jb = (j_binary_from_numpy(bits[i], 320) for i in (0, 1))
    pa, pb = (binary_descriptors_from_arrays(np.asarray(d.packed), np.asarray(d.mask),
                                             device="cpu") for d in (ja, jb))
    calls.clear()
    got = tham.match_pair_hamming(pa, pb, backend="mxu_jnp", device="cpu")
    assert calls == ["plain"]
    ref = jham.match_pair_hamming(ja, jb, backend="mxu_jnp")
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert got.valid.numpy().sum() >= 100
    both = BinaryDescriptors(pa.packed[None], pa.mask[None]), BinaryDescriptors(
        pb.packed[None], pb.mask[None])
    batched = tham.match_batch_hamming(*both, backend="mxu_jnp", device="cpu")
    for x, y in zip(batched, ref):
        np.testing.assert_array_equal(x.numpy()[0], np.asarray(y))


def test_pallas_config_hashes_alike():
    from fastmatch_tpu.pipeline import config as jconfig
    from fastmatch_tpu_torch import interop
    from fastmatch_tpu_torch.pipeline import config as tconfig

    for name in ("pallas", "jnp", "auto"):
        j = jconfig.PipelineConfig(matching=jconfig.MatchingConfig(backend=name))
        t = tconfig.PipelineConfig(matching=tconfig.MatchingConfig(backend=name))
        assert t.config_hash() == j.config_hash()
        assert interop.config_from(j).config_hash() == j.config_hash()
        assert interop.config_from(j).matching.backend == name


def _stable_sort_top2(desc_a, desc_b, ratio, cross_check):
    """``match_pair_plain`` as it took its row top-2 before: a stable
    ascending sort of the row scores (ties to the lower index)."""
    a, b = desc_a.data.float(), desc_b.data.float()
    a2, b2 = (a * a).sum(-1), (b * b).sum(-1)
    a2m = torch.where(desc_a.mask, a2, BIG)
    b2m = torch.where(desc_b.mask, b2, BIG)
    neg2 = -2.0 * (a @ b.T)
    s, idx = torch.sort(neg2 + b2m[None, :], dim=1, stable=True)
    idx1 = idx[:, 0]
    d1 = torch.clamp(s[:, 0] + a2, min=0.0)
    d2nd = torch.clamp(s[:, 1] + a2, min=0.0)
    r = torch.tensor(ratio, dtype=torch.float32)
    ok = desc_a.mask & (d1 < r * r * d2nd) & (d2nd < BIG)
    if cross_check:
        scol = neg2 + a2m[:, None]
        cm = scol.min(dim=0, keepdim=True).values
        row = torch.arange(a.shape[0])[:, None]
        nn_b = torch.where(scol == cm, row, a.shape[0]).min(dim=0).values
        ok = ok & (nn_b[idx1] == torch.arange(a.shape[0]))
    return idx1.to(torch.int32), torch.where(ok, d1, BIG), ok


@pytest.mark.parametrize("case", ["ties", "duplicate_rows", "masked_bank", "all_masked",
                                  "two_columns"])
@pytest.mark.parametrize("cross_check", [False, True])
def test_plain_top2_as_stable_sort(case, cross_check):
    """The plain matcher's argmin-and-runner-up top-2 takes the decisions,
    indices and distances of the stable sort it replaced, on inputs whose
    scores tie exactly (small-integer descriptors), banks with duplicate
    rows, partly and wholly masked banks and rows, and a two-row bank."""
    rng = np.random.default_rng(len(case) + 7 * cross_check)
    n, m = (40, 2) if case == "two_columns" else (96, 160)
    a = rng.integers(0, 3, size=(n, 16)).astype(np.float32)
    b = rng.integers(0, 3, size=(m, 16)).astype(np.float32)
    mask_a, mask_b = np.ones(n, bool), np.ones(m, bool)
    if case == "duplicate_rows":
        b[m // 2:] = b[: m - m // 2]
        a[: n // 2] = b[rng.integers(0, m, n // 2)]
    if case == "masked_bank":
        mask_b[rng.random(m) < 0.6] = False
        mask_a[rng.random(n) < 0.2] = False
        b[~mask_b] = b[0]
    if case == "all_masked":
        mask_b[:] = False
    ta = Descriptors(torch.from_numpy(a), torch.from_numpy(mask_a))
    tb = Descriptors(torch.from_numpy(b), torch.from_numpy(mask_b))
    valid = []
    for ratio in (0.8, 1.0, 1.5):
        got = match_pair_plain(ta, tb, ratio=ratio, cross_check=cross_check)
        idx, dist, ok = _stable_sort_top2(ta, tb, ratio, cross_check)
        np.testing.assert_array_equal(got.idx.numpy(), idx.numpy())
        np.testing.assert_array_equal(got.dist.numpy(), dist.numpy())
        np.testing.assert_array_equal(got.valid.numpy(), ok.numpy())
        valid.append(got.valid.numpy())
    valid = np.concatenate(valid)
    if case == "all_masked":
        assert not valid.any()
        return
    assert valid.any() and not valid.all()
    if case == "two_columns":
        return
    d2 = ((a[:, None] - b[None]) ** 2).sum(-1)[:, mask_b]
    top2 = np.sort(d2, axis=1)[:, :2]
    assert (top2[:, 0] == top2[:, 1]).any(), "no tied best and runner-up"
