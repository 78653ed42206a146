"""The port's batched matching (fastmatch_tpu_torch, CPU) against the JAX
package's: the K1 wrapper ``match_batch_fused`` (which takes its plain
version on CPU tensors) against ``match_batch_fused(interpret=True)`` and
``match_pair_jnp``, ``match_batch``, and the binary matchers of
``matching/hamming.py`` with the packing helpers.

Tolerances, with reasons: decisions (valid, idx where valid) are compared
exactly on these fixtures, which have no near-ties; distances to rtol/atol
1e-5 (the two frameworks sum the 128-term dot products and the norms in
different orders, a few float32 ulps apart). Fast mode rounds the operands
to bf16, so it is held to the >= 99% decision agreement the JAX package
holds its own fast path to. Binary matching is exact integer arithmetic in
every route and is compared for equality, distances included.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.core.containers import Descriptors as JDescriptors
from fastmatch_tpu.core.containers import binary_descriptors_from_numpy as j_binary_from_numpy
from fastmatch_tpu.core.containers import pack_bits as j_pack_bits
from fastmatch_tpu.core.containers import unpack_bits_signed as j_unpack
from fastmatch_tpu.kernels.batch_match import match_batch_fused as j_match_batch_fused
from fastmatch_tpu.matching import hamming as jham
from fastmatch_tpu.matching.matcher import match_batch as j_match_batch
from fastmatch_tpu.matching.matcher import match_pair_jnp
from fastmatch_tpu.utils.evaluation import match_agreement as j_match_agreement

from fastmatch_tpu_torch.core.containers import (BinaryDescriptors, Descriptors,
                                                 binary_descriptors_from_numpy, pack_bits,
                                                 unpack_bits_signed)
from fastmatch_tpu_torch.interop import (ba_problem_from_numpy,
                                         batched_descriptors_from_numpy,
                                         binary_descriptors_from_arrays,
                                         descriptors_from_arrays,
                                         reconstruction_from_numpy)
from fastmatch_tpu_torch.kernels import batch_match as k1
from fastmatch_tpu_torch.kernels import distance_topk as k2
from fastmatch_tpu_torch.matching import hamming as tham
from fastmatch_tpu_torch.matching.matcher import match_batch
from fastmatch_tpu_torch.utils.evaluation import match_agreement

torch.set_num_threads(1)


def _unit(rng, n):
    d = np.abs(rng.standard_normal((n, 128))).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def make_batch():
    """B=3 pairs, N=256 queries, M=384 bank rows, about half to all live,
    the bank holding noisy copies of half the live queries; pair 1 has a single-entry bank (no second neighbour, no match), pair 2 a
    fully masked query set. Returns (data_a, mask_a, data_b, mask_b)."""
    rng = np.random.default_rng(1)
    B, N, M = 3, 256, 384

    def mkd(cap):
        k = int(rng.integers(cap // 2, cap + 1))
        d = np.zeros((cap, 128), np.float32)
        m = np.zeros(cap, bool)
        d[:k] = _unit(rng, k)
        m[:k] = True
        return d, m

    da = [mkd(N) for _ in range(B)]
    db = [mkd(M) for _ in range(B)]
    for (qa, ka), (qb, kb) in zip(da, db):  # noisy copies of half the live queries
        n_shared = min(ka.sum(), kb.sum()) // 2
        rows = rng.choice(int(kb.sum()), n_shared, replace=False)
        noisy = np.abs(qa[:n_shared] + 0.05 * rng.standard_normal((n_shared, 128)))
        qb[rows] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    db[1][1][:] = False
    db[1][1][:1] = True
    da[2][1][:] = False
    return tuple(np.stack([x[i] for x in arr]) for arr in (da, db) for i in (0, 1))


@pytest.fixture(scope="module")
def batch():
    return make_batch()


def _jax(a, ma, b, mb):
    return JDescriptors(jnp.asarray(a), jnp.asarray(ma)), JDescriptors(jnp.asarray(b), jnp.asarray(mb))


def _port(a, ma, b, mb):
    return (descriptors_from_arrays(a, ma, device="cpu"),
            descriptors_from_arrays(b, mb, device="cpu"))


def _assert_same(port, ref, exact_dist=False):
    valid = port.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    np.testing.assert_array_equal(port.idx.numpy()[valid], np.asarray(ref.idx)[valid])
    if exact_dist:
        np.testing.assert_array_equal(port.dist.numpy(), np.asarray(ref.dist))
    else:
        np.testing.assert_allclose(port.dist.numpy()[valid], np.asarray(ref.dist)[valid],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("ratio", [0.8, 1.0])
def test_exact_vs_jax_kernel_and_anchor(batch, cross_check, ratio):
    a, ma, b, mb = batch
    ref = j_match_batch_fused(*_jax(a, ma, b, mb), ratio=ratio, cross_check=cross_check,
                              interpret=True)
    before = k1.match_batch_fused.launches
    port = k1.match_batch_fused(*_port(a, ma, b, mb), ratio=ratio, cross_check=cross_check)
    assert k1.match_batch_fused.launches == before  # CPU tensors: the plain version
    _assert_same(port, ref)
    for i in range(a.shape[0]):
        anchor = match_pair_jnp(*_jax(a[i], ma[i], b[i], mb[i]), ratio, cross_check=cross_check)
        row = type(port)(*(f[i] for f in port))
        _assert_same(row, anchor)
    assert not port.valid.numpy()[1].any() and not port.valid.numpy()[2].any()
    assert port.valid.numpy()[0].sum() > 50


def test_fast_agreement_vs_jax(batch):
    """bf16 operands: decision agreement with the exact anchor and with the
    JAX package's fast kernel; measured 1.0 and 1.0 on this fixture (94
    valid matches, none near a tie), against the 0.99 gate."""
    a, ma, b, mb = batch
    ja, jb = _jax(a, ma, b, mb)
    ta, tb = _port(a, ma, b, mb)
    jfast = j_match_batch_fused(ja, jb, fast=True, interpret=True)
    fast = k1.match_batch_fused(ta, tb, fast=True)
    exact = k1.match_batch_fused_plain(ta, tb)
    assert float(match_agreement(fast.idx, fast.valid, exact.idx, exact.valid, ta.mask)) >= 0.99
    assert float(match_agreement(fast.idx, fast.valid, torch.from_numpy(np.asarray(jfast.idx)),
                                 torch.from_numpy(np.asarray(jfast.valid)), ta.mask)) >= 0.99


def test_fast_on_bf16_values_is_exact(batch):
    # Operands already bf16-representable: the cast is exact, so fast mode
    # makes the anchor's decisions (the JAX package's own fast-path test).
    a, ma, b, mb = batch
    q = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    aq, bq = q(a), q(b)
    port = k1.match_batch_fused(*_port(aq, ma, bq, mb), fast=True)
    ref = j_match_batch_fused(*_jax(aq, ma, bq, mb), fast=True, interpret=True)
    _assert_same(port, ref)


def test_match_agreement_vs_jax(rng):
    idx_a, idx_b = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
    va, vb, mask = rng.random(200) < 0.5, rng.random(200) < 0.5, rng.random(200) < 0.7
    for m in (None, mask):
        ref = j_match_agreement(jnp.asarray(idx_a), jnp.asarray(va), jnp.asarray(idx_b),
                                jnp.asarray(vb), None if m is None else jnp.asarray(m))
        got = match_agreement(torch.from_numpy(idx_a), torch.from_numpy(va),
                              torch.from_numpy(idx_b), torch.from_numpy(vb),
                              None if m is None else torch.from_numpy(m))
        assert abs(float(got) - float(ref)) < 1e-6


@pytest.mark.parametrize("backend", ["plain", "kernel"])
def test_match_batch_vs_jax(batch, backend):
    a, ma, b, mb = batch
    ref = j_match_batch(*_jax(a, ma, b, mb), backend="jnp")
    _assert_same(match_batch(*_port(a, ma, b, mb), backend=backend, device="cpu"), ref)


def test_match_batch_large_bank_takes_per_pair_route(monkeypatch):
    """Banks above MAX_RESIDENT_M go to a loop of match_pair (K2), as the
    JAX package's match_batch vmaps its per-pair kernel there."""
    rng = np.random.default_rng(5)
    B, N, M = 2, 64, 4104
    a = np.stack([_unit(rng, N) for _ in range(B)])
    b = np.stack([_unit(rng, M) for _ in range(B)])
    b[:, :N] = np.abs(a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)
    b[:, :N] /= np.linalg.norm(b[:, :N], axis=-1, keepdims=True)
    ma, mb = np.ones((B, N), bool), np.ones((B, M), bool)
    calls = []
    real = k2.distance_topk

    def spy(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the batched kernel takes banks of at most 4096 rows")

    monkeypatch.setattr(k2, "distance_topk", spy)
    monkeypatch.setattr(k1, "match_batch_fused", refuse)
    port = match_batch(*_port(a, ma, b, mb), backend="kernel", device="cpu")
    assert calls == [(M, 128)] * B
    ref = j_match_batch(*_jax(a, ma, b, mb), backend="jnp")
    _assert_same(port, ref)
    assert port.valid.numpy().sum() > N


def _err(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_input_errors_as_jax():
    z = lambda *s: np.zeros(s, np.float32)
    zu = lambda *s: np.zeros(s, np.uint32)
    t = lambda *s: np.ones(s, bool)
    cases = [  # (a, b, kwargs): the JAX wrapper's refusals
        (zu(1, 8, 8), zu(1, 8, 8), dict(binary=True, fast=True)),             # no const_sq_norm
        (zu(1, 8, 8), zu(1, 8, 8), dict(binary=True, const_sq_norm=256.0)),   # not fast
        (z(1, 8, 8), z(1, 8, 8), dict(binary=True, fast=True, const_sq_norm=256.0)),  # floats
        (zu(1, 8, 3), zu(1, 8, 3), dict(binary=True, fast=True, const_sq_norm=96.0)),  # 96 bits
        (z(1, 8, 128), z(1, 8, 256), {}),
        (z(1, 8, 64), z(1, 8, 64), {}),
        (z(1, 8, 128), z(1, 4097, 128), {}),
    ]
    for a, b, kw in cases:
        ja = JDescriptors(jnp.asarray(a), jnp.asarray(t(*a.shape[:2])))
        jb = JDescriptors(jnp.asarray(b), jnp.asarray(t(*b.shape[:2])))
        jmsg = _err(lambda: j_match_batch_fused(ja, jb, interpret=True, **kw))
        conv = (lambda x: torch.from_numpy(x.view(np.int32))) if a.dtype == np.uint32 else torch.from_numpy
        ta = Descriptors(conv(a), torch.from_numpy(t(*a.shape[:2])))
        tb = Descriptors(conv(b), torch.from_numpy(t(*b.shape[:2])))
        for fn in (k1.match_batch_fused, k1.match_batch_fused_plain):
            tmsg = _err(lambda: fn(ta, tb, **kw))
            assert tmsg.split()[0] == jmsg.split()[0], (tmsg, jmsg)


# -- binary descriptors ------------------------------------------------------------


def _random_packed(rng, n, w=8):
    return rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint64).astype(np.uint32)


def test_pack_unpack_vs_jax():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(17, 256)).astype(bool)
    packed = pack_bits(torch.from_numpy(bits))
    ref = np.asarray(j_pack_bits(jnp.asarray(bits)))
    assert packed.shape == (17, 8) and packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), ref)
    mask = np.arange(17) % 4 != 1
    signed = unpack_bits_signed(packed, torch.from_numpy(mask))
    np.testing.assert_array_equal(signed.numpy(),
                                  np.asarray(j_unpack(jnp.asarray(ref), jnp.asarray(mask))))
    np.testing.assert_array_equal(signed.numpy()[mask], 2.0 * bits[mask] - 1.0)
    assert (signed.numpy()[~mask] == 0).all()
    with pytest.raises(ValueError):
        pack_bits(torch.zeros((2, 33), dtype=torch.bool))


def test_binary_containers_vs_jax():
    rng = np.random.default_rng(3)
    words = _random_packed(rng, 300)
    ref = j_binary_from_numpy(words, 512)
    port = binary_descriptors_from_numpy(words, 512, device="cpu")
    np.testing.assert_array_equal(port.packed.numpy().view(np.uint32), np.asarray(ref.packed))
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    assert port.n_bits == ref.n_bits == 256 and int(port.count()) == int(ref.count()) == 300
    arr = binary_descriptors_from_arrays(np.asarray(ref.packed), np.asarray(ref.mask),
                                         device="cpu")
    assert torch.equal(arr.packed, port.packed)
    with pytest.raises(ValueError):
        binary_descriptors_from_numpy(words.astype(np.int64))


def test_hamming_matrix_vs_jax():
    rng = np.random.default_rng(1)
    a, b = _random_packed(rng, 33), _random_packed(rng, 57)
    ref = np.asarray(jham.hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tham.hamming_distance_matrix(torch.from_numpy(a.view(np.int32)),
                                       torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), ref)
    bits_a = np.unpackbits(a.view(np.uint8), axis=1)
    bits_b = np.unpackbits(b.view(np.uint8), axis=1)
    np.testing.assert_array_equal(got.numpy(), (bits_a[:, None] != bits_b[None]).sum(-1))


@pytest.mark.parametrize("ratio", [0.7, 0.75, 0.8, 0.9])
def test_ratio_sqrt_as_jax(ratio):
    r = tham._ratio_sqrt(ratio)
    assert r == jham._ratio_sqrt(ratio)
    sq = np.float32(np.float32(r) * np.float32(r))
    assert abs(sq - np.float32(ratio)) <= np.spacing(np.float32(ratio))  # 0.8 has no exact root


@pytest.fixture(scope="module")
def banks():
    """tests/test_orb.py's near-duplicate banks: 300 random 256-bit rows,
    half re-drawn and half with a few bits flipped, at capacity 512."""
    rng = np.random.default_rng(2)
    a = _random_packed(rng, 300)
    b = a.copy()
    b[:150] = _random_packed(rng, 150)
    flip = rng.integers(0, 2, size=(150, 8), dtype=np.uint64).astype(np.uint32)
    flip &= _random_packed(rng, 150) & _random_packed(rng, 150)
    b[150:] ^= flip
    return j_binary_from_numpy(a, 512), j_binary_from_numpy(b, 512)


def _port_binary(j):
    return binary_descriptors_from_arrays(np.asarray(j.packed), np.asarray(j.mask),
                                          device="cpu")


@pytest.mark.parametrize("backend", ["popcount", "mxu"])
def test_match_pair_hamming_vs_jax(banks, backend):
    ja, jb = banks
    ref = jham.match_pair_hamming_jnp(ja, jb, ratio=0.8)
    port = tham.match_pair_hamming(_port_binary(ja), _port_binary(jb), ratio=0.8,
                                   backend=backend, device="cpu")
    _assert_same(port, ref, exact_dist=True)
    assert 100 < port.valid.numpy().sum() <= 150


def test_match_batch_hamming_vs_jax(banks):
    """K1 in binary mode (plain version on the CPU) against the JAX
    package's batched kernel route and the popcount anchor: identical,
    distances included."""
    ja, jb = banks
    stack = lambda d: jax.tree.map(lambda x: jnp.stack([x, x[::-1]]), d)
    jab, jbb = stack(ja), stack(jb)
    ref = jham.match_batch_hamming(jab, jbb, ratio=0.8, backend="mxu")
    anchor = jham.match_batch_hamming(jab, jbb, ratio=0.8, backend="popcount")
    ta, tb = _port_binary(jab), _port_binary(jbb)
    before = k1.match_batch_fused.launches
    for backend in ("mxu", "popcount"):
        port = tham.match_batch_hamming(ta, tb, ratio=0.8, backend=backend, device="cpu")
        _assert_same(port, ref, exact_dist=True)
        _assert_same(port, anchor, exact_dist=True)
    assert k1.match_batch_fused.launches == before
    plain = k1.match_batch_fused_plain(Descriptors(ta.packed, ta.mask), Descriptors(tb.packed, tb.mask),
                                       ratio=tham._ratio_sqrt(0.8), fast=True, const_sq_norm=256.0,
                                       binary=True)
    np.testing.assert_array_equal(plain.dist.numpy()[plain.valid.numpy()] % 4, 0)


def test_batched_descriptors_from_numpy():
    rng = np.random.default_rng(4)
    sets = [_unit(rng, n) for n in (10, 300, 40)]
    d = batched_descriptors_from_numpy(sets, 256, device="cpu")
    assert d.data.shape == (3, 256, 128) and d.mask.sum(-1).tolist() == [10, 256, 40]
    np.testing.assert_array_equal(d.data.numpy()[0, :10], sets[0])
    assert (d.data.numpy()[0, 10:] == 0).all()


def test_default_device_is_cuda(banks):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    ta, tb = _port_binary(banks[0]), _port_binary(banks[1])
    stack = lambda d: BinaryDescriptors(d.packed[None], d.mask[None])
    da = Descriptors(torch.zeros((1, 8, 128)), torch.ones((1, 8), dtype=torch.bool))
    z = np.zeros
    # The interop constructors resolve their device before reading any input.
    for call in (lambda: match_batch(da, da),
                 lambda: tham.match_batch_hamming(stack(ta), stack(tb)),
                 lambda: tham.match_pair_hamming(ta, tb),
                 lambda: descriptors_from_arrays(z((4, 128)), z(4, bool)),
                 lambda: batched_descriptors_from_numpy([z((3, 128))], 8),
                 lambda: binary_descriptors_from_arrays(z((4, 8), np.uint32), z(4, bool)),
                 lambda: ba_problem_from_numpy(z((1, 3, 3)), z((1, 3)), z((2, 3)), z(2), z(2),
                                               z((2, 2)), z(2, bool), z(1, bool), z(2, bool),
                                               z(1, bool)),
                 lambda: reconstruction_from_numpy({}, None, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# -- depth past 256 (the tile engine's depth loop) -----------------------------------


@pytest.mark.parametrize("dim", [384, 512])
def test_depth_beyond_256_vs_jax_kernel(dim):
    """K1's plain version (the reference the depth loop is held to on the
    card) against the JAX kernel in interpret mode at D = 384 and 512: exact
    mode's decisions identical, distances to 1e-5."""
    rng = np.random.default_rng(dim)
    B, N, M = 2, 128, 256
    a = np.abs(rng.standard_normal((B, N, dim))).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b = np.abs(rng.standard_normal((B, M, dim))).astype(np.float32)
    b[:, :N] = np.abs(a[:, rng.permutation(N)]
                      + 0.05 * np.sqrt(128 / dim) * rng.standard_normal((B, N, dim)))
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    ma, mb = np.ones((B, N), bool), np.ones((B, M), bool)
    mb[:, ::9] = False
    ref = j_match_batch_fused(*_jax(a, ma, b, mb), interpret=True)
    port = k1.match_batch_fused(*_port(a, ma, b, mb))
    _assert_same(port, ref)
    assert port.valid.numpy().sum() > 50


def test_depth_checks_as_jax():
    """K1's input checks: D = 384 and 512 and 128 packed words (4096 bits)
    taken on any device (the card runs them through the depth loop); D =
    100 refused, as the JAX kernel refuses it."""
    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    ones = np.ones((1, 8), bool)
    for d in (384, 512):
        k1._prepare(*_port(z(1, 8, d), ones, z(1, 16, d), np.ones((1, 16), bool)), 0.8,
                    False, None, False)
    words = np.zeros((1, 8, 128), np.int32)
    k1._prepare(Descriptors(torch.from_numpy(words), torch.from_numpy(ones)),
                Descriptors(torch.from_numpy(words), torch.from_numpy(ones)), 0.8, True,
                4096.0, True)
    jmsg = _err(lambda: j_match_batch_fused(*_jax(z(1, 8, 100), ones, z(1, 8, 100), ones),
                                            interpret=True))
    tmsg = _err(lambda: k1.match_batch_fused(*_port(z(1, 8, 100), ones, z(1, 8, 100), ones)))
    assert tmsg.split()[0] == jmsg.split()[0] == "descriptor"
