"""The port's IVF search (fastmatch_tpu_torch.matching.ann, CPU) beside the
JAX package's ``matching/ann.py`` on the same inputs.

The Gumbel draws of k-means' initialization cannot replay JAX's, so the
JAX package's own ``init_idx`` (its ``kmeans``' first lines, replayed
here) is fed to ``kmeans_from_init``:

- k-means on a tie-free fixture: assignments equal, centroids within 1e-5
  of the largest centroid entry (the cluster sums run in another order:
  K4's plain version here, ``jax.ops.segment_sum`` there);
- ``build_index_sorted`` from the same draws: ``perm``, ``starts`` and
  ``assign`` equal;
- ``match_pair_ann`` and ``match_pair_ann_big`` on the JAX index carried
  across (``interop``): the same decisions, also on a fixture whose
  cluster votes tie exactly (one probe a query: integer votes), where the
  lower cluster index must win as in ``jnp.argsort``;
- the slabbed assignment equals the one-slab assignment, and two builds
  from one seed are bit-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from fastmatch_tpu.core.containers import Descriptors as JD
from fastmatch_tpu.matching import ann as jann
from synth import corresponding_descriptors, random_descriptors

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.matching import ann as tann

torch.set_num_threads(1)


def jax_init_idx(key, mask, k):
    """The initial rows of ``fastmatch_tpu.matching.ann.kmeans``."""
    g = jax.random.gumbel(key, (mask.shape[0],))
    g = jnp.where(jnp.asarray(mask), g, -jnp.inf)
    return np.array(jax.lax.top_k(g, k)[1])


def clustered_bank(rng, m, k, noise=0.08):
    centers = random_descriptors(rng, k)
    d = np.abs(centers[rng.integers(0, k, m)]
               + noise * rng.standard_normal((m, 128)).astype(np.float32))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def close_centroids(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(0)
    data = clustered_bank(rng, 1024, 16)
    mask = np.ones(1024, bool)
    mask[::9] = False
    return data, mask


def test_kmeans_with_jax_draws(bank):
    data, mask = bank
    key = jax.random.PRNGKey(3)
    cent, assign = jann.kmeans(key, jnp.asarray(data), jnp.asarray(mask), 16, iters=8)
    init = jax_init_idx(key, mask, 16)
    tc, ta = tann.kmeans_from_init(torch.from_numpy(data), torch.from_numpy(mask),
                                   torch.from_numpy(init), iters=8)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(assign))
    close_centroids(tc.numpy(), cent)
    # The slabs do not change the assignment, nor the iterations.
    sc, sa = tann.kmeans_from_init(torch.from_numpy(data), torch.from_numpy(mask),
                                   torch.from_numpy(init), iters=8, slab=100)
    np.testing.assert_array_equal(sa.numpy(), ta.numpy())
    np.testing.assert_array_equal(sc.numpy(), tc.numpy())


def test_slabbed_assignment(bank):
    data, mask = bank
    x, m = torch.from_numpy(data), torch.from_numpy(mask)
    cent = x[torch.arange(0, 1024, 64)]
    one = tann.assign_clusters(x, m, cent, slab=1 << 20)
    for slab in (1, 7, 256, 1023):
        np.testing.assert_array_equal(tann.assign_clusters(x, m, cent, slab=slab).numpy(),
                                      one.numpy())
    assert (one.numpy()[~mask] == 0).all()  # BIG everywhere: the first index


def test_init_draws_and_determinism(bank):
    """The port's draws: K distinct live rows, a pure function of the
    generator's seed (two builds bit-identical)."""
    data, mask = bank
    desc = Descriptors(torch.from_numpy(data), torch.from_numpy(mask))
    idx = tann.kmeans_init_idx(desc.mask, 16, torch.Generator().manual_seed(5)).numpy()
    assert len(set(idx.tolist())) == 16 and mask[idx].all()
    a = tann.build_index_sorted(desc, 16, generator=torch.Generator().manual_seed(5))
    b = tann.build_index_sorted(desc, 16, generator=torch.Generator().manual_seed(5))
    for x, y in zip(a, b):
        x, y = (x.data, y.data) if isinstance(x, Descriptors) else (x, y)
        assert torch.equal(x, y)


def test_build_index_sorted_with_jax_draws(bank):
    data, mask = bank
    key = jax.random.PRNGKey(1)
    ref = jann.build_index_sorted(key, JD(jnp.asarray(data), jnp.asarray(mask)), n_clusters=16)
    got = tann.build_index_sorted(Descriptors(torch.from_numpy(data), torch.from_numpy(mask)),
                                  16, init_idx=torch.from_numpy(jax_init_idx(key, mask, 16)))
    for name in ("perm", "starts", "assign"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.desc.mask.numpy(), np.asarray(ref.desc.mask))
    close_centroids(got.centroids.numpy(), ref.centroids)
    assert int(got.starts[-1]) == mask.sum()


def test_match_pair_ann_carried_index():
    rng = np.random.default_rng(0)
    a, b, _ = corresponding_descriptors(rng, 600, noise=0.08, n_distract=424)
    da = JD(jnp.asarray(np.pad(a, ((0, 424), (0, 0)))), jnp.arange(1024) < 600)
    db = JD(jnp.asarray(b), jnp.ones(1024, bool))
    index = jann.build_index(jax.random.PRNGKey(0), db, n_clusters=32)
    for n_probe, cross in ((8, True), (2, False)):
        ref = jann.match_pair_ann(da, index, n_probe=n_probe, cross_check=cross)
        got = tann.match_pair_ann(interop.descriptors_from_arrays(da.data, da.mask, "cpu"),
                                  interop.ivf_index_from_numpy(index, "cpu"), n_probe=n_probe,
                                  cross_check=cross, device="cpu")
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        v = got.valid.numpy()
        np.testing.assert_array_equal(got.idx.numpy()[v], np.asarray(ref.idx)[v])
        assert v.sum() > 100


def _big(jd_q, jidx, **kw):
    ref = jann.match_pair_ann_big(jd_q, jidx, backend="jnp", **kw)
    got = tann.match_pair_ann_big(interop.descriptors_from_arrays(jd_q.data, jd_q.mask, "cpu"),
                                  interop.ivf_index_sorted_from_numpy(jidx, "cpu"),
                                  device="cpu", **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    v = got.valid.numpy()
    np.testing.assert_array_equal(got.idx.numpy()[v], np.asarray(ref.idx)[v])
    return got


def test_match_pair_ann_big_carried_index():
    """tests/test_ann.py's coherent-query fixture, at three budgets and
    both cross-check settings; dead query rows included."""
    rng = np.random.default_rng(0)
    bank = clustered_bank(rng, 4096, 32)
    jidx = jann.build_index_sorted(jax.random.PRNGKey(0), JD(jnp.asarray(bank),
                                                             jnp.ones(4096, bool)),
                                   n_clusters=32)
    rows = np.asarray(jidx.perm)[np.isin(np.asarray(jidx.assign), [3, 7, 11, 19])]
    q = bank[rng.choice(rows, 256)] + 0.03 * rng.standard_normal((256, 128)).astype(np.float32)
    q = np.abs(q)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qmask = np.ones(256, bool)
    qmask[::11] = False
    jq = JD(jnp.asarray(q), jnp.asarray(qmask))
    for budget, n_probe, cross in ((1024, 6, True), (512, 8, False), (8192, 4, True)):
        got = _big(jq, jidx, budget=budget, n_probe=n_probe, cross_check=cross)
        assert got.valid.sum() > 50


def test_match_pair_ann_big_tied_votes():
    """Two clusters probed by equally many queries (one probe each: integer
    votes, an exact tie in both packages) and a budget that admits one of
    them: the lower cluster index wins, as ``jnp.argsort`` orders ties."""
    rng = np.random.default_rng(2)
    centers = np.eye(8, 128, dtype=np.float32) + 0.2
    lab = np.repeat(np.arange(8), 64)
    bank = centers[lab] + 0.01 * np.abs(rng.standard_normal((512, 128))).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    jidx = jann.build_index_sorted(jax.random.PRNGKey(0), JD(jnp.asarray(bank),
                                                             jnp.ones(512, bool)),
                                   n_clusters=8)
    assign = np.asarray(jidx.assign)
    perm = np.asarray(jidx.perm)
    sizes = np.diff(np.asarray(jidx.starts))
    live = np.flatnonzero(sizes >= 20)
    c_lo, c_hi = live[0], live[-1]
    src = np.concatenate([rng.choice(perm[assign == c], 20, replace=False)
                          for c in (c_hi, c_lo)])
    q = bank[src] + 0.002 * rng.standard_normal((40, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jq = JD(jnp.asarray(q), jnp.ones(40, bool))
    budget = int(max(sizes[c_lo], sizes[c_hi]))
    assert budget < sizes[c_lo] + sizes[c_hi]
    got = _big(jq, jidx, budget=budget, n_probe=1, cross_check=False)
    votes = tann.cluster_votes(tann._probes(torch.from_numpy(q),
                                            torch.from_numpy(np.array(jidx.centroids)), 1),
                               torch.ones(40, dtype=torch.bool), 8)
    assert votes[c_lo] == votes[c_hi] == 20
    v = got.valid.numpy()
    # Only the lower cluster's queries (the last 20) found their rows.
    assert v[20:].sum() > 10 and not v[:20].any()
