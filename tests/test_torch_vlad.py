"""The port's VLAD encoder (fastmatch_tpu_torch.matching.vlad, CPU) beside
the JAX package's ``matching/vlad.py`` on the same inputs.

- ``train_vocabulary`` fed the JAX package's own k-means draws: words
  within 1e-5 of the largest entry;
- ``vlad_encode`` and ``vlad_encode_batch`` against a carried vocabulary
  (``interop.vocabulary_from_numpy``) within 1e-5, masked rows ignored,
  an all-masked set encoding to zeros;
- ``retrieve`` orders ties as ``lax.top_k`` does (the lower frame id
  first, dead rows at -inf last), ids equal to the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from fastmatch_tpu.matching import vlad as jvlad
from synth import random_descriptors
from test_torch_ann import jax_init_idx

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.matching import vlad as tvlad

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture(scope="module")
def vocab():
    rng = np.random.default_rng(0)
    sample = random_descriptors(rng, 2048)
    jv = jvlad.train_vocabulary(jax.random.PRNGKey(4), jnp.asarray(sample),
                                jnp.ones(2048, bool), n_words=16)
    return sample, jv


def test_train_vocabulary_with_jax_draws(vocab):
    sample, jv = vocab
    init = jax_init_idx(jax.random.PRNGKey(4), np.ones(2048, bool), 16)
    tv = tvlad.train_vocabulary(sample, np.ones(2048, bool), n_words=16,
                                init_idx=torch.from_numpy(init), device="cpu")
    ref = np.asarray(jv.words)
    np.testing.assert_allclose(tv.words.numpy(), ref, rtol=TOL, atol=TOL * np.abs(ref).max())


def test_encode_against_carried_vocabulary(vocab):
    _, jv = vocab
    tv = interop.vocabulary_from_numpy(jv, device="cpu")
    rng = np.random.default_rng(1)
    desc = random_descriptors(rng, 6 * 200).reshape(6, 200, 128)
    mask = rng.random((6, 200)) < 0.8
    mask[3] = False  # an all-masked set
    desc[~mask] = 100.0  # masked rows must not count
    ref = np.asarray(jvlad.vlad_encode_batch(jnp.asarray(desc), jnp.asarray(mask), jv))
    got = tvlad.vlad_encode_batch(torch.from_numpy(desc), torch.from_numpy(mask), tv).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)
    assert (got[3] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(got[[0, 1, 2, 4, 5]], axis=1), 1.0, atol=1e-5)
    one = tvlad.vlad_encode(torch.from_numpy(desc[1]), torch.from_numpy(mask[1]), tv).numpy()
    np.testing.assert_allclose(one, np.asarray(jvlad.vlad_encode(
        jnp.asarray(desc[1]), jnp.asarray(mask[1]), jv)), atol=TOL)


def test_retrieve_orders_ties_as_top_k():
    rng = np.random.default_rng(2)
    db = rng.standard_normal((10, 32)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    db[[2, 5, 7]] = db[4]   # four equal rows: equal scores
    db_mask = np.ones(10, bool)
    db_mask[[5, 9]] = False
    q = np.stack([db[4], rng.standard_normal(32).astype(np.float32)])
    for topk in (3, 8, 10):
        rs, ri = jax.lax.top_k(jnp.where(jnp.asarray(db_mask)[None, :],
                                         jnp.asarray(q) @ jnp.asarray(db).T, -jnp.inf), topk)
        ts, ti = tvlad.retrieve(torch.from_numpy(q), torch.from_numpy(db),
                                torch.from_numpy(db_mask), topk=topk)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs), atol=1e-6)
        jr = jvlad.retrieve(jnp.asarray(q), jnp.asarray(db), jnp.asarray(db_mask), topk=topk)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(jr[1]))
    assert ti.numpy()[0, :3].tolist() == [2, 4, 7]  # the tie, lower id first
    assert ti.numpy()[0, -2:].tolist() == [5, 9]    # dead rows last
