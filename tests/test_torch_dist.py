"""The port's distributed routes (``fastmatch_tpu_torch.dist``) on gloo
ranks, beside tests/test_dist.py's single-device anchors in both packages.

Four ranks are spawned once (``dist_ranks.dist_cases``); each builds a
(1, 4) mesh and a (2, 2) mesh, whose ``bank`` groups are rings of two
ranks and whose ``data`` groups split a batch in two, and a (4, 1) mesh:

- the ring matcher (``match_pair_sharded``, at bank sizes 4 and 2, and on
  adversarial masks) makes JAX ``match_pair_jnp``'s decisions: ``valid``
  and ``idx`` equal, ``dist`` within 1e-6, the same bits on every rank;
- ``match_batch_dp`` equals JAX ``match_batch`` (data sizes 2 and 4);
- ``ba_solve_sharded`` is within atol 5e-3 of the port's and the JAX
  package's single-device ``ba_solve`` (the all-reduce adds in its own
  order), and pads a table whose size does not divide;
- ``retrieve_sharded`` equals the unsharded ``vlad.retrieve`` of both
  packages bit for bit on scores whose sums are exact;
- ``broadcast_config`` carries rank 0's (or the marked rank's) config to
  every rank; ``make_mesh`` rejects a shape that is not the world size;
- ``replicated`` leaves the whole tensor on every rank of each mesh, as
  JAX's ``replicated`` puts it on every device of a (2, 4) mesh.

In this process: the ring step over slabs (``ring_step``, what
``chip_smoke.py``'s ``dist_paths`` runs on one card), ``OverlapScheduler``
against the serial schedule, the bootstrap's fail-fast errors, and BA with
``reduce=None`` bit-identical to the solve before the hook existed.
"""

import hashlib

import numpy as np
import pytest
import torch

import dist_ranks
import jax.numpy as jnp
from synth import corresponding_descriptors, random_descriptors
from test_torch_ba import jax_problem, problem_arrays

from fastmatch_tpu.ba.lm import ba_solve as jax_ba_solve
from fastmatch_tpu.core.containers import Descriptors as JDescriptors
from fastmatch_tpu.matching.matcher import match_batch as jax_match_batch
from fastmatch_tpu.matching.matcher import match_pair_jnp
from fastmatch_tpu.matching.vlad import retrieve as jax_retrieve
from fastmatch_tpu_torch.ba import lm as tlm
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.dist import bootstrap
from fastmatch_tpu_torch.dist.overlap import OverlapScheduler
from fastmatch_tpu_torch.dist.sharded_match import ring_start, ring_step
from fastmatch_tpu_torch.interop import ba_problem_from_numpy
from fastmatch_tpu_torch.matching.matcher import BIG, match_pair_plain
from fastmatch_tpu_torch.matching.vlad import retrieve
from fastmatch_tpu_torch.pipeline.config import MatchingConfig, PipelineConfig

torch.set_num_threads(1)

WORLD = 4
BA_KW = dict(max_iters=12, pcg_iters=40)
TOPK = 5


def _padded(d, capacity):
    data = np.zeros((capacity, d.shape[1]), np.float32)
    data[:len(d)] = d
    mask = np.zeros(capacity, bool)
    mask[:len(d)] = True
    return data, mask


def _exact_vlad(rng, n, dim=64):
    """Rows of multiples of 1/8 (every product sum exact), some repeated."""
    x = rng.integers(-1, 2, (n, dim)).astype(np.float32) / 8.0
    x[1::7] = x[0]
    return x


def _inputs():
    rng = np.random.default_rng(0)
    a, b, _ = corresponding_descriptors(rng, 700, noise=0.07, n_distract=324)
    ring = (_padded(a, 1024), _padded(b, 2048))
    adv = ((random_descriptors(rng, 512), np.arange(512) % 3 != 0),
           (random_descriptors(rng, 1024), np.arange(1024) % 5 != 2))
    pairs = [corresponding_descriptors(rng, 100, noise=0.1, n_distract=28) for _ in range(4)]
    dp = tuple((np.stack([_padded(p[i], 128)[0] for p in pairs]),
                np.stack([_padded(p[i], 128)[1] for p in pairs])) for i in (0, 1))
    db_mask = np.ones(64, bool)
    db_mask[5::9] = False
    retr = (_exact_vlad(rng, 6), _exact_vlad(rng, 64), db_mask)
    return dict(ring=ring, adversarial=adv, dp=dp, retrieve=retr, topk=TOPK,
                replicated=rng.standard_normal((8, 5)).astype(np.float32),
                ba=problem_arrays(seed=4, n_frames=6, n_points=100, noise_px=0.0, perturb=0.04),
                ba_kw=BA_KW,
                ba_pad=problem_arrays(seed=5, n_frames=4, n_points=40, cap_obs=250))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory, inputs):
    return dist_ranks.once(request, tmp_path_factory, "torch_dist_cases",
                           lambda: dist_ranks.spawn(dist_ranks.dist_cases, WORLD, inputs))


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        got = r[key]
        if isinstance(first, dict):
            assert all(np.array_equal(first[k], got[k]) for k in first), key
        elif isinstance(first, tuple):
            assert all(np.array_equal(x, y) for x, y in zip(first, got)), key
        else:
            assert first == got, key
    return first


def _jax_pair(x):
    (a, ma), (b, mb) = x
    return match_pair_jnp(JDescriptors(jnp.asarray(a), jnp.asarray(ma)),
                          JDescriptors(jnp.asarray(b), jnp.asarray(mb)))


def _decisions_equal(got, ref, dist_tol=None):
    np.testing.assert_array_equal(got["valid"], np.asarray(ref.valid))
    v = got["valid"]
    np.testing.assert_array_equal(got["idx"][v], np.asarray(ref.idx)[v])
    if dist_tol is not None:
        np.testing.assert_allclose(got["dist"][v], np.asarray(ref.dist)[v], rtol=dist_tol,
                                   atol=dist_tol)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_ring_equals_unsharded(ranks, inputs, mesh):
    got = _same_on_every_rank(ranks, f"ring_{mesh}")
    assert 300 < got["valid"].sum() < 700
    _decisions_equal(got, _jax_pair(inputs["ring"]), dist_tol=1e-6)
    # And the port's own unsharded anchor, bit for bit (idx where valid: a
    # dead query's idx is no decision).
    ref = match_pair_plain(*(Descriptors(torch.from_numpy(d), torch.from_numpy(m))
                             for d, m in inputs["ring"]))
    for k in ("dist", "valid"):
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy())
    v = got["valid"]
    np.testing.assert_array_equal(got["idx"][v], ref.idx.numpy()[v])


def test_ring_adversarial_masks(ranks, inputs):
    got = _same_on_every_rank(ranks, "adversarial")
    _decisions_equal(got, _jax_pair(inputs["adversarial"]))


def test_ring_step_over_slabs(inputs):
    """One rank's ring run alone: ``ring_step`` over 4 slabs of the bank,
    starting from each slab in turn, equals the unsharded matcher."""
    (a, ma), (b, mb) = (tuple(torch.from_numpy(x) for x in p) for p in inputs["ring"])
    a2m = torch.where(ma, (a * a).sum(-1), BIG)
    b2m = torch.where(mb, (b * b).sum(-1), BIG)
    ref = match_pair_plain(Descriptors(a, ma), Descriptors(b, mb), ratio=1.0, cross_check=False)
    slabs = 4
    ms = b.shape[0] // slabs
    for start in range(slabs):
        acc = ring_start(a.shape[0], a.device)
        for s in range(slabs):
            owner = (start - s) % slabs
            acc, _ = ring_step(acc, a, a2m, b[owner * ms:(owner + 1) * ms],
                               b2m[owner * ms:(owner + 1) * ms], owner)
        d1, i1, d2, _ = acc
        ok = ma & (d1 < d2) & (d2 < BIG)
        assert torch.equal(ok, ref.valid), start
        assert torch.equal(i1[ok], ref.idx[ok]), start
        assert torch.equal(d1[ok], ref.dist[ok]), start


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_dp_batch_equals_local(ranks, inputs, mesh):
    got = _same_on_every_rank(ranks, f"dp_{mesh}")
    (da, ma), (db, mb) = inputs["dp"]
    ref = jax_match_batch(JDescriptors(jnp.asarray(da), jnp.asarray(ma)),
                          JDescriptors(jnp.asarray(db), jnp.asarray(mb)))
    _decisions_equal(got, ref)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_sharded_ba_equals_single(ranks, inputs, mesh):
    got = _same_on_every_rank(ranks, f"ba_{mesh}")
    # The all-reduce changes the summation order: equality to tolerance.
    assert got["cost"] < got["cost0"] * 1e-2
    port = tlm.ba_solve(ba_problem_from_numpy(*inputs["ba"], device="cpu"), device="cpu",
                        **BA_KW)
    jres = jax_ba_solve(jax_problem(inputs["ba"]), **BA_KW)
    for ref_t, ref_x in ((port.poses.t.numpy(), port.points.numpy()),
                         (np.asarray(jres.poses.t), np.asarray(jres.points))):
        np.testing.assert_allclose(got["t"], ref_t, atol=5e-3)
        np.testing.assert_allclose(got["points"], ref_x, atol=5e-3)


def test_obs_padding(ranks):
    # Capacity 250 does not divide by 4: padded with dead observations.
    got = _same_on_every_rank(ranks, "padding")
    assert got["cost"] <= got["cost0"]


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_retrieve_sharded_equals_unsharded(ranks, inputs, mesh):
    v, ids = _same_on_every_rank(ranks, f"retrieve_{mesh}")
    q, db, dm = inputs["retrieve"]
    rv, rids = retrieve(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(dm), TOPK)
    jv, jids = jax_retrieve(jnp.asarray(q), jnp.asarray(db), jnp.asarray(dm), topk=TOPK)
    assert np.isfinite(v).all() and len(np.unique(v)) < v.size  # ties among the scores
    for ref_v, ref_i in ((rv.numpy(), rids.numpy()), (np.asarray(jv), np.asarray(jids))):
        np.testing.assert_array_equal(v, ref_v)
        np.testing.assert_array_equal(ids, ref_i)


def test_broadcast_config(ranks):
    for key, src in (("config_rank0", 0), ("config_rank1", WORLD - 1)):
        cfgs = [r[key] for r in ranks]
        want = PipelineConfig(matching=MatchingConfig(ratio=0.5 + 0.1 * src))
        assert all(c == want for c in cfgs), key
        assert all(c.config_hash() == want.config_hash() for c in cfgs)


def test_overlap_results_equal_serial():
    rng = np.random.default_rng(0)
    blocks = [torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
              for _ in range(5)]
    fa = lambda x: x @ x.T  # noqa: E731
    fb = lambda y: torch.tanh(y).sum(dim=0)  # noqa: E731
    out = OverlapScheduler(fa, fb, device="cpu").run(blocks)
    serial = [fb(fa(b)) for b in blocks]
    for o, s in zip(out, serial):
        assert torch.equal(o, s)
    assert OverlapScheduler(fa, fb, device="cpu").run([]) == []


@pytest.mark.parametrize("kw", [dict(coordinator="127.0.0.1:1"),
                                dict(num_processes=2), dict(process_id=1),
                                dict(coordinator="127.0.0.1:1", num_processes=2)])
def test_bootstrap_partial_config_raises(kw, monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="partial distributed config"):
        bootstrap.initialize_distributed(device="cpu", **kw)


def test_bootstrap_nccl_rank_per_gpu(monkeypatch):
    """NCCL with more ranks on a host than GPUs raises its named error
    (before any group exists); the card is never swapped for gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(bootstrap.TooManyRanksError, match="2 NCCL ranks"):
        bootstrap.initialize_distributed("127.0.0.1:1", 2, 0)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bootstrap.initialize_distributed()


def test_replicated_equals_jax(ranks, inputs):
    import jax

    from fastmatch_tpu.dist import mesh as jmesh

    x = inputs["replicated"]
    arr = jax.device_put(jnp.asarray(x), jmesh.replicated(jmesh.make_mesh(2, 4)))
    assert len(arr.addressable_shards) == 8
    for shard in arr.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data), x)
    for name in ("1x4", "2x2", "4x1"):
        for r in ranks:
            for got in r[f"replicated_{name}"]:
                np.testing.assert_array_equal(got, x)


def test_make_mesh_rejects_other_sizes(ranks):
    assert all(r["mesh_error"] == "mesh 3x1 != 4 devices" for r in ranks)


# sha256 of (R, t, points, cost, cost0, iters, accepted) of ``ba_solve`` on
# tests/test_torch_ba.py's test_ba_solve_vs_jax fixtures, computed with the
# solver as it was before the ``reduce`` hook (one thread, on the CPU).
PARENT_DIGEST = {
    "clean": "02206c64a599774197a1758b961a76a6d6c46442c0b87754d288c68f2295f0dc",
    "outliers_huber": "0c9977bd047357a1e47687310b5845b74b25b1d0a6fa9366a0ae4b4e1a6d2dfe",
}


@pytest.mark.parametrize("case", ["clean", "outliers_huber"])
def test_reduce_none_bit_identical_to_parent(case):
    outliers = 25 if case == "outliers_huber" else 0
    arrs = problem_arrays(seed=3, outliers=outliers, shuffle=True)
    kw = dict(max_iters=10, pcg_iters=30,
              huber_delta_static=(2.0 / 500.0) if outliers else None)

    def digest(r):
        h = hashlib.sha256()
        for a in (r.poses.R, r.poses.t, r.points, r.cost, r.cost0):
            h.update(a.numpy().tobytes())
        h.update(np.array([r.iters, r.accepted]).tobytes())
        return h.hexdigest()

    res = tlm.ba_solve(ba_problem_from_numpy(*arrs, device="cpu"), device="cpu", **kw)
    assert digest(res) == PARENT_DIGEST[case]
    # An identity hook passes through every sum and changes no bit either.
    seen = []

    def ident(x):
        seen.append(x.shape)
        return x

    prob = tlm.sort_obs_by_point(ba_problem_from_numpy(*arrs, device="cpu"))
    hooked = tlm.ba_solve_raw(prob, reduce=ident, **kw)
    assert digest(hooked) == PARENT_DIGEST[case] and len(seen) > 10
    with pytest.raises(ValueError, match="grouped route is single-device"):
        tlm.ba_solve_raw(prob, grouped="x", reduce=ident)
