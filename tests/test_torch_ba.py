"""The port's bundle adjustment (fastmatch_tpu_torch, CPU) against the JAX
package's, the K4 segment sum's plain version against the TPU kernel
(``sorted_segment_sum(interpret=True)``) and ``jax.ops.segment_sum``, and
the K5 row gather's plain version against ``sorted_gather_rows(interpret=True)``
(rtol/atol 1e-5: the TPU kernel rebuilds each value from bf16 hi/lo parts)
and, exactly, against ``table[seg]``. The segment offsets that K4's kernel
reads in place of the keys (``segment_offsets``, ``SegmentKeys``) are held
exactly against ``np.searchsorted``.

Tolerances, with reasons: segment sums of float32 rows agree to 1e-4
absolute on unit-scale data (the frameworks add the rows of a segment in
different orders). The LM solve is a chain of such sums, PCG steps and
accept/reject decisions; its initial and final costs agree to rtol 1e-4,
the bound the JAX package's own engines are held to between compile
contexts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.ba import lm as jlm
from fastmatch_tpu.ba import schur as jschur
from fastmatch_tpu.ba.problem import BAProblem as JProblem
from fastmatch_tpu.ba.problem import Observations as JObs
from fastmatch_tpu.core.lie import SE3 as JSE3
from fastmatch_tpu.kernels.segment_ops import sorted_gather_rows as j_gather_rows
from fastmatch_tpu.kernels.segment_ops import sorted_segment_sum as j_segsum
from fastmatch_tpu.pipeline import tracker as jtracker
from synth import SyntheticScene

from fastmatch_tpu_torch.ba import lm as tlm
from fastmatch_tpu_torch.ba import schur as tschur
from fastmatch_tpu_torch.ba.problem import Observations
from fastmatch_tpu_torch.core.containers import (binary_descriptors_from_numpy,
                                                 descriptors_from_numpy)
from fastmatch_tpu_torch.interop import ba_problem_from_numpy
from fastmatch_tpu_torch.kernels import segment_ops as k4
from fastmatch_tpu_torch.pipeline import tracker as ttracker

torch.set_num_threads(1)


def _rot(w):
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def problem_arrays(seed=0, n_frames=6, n_points=150, noise_px=0.5, perturb=0.05,
                   cap_obs=1024, shuffle=False, outliers=0):
    """A perturbed BA problem of a synthetic scene as numpy arrays (the
    BAProblem fields in order); gauge cameras 0 and 1 are fixed."""
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(rng, n_points=n_points, n_frames=n_frames, noise_px=noise_px)
    f, c = scene.K[0, 0], scene.K[:2, 2]
    cam, pt = np.nonzero(scene.visible)
    uv = (scene.pixels[cam, pt] - c) / f
    uv[:outliers] += rng.uniform(-0.2, 0.2, (outliers, 2))
    O = len(cam)
    assert O <= cap_obs
    order = rng.permutation(O) if shuffle else np.arange(O)
    cam_idx = np.zeros(cap_obs, np.int32)
    pt_idx = np.zeros(cap_obs, np.int32)
    uvp = np.zeros((cap_obs, 2), np.float32)
    mask = np.zeros(cap_obs, bool)
    cam_idx[:O], pt_idx[:O], uvp[:O], mask[:O] = cam[order], pt[order], uv[order], True
    R = scene.R.copy()
    t = scene.t.copy()
    for fi in range(2, n_frames):
        dR = _rot(perturb * 0.5 * rng.standard_normal(3) + 1e-9)
        R[fi] = dR @ R[fi]
        t[fi] = dR @ t[fi] + perturb * rng.standard_normal(3)
    X = scene.points + perturb * rng.standard_normal(scene.points.shape)
    fixed = np.zeros(n_frames, bool)
    fixed[:2] = True
    return (R.astype(np.float32), t.astype(np.float32), X.astype(np.float32),
            cam_idx, pt_idx, uvp, mask, np.ones(n_frames, bool), np.ones(n_points, bool),
            fixed)


def jax_problem(arrs):
    R, t, X, ci, pi, uv, m, cm, pm, fx = (jnp.asarray(a) for a in arrs)
    return JProblem(JSE3(R, t), X, JObs(ci, pi, uv, m), cm, pm, fx)


# -- K4: the segment sum -----------------------------------------------------------


def test_segment_sum_point_keyed_vs_tpu_kernel(rng):
    # Sorted point keys over a 2048-segment table (the BA point reductions).
    O, P = 8192, 2048
    vals = rng.standard_normal((O, 3)).astype(np.float32)
    seg = np.sort(rng.integers(0, P, O)).astype(np.int32)
    ref = np.asarray(j_segsum(jnp.asarray(vals), jnp.asarray(seg), P, interpret=True))
    before = k4.sorted_segment_sum.launches
    out = k4.sorted_segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), P)
    assert k4.sorted_segment_sum.launches == before  # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    xla = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=P))
    np.testing.assert_allclose(out.numpy(), xla, atol=1e-4)


def test_segment_sum_camera_keyed_unsorted(rng):
    # Unsorted camera keys, <= 1024 segments: the TPU kernel's full-window
    # path; the port sorts the keys once per solve and permutes the rows.
    O, C = 4096, 64
    vals = rng.standard_normal((O, 36)).astype(np.float32)
    cam = rng.integers(0, C, O).astype(np.int32)
    ref = np.asarray(j_segsum(jnp.asarray(vals), jnp.asarray(cam), C, interpret=True))
    obs = Observations(torch.from_numpy(cam), torch.from_numpy(np.zeros(O, np.int32)),
                       torch.zeros((O, 2)), torch.ones(O, dtype=torch.bool))
    keys = tschur.segment_keys(obs, C, 1)
    assert keys.cam_perm is not None and keys.pt_perm is None
    assert bool((keys.cam[1:] >= keys.cam[:-1]).all())
    out = tschur._seg_sum_cam(torch.from_numpy(vals.reshape(O, 6, 6)), keys, C)
    np.testing.assert_allclose(out.numpy().reshape(C, 36), ref, atol=1e-4)


def test_segment_sum_drops_out_of_range_keys(rng):
    vals = rng.standard_normal((500, 4)).astype(np.float32)
    seg = np.sort(rng.integers(-3, 40, 500)).astype(np.int32)
    out = k4.segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(seg), 32)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=32))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def _edge_case(rng, case):
    """(vals, sorted int32 keys, n_segments) of one K4 edge case."""
    O, D = 2000, 3
    if case == "one_segment":        # every row in one segment of 512
        n, seg = 512, np.full(O, 200)
    elif case == "mostly_empty":     # keys from 20 of 2048 segments
        n = 2048
        seg = rng.choice(n, 20, replace=False)[rng.integers(0, 20, O)]
    elif case == "out_of_range":     # keys from -3 to n + 3
        n = 256
        seg = rng.integers(-3, n + 4, O)
    elif case == "n_segments_1":     # one segment, keys -1, 0 and 1
        n = 1
        seg = rng.integers(-1, 2, O)
    else:                            # long camera-keyed segments at D = 36
        n, D = 16, 36
        seg = rng.integers(0, 12, O)
    vals = rng.standard_normal((O, D)).astype(np.float32)
    return vals, np.sort(seg).astype(np.int32), n


@pytest.mark.parametrize("case", ["one_segment", "mostly_empty", "out_of_range",
                                  "n_segments_1", "long_camera"])
def test_segment_sum_edge_cases_vs_jax(rng, case):
    vals, seg, n = _edge_case(rng, case)
    off = k4.segment_offsets(torch.from_numpy(seg), n)
    assert off.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), np.searchsorted(seg, np.arange(n + 1)))
    max_len = int(k4.segment_lengths(off).max())
    inside = seg[(seg >= 0) & (seg < n)]
    assert max_len == np.bincount(inside, minlength=n).max()
    # The variant the card would take: only the out-of-range case has short
    # segments (a few rows each).
    assert (max_len <= k4.SHORT_MAX_LEN) == (case == "out_of_range")
    before = k4.sorted_segment_sum.launches
    out = k4.sorted_segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), n, off, max_len)
    assert k4.sorted_segment_sum.launches == before  # CPU: the plain version
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=n))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("table", ["point_sorted", "unsorted"])
def test_segment_keys_offsets(table):
    # ba_solve's point-sorted table (camera keys unsorted) and a shuffled
    # table with neither key sorted; the dead rows are keyed to point and
    # camera 0 and count in those segments, as on the card.
    prob = ba_problem_from_numpy(*problem_arrays(seed=5, shuffle=True), device="cpu")
    if table == "point_sorted":
        prob = tlm.sort_obs_by_point(prob)
    obs = prob.obs
    keys = tschur.segment_keys(obs, 6, 150)
    assert (keys.pt_perm is None) == (table == "point_sorted")
    assert keys.cam_perm is not None
    np.testing.assert_array_equal(keys.pt_rows.numpy(), obs.pt_idx.numpy())
    for idx, got, off, longest, n in ((obs.pt_idx, keys.pt, keys.pt_off, keys.pt_max, 150),
                                      (obs.cam_idx, keys.cam, keys.cam_off, keys.cam_max, 6)):
        ref = np.sort(idx.numpy(), kind="stable")
        np.testing.assert_array_equal(got.numpy(), ref)
        assert got.dtype == off.dtype == torch.int32
        np.testing.assert_array_equal(off.numpy(), np.searchsorted(ref, np.arange(n + 1)))
        assert isinstance(longest, int) and longest == np.bincount(ref, minlength=n).max()


# -- K5: the row gather ------------------------------------------------------------


def test_gather_rows_vs_tpu_kernel(rng):
    # tests/test_segment_ops.py's shape: 8192 sorted keys into 2048 rows x 6.
    O, P = 8192, 2048
    table = rng.standard_normal((P, 6)).astype(np.float32)
    seg = np.sort(rng.integers(0, P, O)).astype(np.int32)
    ref = np.asarray(j_gather_rows(jnp.asarray(table), jnp.asarray(seg), interpret=True))
    before = k4.sorted_gather_rows.launches
    out = k4.sorted_gather_rows(torch.from_numpy(table), torch.from_numpy(seg))
    assert k4.sorted_gather_rows.launches == before  # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.numpy(), table[seg])


def test_gather_rows_into_buffer(rng):
    # BA's form: the rows go into a given (O, D) buffer, which is returned.
    table = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    seg = torch.from_numpy(np.sort(rng.integers(0, 40, 100)).astype(np.int32))
    buf = torch.empty((100, 3))
    out = k4.sorted_gather_rows(table, seg, out=buf)
    assert out is buf
    assert torch.equal(buf, table[seg.long()])


def test_gather_rows_out_of_range_keys_are_zero(rng):
    # The TPU kernel's one-hot product gives zero rows for keys it cannot
    # place; the port's gather does the same instead of reading outside.
    table = rng.standard_normal((40, 3)).astype(np.float32)
    seg = np.array([-2, 0, 5, 39, 40, 1000], np.int32)
    out = k4.gather_rows_plain(torch.from_numpy(table), torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(out[[1, 2, 3]], table[[0, 5, 39]])
    assert (out[[0, 4, 5]] == 0).all()


def test_ba_solve_through_k5_is_bit_identical(monkeypatch):
    """The point-keyed gathers now go through the K5 wrapper; on the CPU
    ``ba_solve`` gives bit for bit what plain indexing gave."""
    arrs = problem_arrays(seed=3, outliers=25, shuffle=True)
    kw = dict(max_iters=10, pcg_iters=30, huber_delta_static=2.0 / 500.0)
    calls = []
    real = tschur.sorted_gather_rows

    def spy(table, seg, out=None):
        calls.append((tuple(table.shape), out is not None))
        return real(table, seg, out=out)

    monkeypatch.setattr(tschur, "sorted_gather_rows", spy)
    new = tlm.ba_solve(ba_problem_from_numpy(*arrs, device="cpu"), device="cpu", **kw)
    # Every gather is of 3 columns and writes into the solve's buffer.
    assert len(calls) > 3 and all(c == (c[0], True) and c[0][1] == 3 for c in calls)
    monkeypatch.setattr(tschur, "sorted_gather_rows",
                        lambda table, seg, out=None: table[seg.long()])
    old = tlm.ba_solve(ba_problem_from_numpy(*arrs, device="cpu"), device="cpu", **kw)
    for a, b in ((new.poses.R, old.poses.R), (new.poses.t, old.poses.t),
                 (new.points, old.points), (new.cost, old.cost), (new.cost0, old.cost0)):
        assert torch.equal(a, b)
    assert (new.iters, new.accepted) == (old.iters, old.accepted)


# -- Schur pieces and the LM solve ------------------------------------------------


def test_assemble_vs_jax():
    arrs = problem_arrays(seed=1, outliers=20)
    jp = jlm.sort_obs_by_point(jax_problem(arrs))
    tp = tlm.sort_obs_by_point(ba_problem_from_numpy(*arrs, device="cpu"))
    np.testing.assert_array_equal(tp.obs.pt_idx.numpy(), np.asarray(jp.obs.pt_idx))
    np.testing.assert_array_equal(tp.obs.cam_idx.numpy(), np.asarray(jp.obs.cam_idx))
    hub = 2.0 / 500.0
    jsys, jcost = jschur.assemble(jp.poses, jp.points, jp.obs, 6, 150, hub)
    tsys, tcost = tschur.assemble(tp.poses, tp.points, tp.obs, 6, 150, hub)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    for name in ("Hcc", "Hpp", "gc", "gp", "Wcp", "w"):
        a, b = getattr(tsys, name).numpy(), np.asarray(getattr(jsys, name))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def test_pcg_and_back_substitution_vs_jax():
    arrs = problem_arrays(seed=2)
    jp = jlm.sort_obs_by_point(jax_problem(arrs))
    tp = tlm.sort_obs_by_point(ba_problem_from_numpy(*arrs, device="cpu"))
    jsys, _ = jschur.assemble(jp.poses, jp.points, jp.obs, 6, 150)
    tsys, _ = tschur.assemble(tp.poses, tp.points, tp.obs, 6, 150)
    upd = (arrs[7] & ~arrs[9]).astype(np.float32)
    lam = 1e-3
    jdx = jschur.pcg_solve(jsys, jp.obs, jnp.float32(lam), 150, jnp.asarray(upd), iters=20)
    keys = tschur.segment_keys(tp.obs, 6, 150)
    tdx = tschur.pcg_solve(tsys, tp.obs, torch.tensor(lam), 150, torch.from_numpy(upd), keys,
                           iters=20)
    scale = np.abs(np.asarray(jdx)).max()
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=1e-3 * scale)
    jdp = jschur.back_substitute(jsys, jp.obs, jnp.float32(lam), jdx, 150)
    tdp = tschur.back_substitute(tsys, tp.obs, torch.tensor(lam), tdx, 150, keys)
    np.testing.assert_allclose(tdp.numpy(), np.asarray(jdp), atol=2e-3 * np.abs(np.asarray(jdp)).max())


@pytest.mark.parametrize("case", ["clean", "outliers_huber"])
def test_ba_solve_vs_jax(case):
    outliers = 25 if case == "outliers_huber" else 0
    arrs = problem_arrays(seed=3, outliers=outliers, shuffle=True)
    kw = dict(max_iters=10, pcg_iters=30,
              huber_delta_static=(2.0 / 500.0) if outliers else None)
    jres = jlm.ba_solve(jax_problem(arrs), **kw)
    tres = tlm.ba_solve(ba_problem_from_numpy(*arrs, device="cpu"), device="cpu", **kw)
    np.testing.assert_allclose(float(tres.cost0), float(jres.cost0), rtol=1e-4)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-4,
                               atol=1e-4 * float(jres.cost0))
    assert float(tres.cost) < (0.5 if outliers else 0.1) * float(tres.cost0)
    np.testing.assert_allclose(tres.poses.t.numpy(), np.asarray(jres.poses.t), atol=1e-3)
    # Gauge cameras did not move.
    np.testing.assert_array_equal(tres.poses.R.numpy()[:2], arrs[0][:2])


def test_compact_obs_and_bucket_vs_jax():
    # The JAX package's power-of-two bucket (dead rows keyed 0) and the
    # port's table size, the live count itself (no dead rows left).
    arrs = problem_arrays(seed=4, cap_obs=4096)
    n_live = int(arrs[6].sum())
    for b in (jtracker.obs_bucket(n_live, 4096), n_live):
        jc = jtracker.compact_obs(jax_problem(arrs), b)
        tc = ttracker.compact_obs(ba_problem_from_numpy(*arrs, device="cpu"), b)
        for name in ("cam_idx", "pt_idx", "uv", "mask"):
            np.testing.assert_array_equal(getattr(tc.obs, name).numpy(),
                                          np.asarray(getattr(jc.obs, name)))
        assert tc.obs.mask.shape[0] == b and int(tc.obs.mask.sum()) == n_live
    assert bool(tc.obs.mask.all())


def test_descriptor_containers_default_to_cuda():
    # The two container constructors are entry points: the card unless the
    # caller asks for the CPU; the shape and type checks raise first.
    rng = np.random.default_rng(0)
    desc = rng.random((40, 128)).astype(np.float32)
    words = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint64).astype(np.uint32)
    for build, arr in ((descriptors_from_numpy, desc), (binary_descriptors_from_numpy, words)):
        out = build(arr, 64, device="cpu")
        assert out.mask.device.type == "cpu" and int(out.mask.sum()) == 40
        if torch.cuda.is_available():
            assert build(arr, 64).mask.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                build(arr, 64)
        with pytest.raises(ValueError):
            build(arr[:, :5].astype(np.float64), 64)


def test_ba_solve_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.ba_solve(ba_problem_from_numpy(*problem_arrays(), device="cpu"))
