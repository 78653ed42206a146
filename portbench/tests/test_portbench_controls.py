"""What decides ``correct``, at a size a CPU run holds: the port reads
inside every limit, the lower-precision control outside one, and a run
with the timed path broken underneath comes out not correct."""

import io
import json
import time

import pytest
import torch

import fastmatch_tpu_torch as fm
from fastmatch_tpu_torch.ba.problem import Observations
from fastmatch_tpu_torch.core.containers import Matches
from portbench import controls, harness

CELLS = ("pairs64.exact", "pairs64.fast", "ba-venice.lm")


def _fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(tiny_root, cell):
    limits = harness.load_cell(tiny_root, cell).limits
    rows = controls.readings(tiny_root, cell, [1, 2, 3], need_device=False, out=io.StringIO())
    for row in rows:
        assert not _fails(row["program"], limits), row
        assert _fails({k: row["control"][k] for k in limits}, limits), row


def _broken_match(kind):
    real = fm.match_batch
    first = []

    def broken(da, db, *args, **kw):
        m = real(da, db, *args, **kw)
        if kind == "unchanged":       # the first answer, returned for every batch
            first.append(first[0] if first else m)
            return first[-1]
        if kind == "half":            # half of the batch left out
            h = m.idx.shape[0] // 2
            idx, valid, dist = m.idx.clone(), m.valid.clone(), m.dist.clone()
            idx[h:], valid[h:], dist[h:] = 0, False, 3.0e38
            return Matches(idx, dist, valid)
        idx = m.idx.clone()           # an answer altered where it is produced
        idx[0, int(m.valid[0].nonzero()[0])] += 1
        return Matches(idx, m.dist, m.valid)
    return broken


def _broken_solve(kind):
    real = fm.ba_solve

    def broken(problem, *args, **kw):
        if kind == "unchanged":       # a solve that returns its state unchanged
            kw["max_iters"] = 0
        if kind == "half":            # half of the observations left out
            o = problem.obs
            mask = o.mask.clone()
            mask[mask.shape[0] // 2:] = False
            problem = problem._replace(obs=Observations(o.cam_idx, o.pt_idx, o.uv, mask))
        res = real(problem, *args, **kw)
        if kind == "altered":         # an answer altered where it is produced
            t = res.poses.t.clone()
            t[5] += 0.1
            res = res._replace(poses=type(res.poses)(res.poses.R, t))
        return res
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ("none", "unchanged", "half", "altered"))
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, kind):
    if kind != "none":
        if cell.startswith("pairs"):
            monkeypatch.setattr(fm, "match_batch", _broken_match(kind))
        else:
            monkeypatch.setattr(fm, "ba_solve", _broken_solve(kind))
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(["--workload", cell, "--seed", "4", "--seconds", "0.5"],
                     time.perf_counter(), root=tiny_root, need_device=False, out=out, err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is (kind == "none"), err.getvalue()[-2000:]
