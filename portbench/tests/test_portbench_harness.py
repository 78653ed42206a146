"""The harness on the CPU at tiny sizes: the manifest's names, the traffic
generators' seeding, the modules a run loads, a cell added by files alone,
and the refusals. Tests that need a card decide inside the test."""

import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.drivers import ba, pairs
from portbench.tests.conftest import ROOT, write_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_names_units_and_keys():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(m["command"]) <= 32 and all(_one_line(w) for w in m["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in m["paths"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    names = [e["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for e in m[part]]
    assert len(names) == len(set(names))
    for part, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                       ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in m[part]:
            assert set(e) == keys
            assert all(NAME.match(e[k]) for k in ("name", "config", "traffic") if k in e)
            assert all(_one_line(e[k]) for k in TEXT_KEYS if k in e)
    for e in m["configs"]:
        assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
        assert os.path.exists(os.path.join(ROOT, e["file"]))
        assert e["file"].startswith("portbench/")
    for e in m["workloads"]:
        assert e["chips"] in (1, 4)
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", e["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "portbench", "workloads", e["name"] + ".json"))
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(e["layer"])
    for e in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", e["name"] + ".py"))
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    for cell in m["workloads"]:
        e2e = [e["name"] for e in m["end_to_end"]
               if "workloads" not in e or cell["name"] in e["workloads"]]
        layers = [e for e in m["per_layer"]
                  if "workloads" not in e or cell["name"] in e["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        assert all(e["moves"] in e2e for e in layers)
    assert len(json.dumps(m)) <= 64 * 1024


def test_pair_traffic_repeats_for_a_seed_and_differs_across_seeds():
    cfg = dict(batch=2, capacity=64, live=50, dim=128, noise=0.08)
    cpu = torch.device("cpu")
    a, b, c = (pairs.make_pool(cfg, 2, s, cpu) for s in (2**31 + 5, 2**31 + 5, 6))
    for x, y in zip(a, b):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert not torch.equal(a[0][0], c[0][0])


def test_ba_traffic_repeats_for_a_seed_and_differs_across_seeds(tiny_root):
    cfg = harness.load_cell(tiny_root, "ba-venice.lm").config
    cpu = torch.device("cpu")
    a, b, c = (ba.make_problem(cfg, s, cpu) for s in (2**31 + 5, 2**31 + 5, 6))
    flat = [[t for group in p for t in group] for p in (a, b, c)]
    assert all(torch.equal(u, v) for u, v in zip(flat[0], flat[1]))
    assert not torch.equal(flat[0][2], flat[2][2])
    cam, pt, uv = a[2]
    assert cam.shape[0] == cfg["n_obs"]
    assert torch.bincount(pt.long(), minlength=cfg["n_points"]).min() >= 2


RUN = ("import sys, time; sys.path.insert(0, {root!r}); from portbench import harness; "
       "sys.exit(harness.run(sys.argv[1:], time.perf_counter(), root={tiny!r}, "
       "need_device=False))")


def run_tiny(tiny, *args):
    return subprocess.run([sys.executable, "-c", RUN.format(root=ROOT, tiny=tiny), *args],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)


@pytest.mark.parametrize("cell, trace", [("pairs64.exact", 1), ("pairs64.fast", 0),
                                         ("pairs64.fast", 1), ("ba-venice.lm", 0)])
def test_tiny_run_is_correct_and_loads_no_jax(tiny_root, cell, trace):
    p = run_tiny(tiny_root, "--workload", cell, "--seed", "2147483653", "--seconds", "1",
                 "--trace", str(trace))
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert "forbidden modules" not in p.stderr
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    want = [e["name"] for e in manifest()["per_layer" if trace else "end_to_end"]
            if "workloads" not in e or cell in e["workloads"]]
    assert set(result["metrics"]) <= set(want)
    if not trace:
        assert set(result["metrics"]) == set(want)


def test_pairs_p95_leaves_out_the_profiled_slice():
    """``match_p95_ms.pairs`` reads only the batches that completed with the
    profiler off."""
    read = harness.load_reader(ROOT, "match_p95_ms.pairs")
    off = [0.001 * (1 + i / 100) for i in range(100)]
    window = dict(latency_s=off + [0.5] * 20, latency_off_s=off)
    assert read(harness.SimpleNamespace(window=window)) == pytest.approx(1e3 * off[94])
    assert read(harness.SimpleNamespace(window={})) is None


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fastmatch_tpu_torch.extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "fastmatch_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"fastmatch_tpu", "jax"} <= set(harness.forbidden_modules())


def test_a_cell_added_by_files_alone(tmp_path):
    """A test-only cell, configuration, traffic mix and metric, each a new
    file in a directory of its own, run by the unchanged harness."""
    root = str(tmp_path)
    m = manifest()
    m["configs"].append(dict(name="tiny-pairs", source="test", why="test",
                             file="portbench/configs/tiny-pairs.json", reduced=[]))
    m["workloads"].append(dict(name="tiny.test", config="tiny-pairs", traffic="closed2-test",
                               chips=1, why="test"))
    m["end_to_end"].append(dict(name="batches_s.test", unit="1/s", better="higher",
                                bound=0.05, source="host_clock", workloads=["tiny.test"]))
    write_json(os.path.join(root, "BENCHMARK.json"), m)
    write_json(os.path.join(root, "portbench/configs/tiny-pairs.json"),
               dict(batch=2, capacity=128, live=100, dim=128, noise=0.08, ratio=0.8,
                    cross_check=True))
    write_json(os.path.join(root, "portbench/traffic/closed2-test.json"),
               dict(driver="pairs", precision="exact", in_flight=2, pool=3,
                    warmup_seconds=0.1, trace_seconds=0.2, check_batches=4))
    write_json(os.path.join(root, "portbench/workloads/tiny.test.json"),
               dict(limits=dict(decisions_off=0, dist_gap=1e-5)))
    os.makedirs(os.path.join(root, "portbench/metrics"))
    with open(os.path.join(root, "portbench/metrics/batches_s.test.py"), "w") as fh:
        fh.write("def read(ctx):\n    return ctx.window['batches'] / ctx.window['seconds']\n")
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(["--workload", "tiny.test", "--seed", "9", "--seconds", "0.5"],
                     time.perf_counter(), root=root, need_device=False, out=out, err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"batches_s.test", "setup_s"}


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "pairs64.exact",
                        "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "pairs64.exact",
                        "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "pairs64.exact",
                        "--seed", "11", "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"


def test_a_traced_solve_that_bypasses_a_spanned_name_fails(tiny_root, monkeypatch):
    """The per-layer spans of BA hang on names of the port; a solve that no
    longer calls through one of them fails the traced run instead of
    leaving its metric silent."""
    from fastmatch_tpu_torch.ba import schur
    from fastmatch_tpu_torch.kernels import segment_ops

    monkeypatch.setattr(schur, "_gather_pt", lambda table, keys: segment_ops.sorted_gather_rows(
        table.contiguous(), keys.pt_rows, out=keys.pt_gather))
    with pytest.raises(RuntimeError, match="sorted_gather_rows"):
        harness.run(["--workload", "ba-venice.lm", "--seed", "3", "--seconds", "0.2",
                     "--trace", "1"], time.perf_counter(), root=tiny_root, need_device=False,
                    out=io.StringIO(), err=io.StringIO())
