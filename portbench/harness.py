"""The benchmark's run of one cell: find its files, set up, time, check, print.

Everything about a cell is found by name, from ``BENCHMARK.json`` at the
root of the checkout:

- its entry in ``workloads`` names a configuration and a traffic mix;
- the configuration's ``file`` (``portbench/configs/<config>.json``) holds
  its sizes;
- ``portbench/traffic/<traffic>.json`` holds the mix's parameters and names
  the driver (``portbench/drivers/<driver>.py``) that makes its inputs and
  runs its loop;
- ``portbench/workloads/<cell>.json`` holds the limits of the numbers that
  decide ``correct``;
- each metric of ``end_to_end`` and ``per_layer`` that applies to the cell
  has a reader, ``portbench/metrics/<metric>.py``, whose ``read(ctx)``
  returns its value or None when it finds nothing to read.

Files are looked up under the root given (a test passes a directory of its
own) and then under this package, so a cell, configuration, traffic mix or
metric is added by adding files and entries.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that no process of the benchmark may hold: JAX and
# the JAX package the port was made from (whose name begins the port's).
FORBIDDEN = ("jax", "jaxlib", "flax", "fastmatch_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def find_file(root, *parts):
    """``portbench/<parts>`` under ``root``, else under this package."""
    for base in (os.path.join(root, "portbench"), HERE):
        path = os.path.join(base, *parts)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(os.path.join("portbench", *parts))


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root, name):
    """SimpleNamespace(cell, config, traffic, limits, end_to_end, per_layer)
    of the cell ``name``."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = _find(manifest["workloads"], name, "workload")
    cfg_entry = _find(manifest["configs"], cell["config"], "config")
    return SimpleNamespace(
        cell=cell,
        config=load_json(os.path.join(root, cfg_entry["file"])),
        traffic=load_json(find_file(root, "traffic", cell["traffic"] + ".json")),
        limits=load_json(find_file(root, "workloads", name + ".json"))["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])


def load_reader(root, metric_name):
    path = find_file(root, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric_name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _passes(check):
    if check.get("least"):
        return check["value"] >= check["limit"]
    return check["value"] <= check["limit"]


class NoDevice(RuntimeError):
    """The cell needs more CUDA devices than the machine has."""


def prepare(root, workload, need_device=True):
    """SimpleNamespace(spec, device, fm, driver) of the cell ``workload``:
    its files (``load_cell``), the first card (the CPU where
    ``need_device`` is False, for tests), the port's package and the
    driver module its traffic names."""
    spec = load_cell(root, workload)
    import torch

    if need_device:
        chips = int(spec.cell["chips"])
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            raise NoDevice(f"the cell needs {chips} CUDA device(s); found {found}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    src = os.path.join(ROOT, "src")  # the port, beside the harness in its checkout
    if os.path.isdir(src) and src not in sys.path:
        sys.path.insert(0, src)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import fastmatch_tpu_torch as fm

    driver = importlib.import_module(f"portbench.drivers.{spec.traffic['driver']}")
    return SimpleNamespace(spec=spec, device=device, fm=fm, driver=driver)


def run(argv, started, root=ROOT, need_device=True, out=sys.stdout, err=sys.stderr):
    """One run of one cell; returns the exit code. ``started``: the host
    clock when the process began. ``need_device=False`` (tests only) skips
    the look for a card and runs on the CPU."""
    args = parse(argv)
    try:
        cell = prepare(root, args.workload, need_device)
    except NoDevice as exc:
        print(f"portbench: {exc}", file=err)
        return 2
    import torch

    from portbench.trace import Tracer

    spec, device, driver_mod = cell.spec, cell.device, cell.driver
    tracer = Tracer(args.trace == 1, driver_mod.SPANS)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver = driver_mod.Driver(spec.config, spec.traffic, args.seed, device, cell.fm)
    driver.warm_up(tracer)
    tracer.prime(device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    window = driver.window(args.seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=err)
        return 3
    driver.free()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(spec.limits)
    correct = all(_passes(c) for c in checks) and window["failed"] == 0

    ctx = SimpleNamespace(setup_s=setup_s, window=window, trace=tracer.summary,
                          calls=dict(tracer.calls), config=spec.config,
                          traffic=spec.traffic)
    metrics = {}
    for m in (spec.per_layer if args.trace else spec.end_to_end):
        value = load_reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=int(spec.cell["chips"]) if cuda else 1, memory_peak_bytes=int(peak))
    result = dict(correct=correct, attempted=window["attempted"], failed=window["failed"],
                  metrics=metrics, device=dev)
    if tracer.summary is not None:
        s = tracer.summary
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = dict(device_ops=[list(kv) for kv in s["device_ops"]],
                                   idle_gaps=[list(kv) for kv in s["idle_gaps"]])
        print(f"portbench: trace reduced in {s['reduce_s']:.3f} s; {s['device_ops_total']} "
              f"device operations, {s['unlinked']} tied to no launch", file=err)
    result["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"],
                                        at_least=bool(c.get("least"))) for c in checks}
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=err)
        return 3
    for c in checks:
        rel = ">=" if c.get("least") else "<="
        print(f"check {c['name']}: {c['value']!r} (limit {rel} {c['limit']!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None, started=None):
    started = time.perf_counter() if started is None else started
    try:
        return run(sys.argv[1:] if argv is None else argv, started)
    except Exception:  # noqa: BLE001 - the run's boundary: report and fail
        traceback.print_exc()
        return 1
