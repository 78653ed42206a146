"""A tiny copy of the benchmark for CPU tests: the real manifest and files,
with each configuration cut to a size a CPU run holds in seconds."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for path in (ROOT, os.path.join(ROOT, "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY = {"sift-pairs-64": dict(batch=4, capacity=256, live=200),
        "bal-venice-1778": dict(n_cams=40, n_points=2000, n_obs=10060, path_radius=4.0,
                                max_track=8, max_iters=6, pcg_iters=20)}


def write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh)


def make_tiny_root(tmp):
    """A root holding BENCHMARK.json and tiny configuration files; traffic,
    limits, drivers and metric readers come from the package."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    for entry in manifest["configs"]:
        with open(os.path.join(ROOT, entry["file"])) as fh:
            cfg = json.load(fh)
        cfg.update(TINY[entry["name"]])
        entry["file"] = f"portbench/configs/tiny-{entry['name']}.json"
        write_json(os.path.join(tmp, entry["file"]), cfg)
    write_json(os.path.join(tmp, "BENCHMARK.json"), manifest)
    return str(tmp)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
