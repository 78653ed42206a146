"""The port's CLI over saved maps (``python -m fastmatch_tpu_torch.cli``,
in-process through ``main(argv)`` with ``--device cpu``) beside the JAX
package's CLI on the same inputs:

- ``reconstruct --checkpoint`` writes ``map.pt``, restorable, with the JAX
  CLI's JSON keys (``slam --checkpoint --gps``: test_torch_checkpoint.py);
- ``locate`` flat and ``--retrieval 2`` on a map built directly from a
  synthetic scene (the JAX CLI reads its orbax directory, the port the
  same tree converted by ``interop.map_checkpoint_from_numpy``): the same
  JSON keys and localized counts as the JAX CLI's;
- ``merge`` with the JAX CLI's keys and counts (``--no-refine``), and
  without ``--focal`` it raises;
- ``match --method mirror`` on descriptor dumps: the JAX CLI's count;
- ``serve`` from the CLI on port 0 answers ``/healthz``.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from fastmatch_tpu import cli as jcli
from fastmatch_tpu.pipeline.checkpoint import save_map as jsave_map
from synth import SyntheticScene
from test_pipeline import synthetic_features
from test_torch_localize import query_view, scene_map

from fastmatch_tpu_torch import cli, interop
from fastmatch_tpu_torch.pipeline import serve as tserve
from fastmatch_tpu_torch.pipeline.checkpoint import load_map_arrays

torch.set_num_threads(1)


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    return rc, lines


def _npz(path, feats, size=(640, 480)):
    data = {"n_frames": len(feats), "image_size": np.array(size)}
    for i, (xy, d, m) in enumerate(feats):
        data[f"xy_{i}"], data[f"desc_{i}"], data[f"mask_{i}"] = xy, d, m
    np.savez(path, **data)


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """Maps A (frames 0-13) and B (9-23) of one scene, each as the JAX
    package's orbax directory and as the port's converted directory, and
    query features of three frames."""
    import orbax.checkpoint as ocp

    root = tmp_path_factory.mktemp("maps")
    out = {}
    for name, frames in (("a", np.arange(0, 14)), ("b", np.arange(9, 24))):
        scene, base, jrec, _ = scene_map(frames=frames)
        jsave_map(jrec, str(root / f"jax_{name}"))
        interop.map_checkpoint_from_numpy(ocp.PyTreeCheckpointer().restore(
            str(root / f"jax_{name}")), str(root / f"port_{name}"))
    _npz(root / "q.npz", [query_view(scene, base, f, seed=40 + f) for f in (3, 10, 12)])
    out.update(root=root, scene=scene)
    return out


@pytest.mark.parametrize("extra", [[], ["--retrieval", "2"]])
def test_locate_matches_jax_cli(maps, extra, capsys):
    r = maps["root"]
    argv = ["locate", None, str(r / "q.npz"), "--focal", "500", *extra]
    argv[1] = str(r / "jax_a")
    jrc, jout = _run(jcli.main, argv, capsys)
    argv[1] = str(r / "port_a")
    rc, out = _run(cli.main, ["--device", "cpu", *argv], capsys)
    assert rc == jrc == 0
    assert [sorted(o) for o in out] == [sorted(o) for o in jout]
    assert out[-1] == jout[-1] and out[-1]["localized"] == 3
    for o, j in zip(out[:-1], jout[:-1]):
        assert o["ok"] == j["ok"] and o["n_matches"] == j["n_matches"]


def test_merge_matches_jax_cli(maps, capsys, tmp_path):
    r = maps["root"]
    argv = ["merge", None, None, "--focal", "500", "--no-refine"]
    argv[1:3] = [str(r / "jax_a"), str(r / "jax_b")]
    _, jout = _run(jcli.main, argv, capsys)
    argv[1:3] = [str(r / "port_a"), str(r / "port_b")]
    rc, out = _run(cli.main, ["--device", "cpu", *argv, "--out", str(tmp_path / "m")], capsys)
    (o,), (j,) = out, jout
    assert rc == 0 and sorted(o) == sorted({**j, "out": 0})
    for key in ("n_localized", "of", "n_dedup", "n_new_points", "n_frames", "n_points"):
        assert o[key] == j[key], key
    assert abs(o["scale"] - j["scale"]) < 1e-3
    assert load_map_arrays(str(tmp_path / "m"))["counters"][0] == o["n_frames"]


def test_merge_needs_focal(maps):
    r = maps["root"]
    with pytest.raises(ValueError, match="--focal"):
        cli.main(["--device", "cpu", "merge", str(r / "port_a"), str(r / "port_b")])


def test_reconstruct_checkpoint_then_locate(tmp_path, capsys):
    rng = np.random.default_rng(0)
    scene = SyntheticScene(rng, n_points=200, n_frames=6)
    feats = synthetic_features(rng, scene)
    _npz(tmp_path / "f.npz", feats)
    ck = str(tmp_path / "ck")
    rc, (o,) = _run(cli.main, ["--device", "cpu", "--set", "map.max_frames=8", "reconstruct",
                               str(tmp_path / "f.npz"), "--checkpoint", ck], capsys)
    # The JAX CLI's keys (fastmatch_tpu/cli.py cmd_reconstruct, no --selfcal/--gps).
    assert sorted(o) == ["n_frames", "n_obs", "n_points", "out"] and o["n_frames"] == 6
    saved = load_map_arrays(ck)
    assert saved["counters"].tolist() == [6, o["n_points"], o["n_obs"]]
    rc, out = _run(cli.main, ["--device", "cpu", "locate", ck, str(tmp_path / "f.npz")], capsys)
    assert rc == 0 and out[-1] == {"localized": 6, "of": 6, "ann": False}


def test_match_mirror_matches_jax_cli(tmp_path, capsys):
    from synth import corresponding_descriptors

    a, b, _ = corresponding_descriptors(np.random.default_rng(3), 200, noise=0.05,
                                        n_distract=56)
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    argv = ["match", str(tmp_path / "a.npy"), str(tmp_path / "b.npy"), "--method", "mirror",
            "--mirror-tau", "0.9"]
    _, (j,) = _run(jcli.main, argv, capsys)
    _, (o,) = _run(cli.main, ["--device", "cpu", *argv], capsys)
    assert o == j and o["n_matches"] > 100
    with pytest.raises(ValueError, match="mirror"):
        cli.main(["--device", "cpu", "match", "x.png", "y.png", "--feature", "orb",
                  "--method", "mirror"])


def test_serve_from_cli(maps, monkeypatch):
    servers = []
    real = tserve.make_server
    monkeypatch.setattr(tserve, "make_server",
                        lambda *a, **k: servers.append(real(*a, **k)) or servers[-1])
    thread = threading.Thread(target=cli.main, daemon=True, args=(
        ["--device", "cpu", "serve", str(maps["root"] / "port_a"), "--focal", "500",
         "--port", "0"],))
    thread.start()
    for _ in range(600):
        if servers:
            break
        thread.join(timeout=0.1)
    port = servers[0].server_port
    for _ in range(100):  # bound before serve_forever starts
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                health = json.loads(r.read())
            break
        except OSError:
            thread.join(timeout=0.1)
    assert health["index"] == "exact" and health["queries_served"] == 0
    servers[0].shutdown()
    thread.join(timeout=60)
    assert not thread.is_alive()
