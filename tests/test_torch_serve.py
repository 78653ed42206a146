"""The port's localization service (fastmatch_tpu_torch.pipeline.serve,
CPU) on a map built directly from a tests/synth.py scene
(test_torch_localize.scene_map), beside the JAX package's service:

- queries of different sizes land in the JAX package's power-of-two
  buckets, answer as ``localize`` on the padded arrays does, and pass
  tests/test_serve.py's pose gates; the JSON keys are the JAX service's;
- the HTTP surface on port 0: ``/healthz``, ``POST /localize`` equal to the
  direct answer, 400 on a bad body, 404 on an unknown route;
- concurrent requests answer as sequential ones;
- ``serve(..., ready_event=)`` warms up, binds port 0 and serves a
  checkpoint until shut down; the warmup leaves the query count at 0.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline import serve as jserve
from fastmatch_tpu.pipeline.localize import build_map_index as jbuild
from test_torch_localize import pose_err, query_view, scene_map

from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import serve as tserve
from fastmatch_tpu_torch.pipeline.localize import build_map_index, localize

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def service():
    scene, base, _, trec = scene_map()
    index = build_map_index(trec.points, trec.pt_desc, trec.pt_mask, device="cpu")
    svc = tserve.LocalizeService(index, Pinhole.from_K(scene.K.astype(np.float32)))
    return dict(svc=svc, scene=scene, base=base, rec=trec)


def test_buckets_and_direct_answers(service):
    svc = service["svc"]
    assert [tserve._bucket(n) for n in (1, 256, 257, 511, 1025)] == [256, 256, 512, 512, 2048]
    assert [tserve._bucket(n) for n in (1, 256, 257, 1025)] == [jserve._bucket(n) for n in
                                                                (1, 256, 257, 1025)]
    svc.queries = 0
    for f, n in ((5, 400), (13, 250), (21, 300)):
        xy, d, m = query_view(service["scene"], service["base"], f, seed=700 + f)
        out = svc.query(xy[:n], d[:n], m[:n])
        assert out["ok"], out
        dc, ang = pose_err(service["scene"], f, out["R"], out["t"])
        assert dc < 0.15 and ang < 2.0, (f, dc, ang)
        cap = tserve._bucket(n)
        pxy, pd, pm = (np.zeros((cap, 2), np.float32), np.zeros((cap, 128), np.float32),
                       np.zeros(cap, bool))
        pxy[:n], pd[:n], pm[:n] = xy[:n], d[:n], m[:n]
        r = localize(svc.index, pxy, pd, pm, svc.camera)
        assert np.array_equal(np.array(out["R"]), r.R.double().numpy())
        assert out["n_inliers"] == int(r.n_inliers)
        np.testing.assert_allclose(out["center"], -np.array(out["R"]).T @ np.array(out["t"]))
    assert svc.queries == 3


def test_json_keys_match_jax_service(service):
    scene, rec = service["scene"], service["rec"]
    jsvc = jserve.LocalizeService(jbuild(rec.points, rec.pt_desc, rec.pt_mask),
                                  JPinhole.from_K(scene.K.astype(np.float32)))
    xy, d, m = query_view(scene, service["base"], 8, seed=808)
    ref, got = jsvc.query(xy, d, m), service["svc"].query(xy, d, m)
    assert sorted(got) == sorted(ref)
    assert got["n_matches"] == ref["n_matches"] and got["ok"] == ref["ok"]
    assert sorted(service["svc"].health()) == sorted(jsvc.health())


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/localize", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _npz(xy, d, m):
    buf = io.BytesIO()
    np.savez(buf, xy=xy, desc=d, mask=m)
    return buf.getvalue()


@pytest.fixture(scope="module")
def http(service):
    httpd = tserve.make_server(service["svc"], port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_port
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


def test_http_roundtrip(service, http):
    with urllib.request.urlopen(f"http://127.0.0.1:{http}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["index"] == "exact"
    assert health["map_points"] == int(service["rec"].pt_mask.sum())
    xy, d, m = query_view(service["scene"], service["base"], 8, seed=908)
    out = _post(http, _npz(xy, d, m))
    direct = service["svc"].query(xy, d, m)
    assert out["ok"] and out["R"] == direct["R"] and out["t"] == direct["t"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(http, b"not an npz")
    assert e.value.code == 400 and "error" in json.loads(e.value.read())
    buf = io.BytesIO()
    np.savez(buf, xy=xy)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(http, buf.getvalue())
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{http}/nope", timeout=30)
    assert e.value.code == 404


def test_concurrent_requests_answer_as_sequential(service, http):
    """4 client threads (more than this file's one torch thread) with a
    shortened switch interval: every answer equals the sequential one and
    the query counter, updated under the service's lock, loses no update."""
    import sys

    views = [query_view(service["scene"], service["base"], f, seed=1000 + f)
             for f in (2, 7, 11, 16, 19, 23)]
    seq = [service["svc"].query(*v) for v in views]
    got = [None] * (2 * len(views))
    before = service["svc"].queries

    def client(k):
        for j in range(k, len(got), 4):
            got[j] = _post(http, _npz(*views[j % len(views)]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert service["svc"].queries == before + len(got)
    for j, out in enumerate(got):
        ref = seq[j % len(views)]
        assert out["R"] == ref["R"] and out["t"] == ref["t"] and out["ok"] == ref["ok"]


def test_serve_entry_point(service, tmp_path):
    from fastmatch_tpu_torch.pipeline.checkpoint import save_map

    save_map(service["rec"], str(tmp_path / "map"))
    ready, bound = threading.Event(), {}
    result = {}

    def run():
        result["svc"] = tserve.serve(str(tmp_path / "map"), service["svc"].camera, port=0,
                                     warmup_cap=256, ready_event=ready, device="cpu",
                                     on_bind=lambda s: bound.update(server=s))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert ready.wait(timeout=120)
    port = bound["server"].server_port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        assert json.loads(r.read())["queries_served"] == 0
    xy, d, m = query_view(service["scene"], service["base"], 12, seed=1212)
    assert _post(port, _npz(xy, d, m))["ok"]
    bound["server"].shutdown()
    thread.join(timeout=60)
    assert not thread.is_alive() and result["svc"].queries == 1
    assert bound["server"].service is result["svc"]
