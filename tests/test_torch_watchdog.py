"""In-engine failure detection in the port (``dist/watchdog.py``), modelled
on tests/test_watchdog.py.

Unit: the Watchdog raises CollectiveTimeout on a wait that never finishes
(a leaf whose ``synchronize`` hangs, as a CUDA event behind a dead
collective would), fires its hook, passes a fast wait and a real tensor
through; Heartbeat files go stale when a process stops beating.

Fault injection (``slow``): two real gloo processes run a loop of
distributed BA steps (``ba_solve_sharded`` on a (1, 2) mesh) with per-step
checkpoints; process 1 is killed mid-loop, process 0 must DETECT the loss
(an error from the collective, or the watchdog's bounded wait) and abort;
the supervisor restarts both from the last checkpoint and the final state
must equal the uninterrupted run's exactly.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

import dist_ranks

from fastmatch_tpu_torch.dist.watchdog import (
    CollectiveTimeout, Heartbeat, Watchdog, stale_peers)


class _SlowLeaf:
    """Duck-types the CUDA event interface with a hang."""

    def __init__(self, seconds):
        self.seconds = seconds

    def synchronize(self):
        time.sleep(self.seconds)


class TestWatchdogUnit:
    def test_timeout_raises(self):
        wd = Watchdog(0.3)
        t0 = time.perf_counter()
        with pytest.raises(CollectiveTimeout):
            wd.wait(_SlowLeaf(30.0))
        assert time.perf_counter() - t0 < 5.0

    def test_fast_readback_passes_through(self):
        wd = Watchdog(5.0)
        leaf = _SlowLeaf(0.0)
        assert wd.wait(leaf) is leaf

    def test_on_timeout_hook_fires(self):
        fired = []
        wd = Watchdog(0.2, on_timeout=lambda: fired.append(1))
        with pytest.raises(CollectiveTimeout):
            wd.wait(_SlowLeaf(30.0))
        assert fired == [1]

    def test_real_tensor_wait(self):
        wd = Watchdog(30.0)
        x = torch.arange(8) * 2
        tree = (x, {"y": x + 1})
        assert wd.wait(tree) is tree
        assert int(x.sum()) == 56

    def test_heartbeat_and_stale_peers(self, tmp_path):
        a = str(tmp_path / "a.hb")
        b = str(tmp_path / "b.hb")
        hb = Heartbeat(a, interval_s=0.1).start()
        Heartbeat(b).beat()  # one beat, then silence
        time.sleep(0.5)
        hb.beat()
        dead = stale_peers({"a": a, "b": b, "c": str(tmp_path / "no.hb")},
                           stale_s=0.4)
        hb.stop()
        assert "a" not in dead
        assert "b" in dead and "c" in dead


_WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    coordinator, pid, n_steps, die_at, ckpt = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
        sys.argv[5])

    from fastmatch_tpu_torch.dist.bootstrap import initialize_distributed
    info = initialize_distributed(coordinator, 2, pid, device="cpu", timeout_s=30)
    assert info["global_devices"] == 2, info

    from fastmatch_tpu_torch.dist.dist_ba import ba_solve_sharded
    from fastmatch_tpu_torch.dist.mesh import make_mesh
    from fastmatch_tpu_torch.dist.watchdog import (
        CollectiveTimeout, Heartbeat, Watchdog)
    from fastmatch_tpu_torch.interop import ba_problem_from_numpy

    mesh = make_mesh(1, 2)
    hb = Heartbeat(os.path.join(ckpt, f"proc{pid}.hb"), 0.5).start()

    # Deterministic synthetic BA problem, same on both processes.
    rng = np.random.default_rng(0)
    n_cams, n_pts, n_obs = 6, 48, 512
    pts_gt = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (n_cams, 1, 1))
    t = np.zeros((n_cams, 3), np.float32)
    t[:, 2] = 4.0 + 0.3 * np.arange(n_cams)
    cam_idx = rng.integers(0, n_cams, n_obs).astype(np.int32)
    pt_idx = rng.integers(0, n_pts, n_obs).astype(np.int32)
    p = np.einsum("oij,oj->oi", R[cam_idx], pts_gt[pt_idx]) + t[cam_idx]
    uv = (p[:, :2] / p[:, 2:3]).astype(np.float32)
    fixed = np.zeros(n_cams, bool); fixed[:2] = True

    state_path = os.path.join(ckpt, "state.npz")
    start = 0
    poses_R, poses_t = R.copy(), t.copy()
    points = (pts_gt + 0.05).astype(np.float32)
    if os.path.exists(state_path):
        with np.load(state_path) as z:
            start = int(z["step"])
            poses_R, poses_t, points = z["R"], z["t"], z["points"]
        print(f"proc{pid} resumed at step {start}", flush=True)

    wd = Watchdog(20.0)
    for step in range(start, n_steps):
        if pid == 1 and step == die_at:
            os._exit(17)  # simulated host loss, mid-BA-loop
        # Each step perturbs the restored state and re-solves: step k+1
        # CONSUMES step k's output, so the checkpoint is load-bearing.
        prob = ba_problem_from_numpy(
            poses_R, poses_t, points + 0.01 * (step + 1), cam_idx, pt_idx, uv,
            np.ones(n_obs, bool), np.ones(n_cams, bool), np.ones(n_pts, bool), fixed,
            device="cpu")
        try:
            res = ba_solve_sharded(prob, mesh, max_iters=2, pcg_iters=8)
            wd.wait(res)
        except CollectiveTimeout:
            print(f"proc{pid} DETECTED peer loss at step {step} "
                  f"(watchdog timeout)", flush=True)
            os._exit(3)
        except Exception as e:
            # gloo surfaces the dead peer as an error of the collective
            # itself (the host blocks in it): that is detection too.
            print(f"proc{pid} DETECTED peer loss at step {step} "
                  f"({type(e).__name__})", flush=True)
            os._exit(3)
        poses_R = res.poses.R.numpy()
        poses_t = res.poses.t.numpy()
        points = res.points.numpy()
        if pid == 0:
            tmp = state_path + ".tmp.npz"
            np.savez(tmp, step=step + 1, R=poses_R, t=poses_t,
                     points=points)
            os.replace(tmp, state_path)

    digest = float(np.abs(poses_t).sum() + np.abs(points).sum())
    print(f"proc{pid} FINAL {digest:.9e}", flush=True)
    """
)


def _launch(worker, ckpt, die_at, n_steps=4):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    coordinator = f"127.0.0.1:{dist_ranks.free_port()}"
    return [
        subprocess.Popen(
            [sys.executable, str(worker), coordinator, str(pid),
             str(n_steps), str(die_at), str(ckpt)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for pid in range(2)
    ]


def _collect(procs, timeout=300):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    return outs


@pytest.mark.slow
def test_kill_one_process_mid_ba_detect_and_restart(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    # Reference: uninterrupted 2-process run.
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    outs = _collect(_launch(worker, ref_dir, die_at=-1))
    ref_final = [line for line in outs[0].splitlines() if "FINAL" in line]
    assert ref_final, outs[0]

    # Fault run: process 1 dies at step 2; process 0 must detect (not
    # hang) and abort with the detection exit code.
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    procs = _launch(worker, run_dir, die_at=2)
    outs = _collect(procs)
    assert procs[1].returncode == 17, outs[1]
    assert procs[0].returncode == 3, (procs[0].returncode, outs[0])
    assert "DETECTED peer loss at step 2" in outs[0], outs[0]
    # The heartbeat trail lets a supervisor confirm WHICH process died.
    time.sleep(1.5)
    dead = stale_peers(
        {p: str(run_dir / f"proc{p}.hb") for p in (0, 1)}, stale_s=1.2)
    assert 1 in dead

    # Restart from the last checkpoint (written at end of step 1): the
    # continuation must complete and match the uninterrupted run exactly
    # (same ranks, same reduction order -> bitwise-identical digests).
    outs = _collect(_launch(worker, run_dir, die_at=-1))
    assert "resumed at step 2" in outs[0], outs[0]
    got_final = [line for line in outs[0].splitlines() if "FINAL" in line]
    assert got_final, outs[0]
    assert got_final[0].split()[-1] == ref_final[0].split()[-1], (
        got_final, ref_final)
