"""Gloo ranks of the port's distributed tests (torch and the port only).

``spawn`` starts ``world`` processes (``torch.multiprocessing`` spawn, one
thread each), joins them into one gloo group through
``dist.bootstrap.initialize_distributed``, runs ``target(rank, world,
*args)`` in each and returns every rank's result. Ranks are processes, not
threads: ``torch.func.jacfwd`` is not thread-safe, and each rank needs its
own default process group. ``once`` computes a module's rank results once
for all the pytest-xdist workers of a session.

The ``*_case(s)`` functions are the ranks' work; they return numpy arrays.
"""

from __future__ import annotations

import fcntl
import pickle
import socket
import traceback

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _rank_main(target, rank, world, coordinator, args, queue):
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from fastmatch_tpu_torch.dist.bootstrap import initialize_distributed

        if world == 1:  # a world-size-1 group on a local store
            initialize_distributed(device="cpu", timeout_s=120)
        else:
            initialize_distributed(coordinator, world, rank, device="cpu", timeout_s=120)
        try:
            queue.put((rank, target(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — relay to the test
        queue.put((rank, RuntimeError(f"rank {rank}:\n{traceback.format_exc()}")))


class Ranks:
    """``world`` gloo ranks running ``target(rank, world, *args)``, started
    at construction; ``results()`` waits for them."""

    def __init__(self, target, world: int, *args, timeout: float = 300.0):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.queue = ctx.Queue()
        coordinator = f"127.0.0.1:{free_port()}"
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(target, r, world, coordinator, args, self.queue))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self) -> list:
        """[each rank's result]; a rank's exception is raised here."""
        try:
            got = dict(self.queue.get(timeout=self.timeout) for _ in range(self.world))
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        for r in range(self.world):
            if isinstance(got[r], BaseException):
                raise got[r]
        return [got[r] for r in range(self.world)]


def spawn(target, world: int, *args, timeout: float = 300.0) -> list:
    """[target(rank, world, *args) for each rank], run on ``world`` gloo
    ranks; a rank's exception is raised here."""
    return Ranks(target, world, *args, timeout=timeout).results()


def once(request, tmp_path_factory, name: str, fn):
    """``fn()`` computed once a session: under pytest-xdist the first worker
    that asks computes it, under a file lock, and the others load its
    pickle."""
    if getattr(request.config, "workerinput", None) is None:
        return fn()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as fh:
                return pickle.load(fh)
        out = fn()
        with open(path, "wb") as fh:
            pickle.dump(out, fh)
        return out


# -- the ranks' work ------------------------------------------------------------------


def _np(m):
    return {k: getattr(m, k).numpy() for k in ("idx", "dist", "valid")}


def _desc(a, m):
    from fastmatch_tpu_torch.core.containers import Descriptors

    return Descriptors(torch.from_numpy(a), torch.from_numpy(m))


def _ba(res) -> dict:
    return dict(R=res.poses.R.numpy(), t=res.poses.t.numpy(), points=res.points.numpy(),
                cost=float(res.cost), cost0=float(res.cost0), iters=res.iters)


def dist_cases(rank, world, inputs):
    """tests/test_torch_dist.py's sharded routes on a (1, world) mesh and,
    at 4 ranks, on a (2, 2) mesh."""
    from fastmatch_tpu_torch.dist.bootstrap import broadcast_config
    from fastmatch_tpu_torch.dist.dist_ba import ba_solve_sharded
    from fastmatch_tpu_torch.dist.mesh import make_mesh, replicated
    from fastmatch_tpu_torch.dist.retrieve import retrieve_sharded
    from fastmatch_tpu_torch.dist.sharded_match import match_batch_dp, match_pair_sharded
    from fastmatch_tpu_torch.interop import ba_problem_from_numpy
    from fastmatch_tpu_torch.pipeline.config import MatchingConfig, PipelineConfig

    meshes = {f"1x{world}": make_mesh(1, world)}
    if world == 4:
        meshes["2x2"] = make_mesh(2, 2)
        meshes["4x1"] = make_mesh(4, 1)
    out = {}
    for name, mesh in meshes.items():
        if mesh["bank"].size() > 1 or world == 1:
            out[f"ring_{name}"] = _np(match_pair_sharded(*(_desc(*x) for x in inputs["ring"]),
                                                         mesh))
            q, db, dm = (torch.from_numpy(x) for x in inputs["retrieve"])
            v, ids = retrieve_sharded(q, db, dm, mesh, topk=inputs["topk"])
            out[f"retrieve_{name}"] = (v.numpy(), ids.numpy())
            out[f"ba_{name}"] = _ba(ba_solve_sharded(
                ba_problem_from_numpy(*inputs["ba"], device="cpu"), mesh, **inputs["ba_kw"]))
        if mesh["data"].size() > 1:
            out[f"dp_{name}"] = _np(match_batch_dp(*(_desc(*x) for x in inputs["dp"]), mesh))
    x = torch.from_numpy(inputs["replicated"])
    for name, mesh in meshes.items():
        rep = replicated(mesh)
        out[f"replicated_{name}"] = (rep.shard(x).numpy(), rep.gather(rep.shard(x)).numpy())
    mesh = meshes[f"1x{world}"]
    out["adversarial"] = _np(match_pair_sharded(*(_desc(*x) for x in inputs["adversarial"]),
                                                mesh))
    out["padding"] = _ba(ba_solve_sharded(ba_problem_from_numpy(*inputs["ba_pad"], device="cpu"),
                                          mesh, max_iters=6))
    try:
        make_mesh(3, 1)
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)
    mine = PipelineConfig(matching=MatchingConfig(ratio=0.5 + 0.1 * rank))
    out["config_rank0"] = broadcast_config(mine)
    out["config_rank1"] = broadcast_config(mine, is_source=rank == world - 1)
    return out


def _slam(out) -> dict:
    import dist_fixtures as fx

    rec = out.rec
    return dict(fx.summary(out, fx.scene_and_features()[0]), R=rec.R[:rec.n_frames].copy(),
                t=rec.t[:rec.n_frames].copy(), points=rec.points.copy())


def pipeline_cases(rank, world, ckpt):
    """tests/test_torch_dist_pipeline.py's runs of ``slam_distributed``:
    overlapped with snapshots every 10 frames into ``ckpt`` (and, at more
    than one rank, serial with the watchdog armed; resumed from the
    snapshot on features whose first 15 frames are wrecked; and from
    scratch on those, which must fail)."""
    import dist_fixtures as fx
    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.dist.mesh import make_mesh
    from fastmatch_tpu_torch.dist.pipeline import DistConfig, slam_distributed

    scene, feats = fx.scene_and_features()
    cfg, scfg = fx.configs("fastmatch_tpu_torch")
    cam = Pinhole.from_K(scene.K)
    mesh = make_mesh(1, world)
    # At one rank the full-window solves take the default global pt-sort
    # instead of the covisibility partition (two ranks run the partition).
    out = {"overlap": _slam(slam_distributed(
        feats, cam, cfg, scfg, DistConfig(overlap=True, checkpoint_dir=ckpt,
                                          checkpoint_interval=10,
                                          partition_blocks=world > 1), mesh=mesh))}
    if world == 1:
        return out
    # The serial run also arms the watchdog around every sharded solve.
    out["serial"] = _slam(slam_distributed(feats, cam, cfg, scfg,
                                           DistConfig(overlap=False, collective_timeout_s=60.0),
                                           mesh=mesh))
    wrecked = list(feats)
    for k in range(15):
        xy, d, m = wrecked[k]
        wrecked[k] = (xy, np.zeros_like(d), np.zeros_like(m))
    out["resumed"] = _slam(slam_distributed(wrecked, cam, cfg, scfg, DistConfig(overlap=True),
                                            mesh=mesh, resume_from=ckpt))
    try:
        slam_distributed(wrecked, cam, cfg, scfg, DistConfig(overlap=True), mesh=mesh)
        out["scratch_error"] = None
    except RuntimeError as e:
        out["scratch_error"] = str(e)
    return out


def partition_cases(rank, world, arrs):
    """tests/test_torch_partition.py's solves on a (1, world) mesh: the
    default sharded solve, the same with the rows reordered into
    covisibility blocks, and ``partition_problem``'s layout solved
    ``presorted``."""
    from fastmatch_tpu_torch.ba.problem import Observations
    from fastmatch_tpu_torch.dist.dist_ba import ba_solve_sharded
    from fastmatch_tpu_torch.dist.mesh import make_mesh
    from fastmatch_tpu_torch.dist.partition import (covisibility_matrix,
                                                    order_observations_by_block,
                                                    partition_frames, partition_problem)
    from fastmatch_tpu_torch.interop import ba_problem_from_numpy

    mesh = make_mesh(1, world)
    prob = ba_problem_from_numpy(*arrs, device="cpu")
    C = covisibility_matrix(prob.obs.cam_idx, prob.obs.pt_idx, prob.obs.mask, prob.n_cams,
                            prob.n_points)
    perm, _ = order_observations_by_block(prob.obs, partition_frames(C, world), world)
    perm = torch.from_numpy(perm).long()
    blk = prob._replace(obs=Observations(*(x[perm] for x in prob.obs)))
    part, _ = partition_problem(prob, world, bucket=8)
    kw = dict(max_iters=5, pcg_iters=20)
    return dict(plain=_ba(ba_solve_sharded(prob, mesh, **kw)),
                blocks=_ba(ba_solve_sharded(blk, mesh, **kw)),
                partition=_ba(ba_solve_sharded(part, mesh, presorted=True, **kw)))


def cli_case(rank, world, argv):
    """The JSON lines one rank's ``cli.main(argv)`` prints."""
    import contextlib
    import io
    import json

    from fastmatch_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
