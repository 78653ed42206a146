"""Multi-rank SLAM: the device-resident driver on a (data, bank) mesh.

Port of ``fastmatch_tpu/dist/pipeline.py`` on ``torch.distributed``. It
wires the distributed pieces into the user-facing slam path through the
hook points of the device-resident driver
(``pipeline/slam_device.drive_slam``):

- **Sharded retrieval** (``retrieval`` hook): the per-frame full-bank
  nearest-landmark match — the tracker's dedup gate and its loop-closure
  voting input — runs as the ring matcher over the ``bank`` axis
  (``dist/sharded_match.match_pair_sharded``, K2 a ring step), with the
  landmark descriptor bank split in rows across the ranks.
- **Distributed BA** (``ba`` and ``final_ba`` hooks): ``ba_solve_sharded``
  — the observation table split over ``bank``, camera and point blocks
  all-reduced. At the full window (after a loop closure, and the last
  solve) each rank's slice is one covisibility map block
  (``dist/partition.py``).
- **Overlap**: the driver issues frame k+1's sharded retrieval BEFORE
  reading back frame k's BA/PGO: retrieval depends only on pt_desc/pt_mask,
  which BA and PGO never touch, so the overlapped schedule is
  result-identical to the serial one.
- **Checkpoint/resume** (``after_frame`` hook): the full TrackState and the
  driver's bookkeeping every ``checkpoint_interval`` accepted frames
  (``pipeline/checkpoint.save_track_state``, written by rank 0: the state
  is the same on every rank); a resumed run continues bit for bit
  (per-frame draws depend on (seed, frame) alone).

One difference from the JAX package's hooks: each solve is the port's
single-device solve with its observation table split — the local window
compacted to ``ba.local_obs_cap`` rows at the interval budgets
(``slam_device._local_ba``), the last solve on the live rows at the full
budgets (``slam_device._final_ba``) — where the JAX hooks solve every
window on the whole table at the full budgets. So at one rank the port's
distributed run differs from its ``slam_device`` run only by the order of
its sums.

CLI: ``python -m fastmatch_tpu_torch.cli slam ... --mesh bank=N``.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.dist.bootstrap import initialize_distributed, rank_device
from fastmatch_tpu_torch.dist.dist_ba import ba_solve_sharded
from fastmatch_tpu_torch.dist.mesh import axis_size, make_mesh
from fastmatch_tpu_torch.dist.sharded_match import match_pair_sharded
from fastmatch_tpu_torch.pipeline.config import PipelineConfig
from fastmatch_tpu_torch.pipeline.slam import SlamConfig, SlamResult
from fastmatch_tpu_torch.pipeline.slam_device import SlamHooks, drive_slam
from fastmatch_tpu_torch.pipeline.tracker import (
    FULL_WINDOW, TrackState, ba_problem_from_state, compact_obs, compact_obs_local)


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Mesh/scale-out options for the distributed SLAM pipeline."""

    n_data: int = 1
    n_bank: int | None = None     # None = all remaining ranks
    checkpoint_dir: str | None = None
    checkpoint_interval: int = 0  # accepted frames; 0 = never
    overlap: bool = True          # prefetch retrieval during BA/PGO
    # Relayout full-window observation shards as covisibility map blocks
    # (dist/partition.py) instead of the default global pt-sort.
    partition_blocks: bool = True
    # Failure detection (dist/watchdog.py): bound every distributed-BA
    # readback; on expiry raise CollectiveTimeout for checkpoint-restart
    # instead of hanging on a dead peer. 0 = disabled.
    collective_timeout_s: float = 0.0


class DistSlamHooks(SlamHooks):
    """Sharded retrieval + distributed BA + periodic checkpoint."""

    def __init__(self, mesh, dcfg: DistConfig):
        self.mesh = mesh
        self.dcfg = dcfg
        self.watchdog = None
        if dcfg.collective_timeout_s > 0:
            from fastmatch_tpu_torch.dist.watchdog import Watchdog

            self.watchdog = Watchdog(dcfg.collective_timeout_s)

    def retrieval(self, state: TrackState, desc, mask):
        # ratio=1.0 / no cross-check mirrors the in-step dedup+vote match
        # (tracker.track_step's mf); the ring is bit-equal to the
        # unsharded matcher, so the fused and sharded paths produce
        # identical Matches.
        return match_pair_sharded(
            Descriptors(desc, mask),
            Descriptors(state.pt_desc, state.pt_mask),
            self.mesh, ratio=1.0, cross_check=False)

    def _solve(self, state: TrackState, prob, full_window: bool, max_iters: int,
               pcg_iters: int, huber: float) -> TrackState:
        presorted = False
        if self.dcfg.partition_blocks and full_window:
            # Each rank's observation slice becomes one covisibility map
            # block: tight camera/point working sets, separator cameras
            # reduced by the all-reduce. The host-side partition reads the
            # table back; it runs only at loop closures and at the end.
            from fastmatch_tpu_torch.dist.partition import partition_problem

            prob, _ = partition_problem(prob, axis_size(self.mesh, "bank"))
            presorted = True
        res = ba_solve_sharded(prob, self.mesh, max_iters=max_iters, pcg_iters=pcg_iters,
                               huber_delta_static=huber, presorted=presorted)
        if self.watchdog is not None:
            # Failure detection: a dead peer turns this readback into an
            # infinite hang — bound it and surface CollectiveTimeout for
            # checkpoint-restart.
            self.watchdog.wait(res)
        return state._replace(R=res.poses.R, t=res.poses.t, points=res.points)

    def ba(self, state: TrackState, fid, window, cfg, camera,
           covis=None, covis_thresh: int = 0) -> TrackState:
        prob = ba_problem_from_state(state, fid, window, covis=covis,
                                     covis_thresh=covis_thresh)
        if cfg.ba.local_obs_cap > 0:
            prob = compact_obs_local(prob, cfg.ba.local_obs_cap)
        return self._solve(state, prob, int(window) >= FULL_WINDOW,
                           cfg.ba.interval_max_iters or cfg.ba.max_iters,
                           cfg.ba.interval_pcg_iters or cfg.ba.pcg_iters,
                           cfg.ba.huber_px / float(camera.fx))

    def final_ba(self, state: TrackState, cfg, camera) -> TrackState:
        prob = ba_problem_from_state(state, state.n_frames, FULL_WINDOW)
        prob = compact_obs(prob, int(state.n_obs))
        return self._solve(state, prob, True, cfg.ba.max_iters, cfg.ba.pcg_iters,
                           cfg.ba.huber_px / float(camera.fx))

    def after_frame(self, state, fid, fi, out, book):
        d = self.dcfg
        if (d.checkpoint_dir and d.checkpoint_interval
                and fid % d.checkpoint_interval == 0 and dist.get_rank() == 0):
            from fastmatch_tpu_torch.pipeline.checkpoint import save_track_state

            save_track_state(state, book, out, d.checkpoint_dir)


def slam_distributed(
    features: list,
    camera: Pinhole,
    cfg: PipelineConfig = PipelineConfig(),
    scfg: SlamConfig = SlamConfig(),
    dcfg: DistConfig = DistConfig(),
    mesh=None,
    seed: int = 0,
    metrics=None,
    reloc_max_failures: int = 3,
    resume_from: str | None = None,
    device=None,
) -> SlamResult:
    """Multi-rank SLAM: the slam() API on a (data, bank) mesh, each rank on
    its device (``cuda`` unless ``device="cpu"``; a given ``mesh`` names
    its own). Without a mesh, the process group is joined
    (``initialize_distributed``) and a mesh made from ``dcfg``.

    ``resume_from``: a checkpoint directory written by a previous run's
    ``checkpoint_interval`` snapshots; the run continues from it
    bit-deterministically (same seed => same trajectory as uninterrupted).
    """
    if mesh is None:
        initialize_distributed(device=device)
        mesh = make_mesh(n_data=dcfg.n_data, n_bank=dcfg.n_bank)
    dev = rank_device(mesh.device_type if device is None else device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev} is not on the mesh's {mesh.device_type}")
    n_bank = axis_size(mesh, "bank")
    if cfg.map.max_points % n_bank:
        raise ValueError(
            f"map.max_points {cfg.map.max_points} must divide by the bank "
            f"axis size {n_bank} (row-sharded landmark bank)")
    hooks = DistSlamHooks(mesh, dcfg)
    if not dcfg.overlap:
        # Serial mode: keep the fused in-step retrieval (no prefetch) —
        # used by tests to isolate the overlap discipline.
        hooks.retrieval = lambda state, desc, mask: None

    resume = None
    if resume_from is not None:
        from fastmatch_tpu_torch.pipeline.checkpoint import restore_track_state

        # Every rank reads the snapshot after rank 0 has finished writing it.
        dist.barrier()
        resume = restore_track_state(resume_from, device=dev)
    return drive_slam(
        features, camera, cfg, scfg, seed=seed, metrics=metrics,
        reloc_max_failures=reloc_max_failures, hooks=hooks, resume=resume, device=dev)
