"""Worker of tests/test_torch_calibrate.py's reduce-hook test: one rank of an
observation-sharded ``refine_intrinsics`` whose hook is
``torch.distributed.all_reduce`` over gloo (torch and the port only)."""

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x)
    return x


def rank_main(rank, world, addr, shards, vec0, out):
    """Refine on shard ``rank`` of ``shards``; rank 0 puts its result in ``out``."""
    from fastmatch_tpu_torch.ba.calibrate import refine_intrinsics

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        R, t, X, oc, op, uv, m = shards[rank]
        res = refine_intrinsics(R, t, X, oc, op, uv, m, vec0, model="pinhole", max_iters=6,
                                reduce=all_reduce)
        got = torch.cat([res.vec, res.cost.reshape(1), torch.tensor([float(res.iters)])])
        gathered = [torch.empty_like(got) for _ in range(world)]
        dist.all_gather(gathered, got)
        if rank == 0:
            out.put(torch.stack(gathered).numpy())
    finally:
        dist.destroy_process_group()
