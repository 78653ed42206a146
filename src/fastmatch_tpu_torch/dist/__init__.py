from fastmatch_tpu_torch.dist.mesh import make_mesh, bank_sharding, batch_sharding
from fastmatch_tpu_torch.dist.sharded_match import match_pair_sharded, match_batch_dp
from fastmatch_tpu_torch.dist.dist_ba import ba_solve_sharded
from fastmatch_tpu_torch.dist.overlap import OverlapScheduler

__all__ = [
    "make_mesh",
    "bank_sharding",
    "batch_sharding",
    "match_pair_sharded",
    "match_batch_dp",
    "ba_solve_sharded",
    "OverlapScheduler",
]
