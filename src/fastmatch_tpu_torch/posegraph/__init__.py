from fastmatch_tpu_torch.posegraph.pgo import (
    PoseGraph,
    pgo_solve,
    pgo_solve_hierarchical,
    with_pose_priors,
    with_position_priors,
)
from fastmatch_tpu_torch.posegraph.sim3 import (
    Sim3Graph,
    graph_from_se3,
    sim3_correct_map,
    sim3_pgo_solve,
)

__all__ = ["PoseGraph", "Sim3Graph", "graph_from_se3", "pgo_solve",
           "pgo_solve_hierarchical", "sim3_correct_map", "sim3_pgo_solve",
           "with_pose_priors", "with_position_priors"]
