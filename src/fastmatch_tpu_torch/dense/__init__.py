from fastmatch_tpu_torch.dense.densify import densify, select_pairs
from fastmatch_tpu_torch.dense.stereo import (StereoConfig, depth_from_disparity,
                                              disparity_to_points, rectify_pair,
                                              stereo_batch, stereo_disparity)

__all__ = ["StereoConfig", "densify", "depth_from_disparity", "disparity_to_points",
           "rectify_pair", "select_pairs", "stereo_batch", "stereo_disparity"]
