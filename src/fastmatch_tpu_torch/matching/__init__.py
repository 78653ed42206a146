from fastmatch_tpu_torch.matching.hamming import (
    hamming_distance_matrix,
    match_batch_hamming,
    match_pair_hamming,
    match_pair_hamming_plain,
)
from fastmatch_tpu_torch.matching.matcher import match_batch, match_pair, match_pair_plain

__all__ = [
    "hamming_distance_matrix",
    "match_batch",
    "match_batch_hamming",
    "match_pair",
    "match_pair_hamming",
    "match_pair_hamming_plain",
    "match_pair_plain",
]
