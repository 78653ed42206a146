// Fused squared-L2 distance + per-row top-2 + per-column argmin (K2).
//
// Replaces fastmatch_tpu/kernels/distance_topk.py:_distance_topk_kernel
// (entry distance_topk, and _chunked_topk for banks above 4096 rows).
//
// For queries a (N, D), bank b (M, D), masked squared norms b2m (M,) and
// a2m (N,), with neg2 = -2 * (a . b^T):
//   row i:    v1 = min_j (neg2 + b2m[j]), idx1 = lowest j attaining it,
//             v2 = min over j != idx1 (floored at BIG),
//             d1 = max(v1 + a2m[i], 0), d2 = max(v2 + a2m[i], 0);
//   column j: nnb = lowest i attaining min_i (neg2 + a2m[i]).
// The (N, M) matrix never reaches device memory.
//
// Bound on the H100: 2*N*M*D operations against N*D + M*D floats read, so
// at the main path's shapes (N = 2048, M = 2048..8192, D = 128) the work is
// operation-bound: 67 TFLOP/s fp32 outside the tensor cores (exact mode),
// 989 TFLOP/s bf16 on them (fast mode).
//
// Design: the single-pair case of the tile engine in match_tile.cuh (K1 is
// its batched case). Each block keeps 128 queries in shared memory and
// sweeps one bank range ("split"); the wrapper picks the number of splits
// so that the grid fills the 132 SMs once. Exact mode runs the engine's
// register-tiled fp32 product (8 x 8 per thread, cp.async ring); fast mode
// takes bf16 operands (the wrapper rounds them, as the parent kernel did on
// load) into wgmma m64n64k16 with fp32 sums. The -2 is applied in the
// epilogue (scale -2, exact).
//
// Cross-block reductions, since blocks run in parallel:
//   - top-2: each block writes a (v1, idx1, v2) partial per row for its
//     split; topk_finalize merges the partials in split (column) order,
//     lower index winning ties;
//   - column argmin: a 64-bit atomicMin on (order-preserving float bits <<
//     32 | row), deterministic, lowest row winning ties.

#include "match_tile.cuh"

namespace {

__global__ void topk_finalize(const float* __restrict__ part_v1,
                              const int* __restrict__ part_i1,
                              const float* __restrict__ part_v2,
                              const float* __restrict__ a2m,
                              const unsigned long long* __restrict__ col_key,
                              int n, int m, int splits,
                              int* __restrict__ idx1, float* __restrict__ d1,
                              float* __restrict__ d2, int* __restrict__ nnb) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    float v1 = part_v1[t], v2 = part_v2[t];
    int i1 = part_i1[t];
    for (int s = 1; s < splits; ++s) {
      const size_t o = static_cast<size_t>(s) * n + t;
      fm::merge_top2(v1, i1, v2, part_v1[o], part_i1[o], part_v2[o]);
    }
    const float a2 = a2m[t];
    idx1[t] = i1;
    d1[t] = fmaxf(v1 + a2, 0.f);
    d2[t] = fmaxf(v2 + a2, 0.f);
  }
  if (t < m) nnb[t] = static_cast<int>(col_key[t] & 0xffffffffull);
}

}  // namespace

// a, b: float32 (exact) or bfloat16 (fast) rows of any depth d that is a
// multiple of 32 (past 256 the engine's depth loop). part_* hold (splits, n)
// partials, col_key (m,) keys; cols_per_split is a multiple of 128.
extern "C" int fm_distance_topk(const void* a, const void* b, const float* b2m,
                                const float* a2m, int n, int m, int d, int fast,
                                int splits, int cols_per_split, float* part_v1,
                                int* part_i1, float* part_v2,
                                unsigned long long* col_key, int* idx1, float* d1,
                                float* d2, int* nnb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 32 || d <= 0 || cols_per_split % fm::BN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(col_key, 0xff, sizeof(unsigned long long) * m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // nnb covers dead bank rows too, so no tile is skipped.
  fm::TileArgs g{a, b, a2m, b2m, n, m, d, 1, cols_per_split, 1, -2.0f, 0, nullptr, nullptr,
                 part_v1, part_i1, part_v2, col_key};
  err = fast ? fm::launch_tiles<fm::MODE_BF16, fm::COL_INDEX>(g, splits, s)
             : fm::launch_tiles<fm::MODE_EXACT, fm::COL_INDEX>(g, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int work = n > m ? n : m;
  topk_finalize<<<(work + 255) / 256, 256, 0, s>>>(part_v1, part_i1, part_v2, a2m,
                                                   col_key, n, m, splits, idx1,
                                                   d1, d2, nnb);
  return static_cast<int>(cudaGetLastError());
}
