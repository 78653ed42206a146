// Batched fused matcher (K1): B pairs of descriptor sets, per-query top-2,
// Lowe ratio test and mutual check, for the whole batch in one launch.
//
// Replaces fastmatch_tpu/kernels/batch_match.py:_batch_match_kernel (entry
// match_batch_fused). For pair p with queries a (N, D), bank b (M, D) and
// masked squared norms a2m (N,), b2m (M,) (BIG on dead rows), with
// neg2 = -2 a.b (the -2 folded into the query operand by the wrapper):
//   srow = neg2 + b2m[j]; v1 = min_j srow, i1 = lowest j attaining it,
//   v2 = min over j != i1 (BIG if none); d = max(v + a2m[q], 0);
//   ok = a2m[q] < BIG && d1 < r2 * d2 && d2 < BIG, and with cross_check:
//   exact:        mutual = (lowest q' attaining min_q' (neg2 + a2m[q'])
//                           in bank row i1) == q;
//   fast/binary:  mutual = v1 + a2m[q] <= min_q' (srow[q', i1] + a2m[q']).
// Modes: 0 exact (fp32 operands, fp32 products), 1 fast (bf16 operands,
// fp32 sums), 2 binary (packed uint32 words; the +-1 dot product with the
// -2 prescale is 4 * popc(a ^ b) - 2 * n_bits, an exact integer, so
// decisions and distances equal the popcount matcher's bit for bit).
//
// Bound on the H100: 2*B*N*M*D operations against B*(N+M)*D operand words,
// so at config 2's shapes (B = 64, N = M = 2048, D = 128) every mode is
// operation-bound: exact at 67 TFLOP/s fp32 (the parity contract keeps it
// off the tensor cores), fast at 989 TFLOP/s bf16, binary at 1979 TOP/s
// int8 (+-1 bytes).
//
// Design: the batched case of the tile engine in match_tile.cuh (K2 is its
// single-pair case). A grid of (128-query tile, bank split, pair); at
// config 2 the 1024 (tile, pair) blocks fill the card, so the bank is
// split only when a batch gives fewer blocks than SMs. Exact mode runs the
// engine's register-tiled fp32 product (8 x 8 per thread, cp.async ring);
// fast mode feeds bf16 tiles in wgmma's swizzled layout to wgmma
// m64n64k16; binary mode unpacks each word to 32 bytes of +-1 on its way
// into shared memory and runs wgmma m64n64k32 .s32.s8.s8, replacing the
// popcount loop (POPC runs at 16 per clock per SM on Hopper, a ~0.5 ms
// floor at config 2). Bank tiles whose rows are all dead are skipped where
// that cannot change a result (match_tile.cuh: dead bank tiles). The per-bank-row reduction over queries is a 64-bit
// atomicMin on (order-preserving float bits << 32 | query): deterministic,
// lowest query winning ties (fast and binary key the value alone). The
// finalize kernel merges the splits' partials and applies the tests once
// every block of the pair is done.

#include "match_tile.cuh"

namespace {

__global__ void batch_match_finalize(const float* __restrict__ part_v1,
                                     const int* __restrict__ part_i1,
                                     const float* __restrict__ part_v2,
                                     const float* __restrict__ a2m_all,
                                     const unsigned long long* __restrict__ col_key_all,
                                     int batch, int n, int m, int splits, int value_mutual,
                                     int cross_check, float r2, int* __restrict__ idx_all,
                                     float* __restrict__ dist_all,
                                     bool* __restrict__ valid_all) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(batch) * n;
  if (t >= total) return;
  const int p = static_cast<int>(t / n);
  const int q = static_cast<int>(t - static_cast<size_t>(p) * n);
  float v1 = part_v1[t], v2 = part_v2[t];
  int i1 = part_i1[t];
  for (int s = 1; s < splits; ++s) {
    const size_t o = static_cast<size_t>(s) * total + t;
    fm::merge_top2(v1, i1, v2, part_v1[o], part_i1[o], part_v2[o]);
  }
  const float a2 = a2m_all[t];
  const float d1 = fmaxf(v1 + a2, 0.f);
  const float d2 = fmaxf(v2 + a2, 0.f);
  bool ok = (a2 < fm::BIG) && (d1 < r2 * d2) && (d2 < fm::BIG);
  if (cross_check) {
    bool mutual = false;
    if (i1 >= 0 && i1 < m) {
      const unsigned long long key = col_key_all[static_cast<size_t>(p) * m + i1];
      mutual = value_mutual
          ? v1 + a2 <= fm::from_order_bits(static_cast<unsigned int>(key >> 32))
          : static_cast<int>(key & 0xffffffffull) == q;
    }
    ok = ok && mutual;
  }
  idx_all[t] = i1;
  dist_all[t] = ok ? d1 : fm::BIG;
  valid_all[t] = ok;
}

}  // namespace

// mode: 0 exact (a, b float32), 1 fast (a, b bf16), 2 binary (a, b packed
// words, d words); any depth (a multiple of 32 values, or of 4 words up to
// MAX_WORDS): past the resident depth the engine runs its depth loop. a2raw (batch, n) and b2raw (batch, m): the unmasked
// squared norms, or null when they are a constant below 1e30 (binary),
// for skipping dead bank tiles (match_tile.cuh). part_* hold (splits,
// batch, n) partials, col_key (batch, m) keys (unused without
// cross_check); cols_per_split is a multiple of 128.
extern "C" int fm_batch_match(const void* a, const void* b, const float* a2m,
                              const float* b2m, int batch, int n, int m, int d, int mode,
                              int cross_check, float r2, int splits, int cols_per_split,
                              const float* a2raw, const float* b2raw, float* part_v1,
                              int* part_i1, float* part_v2,
                              unsigned long long* col_key, int* idx, float* dist,
                              bool* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bad_depth = mode == 2 ? (d % 4 || d <= 0 || d > fm::MAX_WORDS)
                                   : (d % 32 || d <= 0);
  if (bad_depth || cols_per_split % fm::BN || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (cross_check) {
    err = cudaMemsetAsync(col_key, 0xff, sizeof(unsigned long long) * batch * m, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fm::TileArgs g{a, b, a2m, b2m, n, m, d, batch, cols_per_split, cross_check, 1.0f, 1,
                 a2raw, b2raw, part_v1, part_i1, part_v2, col_key};
  if (mode == 0) {
    err = fm::launch_tiles<fm::MODE_EXACT, fm::COL_INDEX>(g, splits, s);
  } else if (mode == 1) {
    err = fm::launch_tiles<fm::MODE_BF16, fm::COL_VALUE>(g, splits, s);
  } else {
    err = fm::launch_tiles<fm::MODE_BINARY, fm::COL_VALUE>(g, splits, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(batch) * n;
  batch_match_finalize<<<static_cast<unsigned int>((total + 255) / 256), 256, 0, s>>>(
      part_v1, part_i1, part_v2, a2m, col_key, batch, n, m, splits, mode != 0, cross_check,
      r2, idx, dist, valid);
  return static_cast<int>(cudaGetLastError());
}
