// Fused squared-L2 distance + per-row top-2 + per-column argmin (K2).
//
// Replaces fastmatch_tpu/kernels/distance_topk.py:_distance_topk_kernel
// (entry distance_topk, and _chunked_topk for banks above 4096 rows).
//
// For queries a (N, D), bank b (M, D), masked squared norms b2m (M,) and
// a2m (N,), with cross = a . b^T and neg2 = -2 * cross:
//   row i:    v1 = min_j (neg2 + b2m[j]), idx1 = lowest j attaining it,
//             v2 = min over j != idx1 (floored at BIG),
//             d1 = max(v1 + a2m[i], 0), d2 = max(v2 + a2m[i], 0);
//   column j: nnb = lowest i attaining min_i (neg2 + a2m[i]).
// The (N, M) matrix never reaches device memory.
//
// Bound on the H100: 2*N*M*D operations against N*D + M*D floats read, so
// at the main path's shapes (N = 2048, M = 2048..8192, D = 128) the work is
// operation-bound (67 TFLOP/s fp32 outside the tensor cores). This first
// version is a register-tiled SIMT product: each block keeps a 32-row query
// tile in shared memory for its lifetime and streams 64-column bank tiles
// through shared memory in 32-deep chunks; every thread owns a 2 x 4 block
// of the product. Exact mode multiplies in fp32; fast mode rounds both
// inputs to bf16 on load and accumulates in fp32 (the JAX package's
// precision="fast" semantics). Tensor cores (wgmma) are later work.
//
// Cross-block reductions, since blocks run in parallel:
//   - top-2: the bank is split into column ranges (grid.y); each block
//     writes a (v1, idx1, v2) partial per row and a second kernel merges the
//     partials in column order, lower index winning ties;
//   - column argmin: a 64-bit atomicMin on (order-preserving float bits <<
//     32 | row), deterministic, lowest row winning ties.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;        // query rows per block
constexpr int TM = 64;        // bank columns per tile
constexpr int KC = 32;        // depth chunk streamed through shared memory
constexpr int THREADS = 256;  // 16 (tx: columns) x 16 (ty: row pairs)
constexpr float BIG = 3.0e38f;
constexpr int NO_INDEX = 0x7fffffff;

__device__ __forceinline__ unsigned long long order_key(float v, int row) {
  v = v + 0.0f;  // -0 -> +0: equal values must share a key
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned int>(row);
}

__device__ __forceinline__ float load_in(const float* p, int fast) {
  const float v = *p;
  return fast ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Merge another (v1, i1, v2) summary into this one; equal v1 -> lower index.
__device__ __forceinline__ void merge_top2(float& v1, int& i1, float& v2,
                                           float ov1, int oi1, float ov2) {
  if (ov1 < v1 || (ov1 == v1 && oi1 < i1)) {
    v2 = fminf(ov2, v1);
    v1 = ov1;
    i1 = oi1;
  } else {
    v2 = fminf(v2, ov1);
  }
}

__global__ void __launch_bounds__(THREADS)
topk_tiles(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ b2m, const float* __restrict__ a2m,
           int n, int m, int d, int cols_per_split, int fast,
           float* __restrict__ part_v1, int* __restrict__ part_i1,
           float* __restrict__ part_v2, unsigned long long* __restrict__ col_key) {
  extern __shared__ float smem[];
  float* As = smem;                    // TN x (d + 1)
  float* Bs = smem + TN * (d + 1);     // TM x (KC + 1)
  __shared__ float cv[16][TM];         // per row-pair group column minima
  __shared__ int ci[16][TM];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * TN;
  const int col_begin = blockIdx.y * cols_per_split;
  const int col_end = min(m, col_begin + cols_per_split);
  const int ld = d + 1;

  for (int e = tid; e < TN * d; e += THREADS) {
    const int r = e / d, k = e - r * d;
    const int gr = row0 + r;
    As[r * ld + k] = gr < n ? load_in(a + static_cast<size_t>(gr) * d + k, fast) : 0.f;
  }

  const int r0 = ty * 2;
  float a2r[2];
  float v1[2], v2[2];
  int i1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = row0 + r0 + i;
    a2r[i] = gr < n ? a2m[gr] : BIG;
    v1[i] = __int_as_float(0x7f800000);  // +inf: no column seen yet
    v2[i] = BIG;
    i1[i] = NO_INDEX;
  }

  for (int c0 = col_begin; c0 < col_end; c0 += TM) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

    for (int k0 = 0; k0 < d; k0 += KC) {
      __syncthreads();
      for (int e = tid; e < TM * KC; e += THREADS) {
        const int c = e / KC, k = e - c * KC;
        const int gc = c0 + c;
        Bs[c * (KC + 1) + k] =
            gc < col_end ? load_in(b + static_cast<size_t>(gc) * d + k0 + k, fast) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        const float av0 = As[r0 * ld + k0 + k];
        const float av1 = As[(r0 + 1) * ld + k0 + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float bv = Bs[(tx + 16 * q) * (KC + 1) + k];
          acc[0][q] += av0 * bv;
          acc[1][q] += av1 * bv;
        }
      }
    }

    // Row top-2 over this thread's columns (increasing column order).
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gc = c0 + tx + 16 * q;
      if (gc < col_end) {
        const float bm = b2m[gc];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float s = -2.0f * acc[i][q] + bm;
          if (s < v1[i]) {
            v2[i] = fminf(v2[i], v1[i]);
            v1[i] = s;
            i1[i] = gc;
          } else {
            v2[i] = fminf(v2[i], s);
          }
        }
      }
    }

    // Column argmin over this block's rows, then one atomic per column.
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lc = tx + 16 * q;
      float best = __int_as_float(0x7f800000);
      int brow = NO_INDEX;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int gr = row0 + r0 + i;
        const float sc = -2.0f * acc[i][q] + a2r[i];
        if (gr < n && sc < best) {
          best = sc;
          brow = gr;
        }
      }
      cv[ty][lc] = best;
      ci[ty][lc] = brow;
    }
    __syncthreads();
    if (tid < TM) {
      const int gc = c0 + tid;
      if (gc < col_end) {
        float best = cv[0][tid];
        int brow = ci[0][tid];
        for (int g = 1; g < 16; ++g) {
          if (cv[g][tid] < best) {
            best = cv[g][tid];
            brow = ci[g][tid];
          }
        }
        if (brow != NO_INDEX) atomicMin(col_key + gc, order_key(best, brow));
      }
    }
  }

  // Merge the 16 column lanes of each row pair (one half-warp) and write
  // this split's partial.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov1 = __shfl_xor_sync(0xffffffffu, v1[i], off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, i1[i], off);
      const float ov2 = __shfl_xor_sync(0xffffffffu, v2[i], off);
      merge_top2(v1[i], i1[i], v2[i], ov1, oi1, ov2);
    }
    const int gr = row0 + r0 + i;
    if (tx == 0 && gr < n) {
      const size_t o = static_cast<size_t>(blockIdx.y) * n + gr;
      part_v1[o] = v1[i];
      part_i1[o] = i1[i];
      part_v2[o] = v2[i];
    }
  }
}

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
      merge_top2(v1, i1, v2, part_v1[o], part_i1[o], part_v2[o]);
    }
    const float a2 = a2m[t];
    idx1[t] = i1;
    d1[t] = fmaxf(v1 + a2, 0.f);
    d2[t] = fmaxf(v2 + a2, 0.f);
  }
  if (t < m) nnb[t] = static_cast<int>(col_key[t] & 0xffffffffull);
}

}  // namespace

extern "C" int fm_distance_topk(const float* a, const float* b, const float* b2m,
                                const float* a2m, int n, int m, int d, int fast,
                                int splits, float* part_v1, int* part_i1,
                                float* part_v2, unsigned long long* col_key,
                                int* idx1, float* d1, float* d2, int* nnb,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (m + TM - 1) / TM;
  const int cols_per_split = ((tiles + splits - 1) / splits) * TM;
  const size_t smem = sizeof(float) * (TN * (d + 1) + TM * (KC + 1));
  cudaError_t err = cudaFuncSetAttribute(
      topk_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(col_key, 0xff, sizeof(unsigned long long) * m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + TN - 1) / TN, splits);
  topk_tiles<<<grid, THREADS, smem, s>>>(a, b, b2m, a2m, n, m, d, cols_per_split,
                                         fast, part_v1, part_i1, part_v2, col_key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int work = n > m ? n : m;
  topk_finalize<<<(work + 255) / 256, 256, 0, s>>>(part_v1, part_i1, part_v2, a2m,
                                                   col_key, n, m, splits, idx1,
                                                   d1, d2, nnb);
  return static_cast<int>(cudaGetLastError());
}
