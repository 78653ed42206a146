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
// fp32 sums: bf16 x bf16 products are exact in fp32), 2 binary (packed
// uint32 words; the dot product of the +-1 vectors with the -2 prescale is
// 4 * popc(a ^ b) - 2 * n_bits, an exact integer, so decisions and
// distances equal the popcount matcher's bit for bit).
//
// Bound on the H100: 2*B*N*M*D operations against B*(N+M)*D operand words,
// so at config 2's shapes (B = 64, N = M = 2048, D = 128) the float modes
// are operation-bound (67 TFLOP/s fp32 outside the tensor cores; the kernel
// does not use them). Design: a grid of (query tile, pair). Each 256-thread
// block keeps its 64 queries in shared memory (transposed, k-major) and
// streams the pair's bank in 64-row tiles and 32-deep chunks; each thread
// owns a 4 x 4 block of the product, read as one float4 of queries and one
// of bank rows per depth step. Row top-2 lives in registers across the
// whole bank (no (N, M) matrix in device memory), merged over the 16
// column lanes by shuffles at the end with the lower index winning ties.
// Blocks of one pair run in parallel, so the per-bank-row reduction over
// queries is a 64-bit atomicMin on (order-preserving float bits << 32 |
// query): deterministic, lowest query winning ties (fast mode keys the value
// alone). The finalize kernel reads it once every block of the pair is done.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;        // queries per block
constexpr int TM = 64;        // bank rows per tile
constexpr int KC = 32;        // depth chunk of a bank tile
constexpr int LDA = TN + 4;   // k-major query tile stride (floats)
constexpr int LDB = TM + 4;   // k-major bank chunk stride (floats)
constexpr int THREADS = 256;  // 16 (tx: bank rows) x 16 (ty: queries)
constexpr float BIG = 3.0e38f;
constexpr int NO_INDEX = 0x7fffffff;

__device__ __forceinline__ unsigned int order_bits(float v) {
  v = v + 0.0f;  // -0 -> +0: equal values must share a key
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

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

template <int MODE>
__device__ __forceinline__ float load_operand(const void* p, size_t i) {
  if constexpr (MODE == 1) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else {
    return static_cast<const float*>(p)[i];
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
batch_match_tiles(const void* __restrict__ a_all, const void* __restrict__ b_all,
                  const float* __restrict__ a2m_all, const float* __restrict__ b2m_all,
                  int n, int m, int d, int cross_check, int n_bits,
                  unsigned long long* __restrict__ col_key_all,
                  int* __restrict__ idx_all, float* __restrict__ d1_all,
                  float* __restrict__ d2_all, float* __restrict__ t1_all) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float cv[16][TM];
  __shared__ int ci[16][TM];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * TN;
  const size_t a_off = static_cast<size_t>(p) * n * d;
  const size_t b_off = static_cast<size_t>(p) * m * d;
  const float* a2m = a2m_all + static_cast<size_t>(p) * n;
  const float* b2m = b2m_all + static_cast<size_t>(p) * m;
  unsigned long long* col_key = col_key_all + static_cast<size_t>(p) * m;

  // Query tile: k-major floats (modes 0, 1) or row-major words (mode 2).
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + static_cast<size_t>(d) * LDA;
  unsigned int* Aw = reinterpret_cast<unsigned int*>(smem_raw);
  unsigned int* Bw = Aw + TN * (d + 1);

  if constexpr (MODE == 2) {
    const unsigned int* a = static_cast<const unsigned int*>(a_all) + a_off;
    for (int e = tid; e < TN * d; e += THREADS) {
      const int r = e / d, k = e - r * d;
      const int gr = row0 + r;
      Aw[r * (d + 1) + k] = gr < n ? a[static_cast<size_t>(gr) * d + k] : 0u;
    }
  } else {
    for (int e = tid; e < TN * d; e += THREADS) {
      const int r = e / d, k = e - r * d;
      const int gr = row0 + r;
      As[k * LDA + r] = gr < n ? load_operand<MODE>(a_all, a_off + static_cast<size_t>(gr) * d + k)
                               : 0.f;
    }
  }

  float a2r[4], v1[4], v2[4];
  int i1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    a2r[i] = gr < n ? a2m[gr] : BIG;
    v1[i] = __int_as_float(0x7f800000);  // +inf: no bank row seen yet
    v2[i] = BIG;
    i1[i] = NO_INDEX;
  }

  for (int c0 = 0; c0 < m; c0 += TM) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

    if constexpr (MODE == 2) {
      const unsigned int* b = static_cast<const unsigned int*>(b_all) + b_off;
      __syncthreads();
      for (int e = tid; e < TM * d; e += THREADS) {
        const int c = e / d, k = e - c * d;
        const int gc = c0 + c;
        Bw[c * (d + 1) + k] = gc < m ? b[static_cast<size_t>(gc) * d + k] : 0u;
      }
      __syncthreads();
      int h[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) h[i][q] = 0;
      for (int k = 0; k < d; ++k) {
        unsigned int aw[4], bw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) aw[i] = Aw[(ty * 4 + i) * (d + 1) + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) bw[q] = Bw[(tx * 4 + q) * (d + 1) + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) h[i][q] += __popc(aw[i] ^ bw[q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = static_cast<float>(4 * h[i][q] - 2 * n_bits);
    } else {
      for (int k0 = 0; k0 < d; k0 += KC) {
        __syncthreads();
        for (int e = tid; e < TM * KC; e += THREADS) {
          const int c = e / KC, k = e - c * KC;
          const int gc = c0 + c;
          Bs[k * LDB + c] = gc < m
              ? load_operand<MODE>(b_all, b_off + static_cast<size_t>(gc) * d + k0 + k)
              : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < KC; ++k) {
          const float4 av = *reinterpret_cast<const float4*>(As + (k0 + k) * LDA + ty * 4);
          const float4 bv = *reinterpret_cast<const float4*>(Bs + k * LDB + tx * 4);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(ar[i], bc[q], acc[i][q]);
        }
      }
    }

    // Row top-2 over this thread's bank rows, in increasing index order.
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gc = c0 + tx * 4 + q;
      if (gc < m) {
        const float bm = b2m[gc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = acc[i][q] + bm;
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

    if (cross_check) {
      // Per bank row: the best of this thread's 4 queries (lowest first),
      // then of the block's 16 query groups, then one atomic per row.
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gc = c0 + tx * 4 + q;
        const float bm = gc < m ? b2m[gc] : 0.f;
        float best = __int_as_float(0x7f800000);
        int brow = NO_INDEX;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gr = row0 + ty * 4 + i;
          // exact: neg2 + a2m; fast/binary: (neg2 + b2m) + a2m, in that order
          const float sc = MODE == 0 ? acc[i][q] + a2r[i] : (acc[i][q] + bm) + a2r[i];
          if (gr < n && sc < best) {
            best = sc;
            brow = gr;
          }
        }
        cv[ty][tx * 4 + q] = best;
        ci[ty][tx * 4 + q] = brow;
      }
      __syncthreads();
      if (tid < TM) {
        const int gc = c0 + tid;
        if (gc < m) {
          float best = cv[0][tid];
          int brow = ci[0][tid];
          for (int g = 1; g < 16; ++g) {
            if (cv[g][tid] < best) {
              best = cv[g][tid];
              brow = ci[g][tid];
            }
          }
          if (brow != NO_INDEX) {
            const unsigned long long key =
                (static_cast<unsigned long long>(order_bits(best)) << 32) |
                (MODE == 0 ? static_cast<unsigned int>(brow) : 0u);
            atomicMin(col_key + gc, key);
          }
        }
      }
      // cv/ci are rewritten only after the next tile's __syncthreads.
    }
  }

  // Merge the 16 bank-row lanes of each query (one half-warp).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov1 = __shfl_xor_sync(0xffffffffu, v1[i], off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, i1[i], off);
      const float ov2 = __shfl_xor_sync(0xffffffffu, v2[i], off);
      merge_top2(v1[i], i1[i], v2[i], ov1, oi1, ov2);
    }
    const int gr = row0 + ty * 4 + i;
    if (tx == 0 && gr < n) {
      const size_t o = static_cast<size_t>(p) * n + gr;
      idx_all[o] = i1[i];
      d1_all[o] = fmaxf(v1[i] + a2r[i], 0.f);
      d2_all[o] = fmaxf(v2[i] + a2r[i], 0.f);
      t1_all[o] = v1[i] + a2r[i];
    }
  }
}

__global__ void batch_match_finalize(const float* __restrict__ a2m_all,
                                     const unsigned long long* __restrict__ col_key_all,
                                     const int* __restrict__ idx_all,
                                     const float* __restrict__ d2_all,
                                     const float* __restrict__ t1_all, int batch, int n,
                                     int m, int value_mutual, int cross_check, float r2,
                                     float* __restrict__ dist_all, bool* __restrict__ valid_all) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<size_t>(batch) * n) return;
  const int p = static_cast<int>(t / n);
  const int q = static_cast<int>(t - static_cast<size_t>(p) * n);
  const float d1 = dist_all[t];
  const float d2 = d2_all[t];
  bool ok = (a2m_all[t] < BIG) && (d1 < r2 * d2) && (d2 < BIG);
  if (cross_check) {
    const int i1 = idx_all[t];
    bool mutual = false;
    if (i1 >= 0 && i1 < m) {
      const unsigned long long key = col_key_all[static_cast<size_t>(p) * m + i1];
      mutual = value_mutual
          ? t1_all[t] <= from_order_bits(static_cast<unsigned int>(key >> 32))
          : static_cast<int>(key & 0xffffffffull) == q;
    }
    ok = ok && mutual;
  }
  dist_all[t] = ok ? d1 : BIG;
  valid_all[t] = ok;
}

template <int MODE>
cudaError_t launch_tiles(const void* a, const void* b, const float* a2m, const float* b2m,
                         int batch, int n, int m, int d, int cross_check, int n_bits,
                         unsigned long long* col_key, int* idx, float* d1, float* d2,
                         float* t1, cudaStream_t s) {
  const size_t smem = MODE == 2
      ? sizeof(unsigned int) * (TN + TM) * (d + 1)
      : sizeof(float) * (static_cast<size_t>(d) * LDA + KC * LDB);
  cudaError_t err = cudaFuncSetAttribute(
      batch_match_tiles<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TN - 1) / TN, batch);
  batch_match_tiles<MODE><<<grid, THREADS, smem, s>>>(a, b, a2m, b2m, n, m, d, cross_check,
                                                      n_bits, col_key, idx, d1, d2, t1);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 exact, 1 fast (a, b bf16), 2 binary (a, b packed words, d words).
// dist receives d1 from the first kernel and the final distance from the
// second; d2 and t1 are (batch, n) scratch, col_key (batch, m) scratch.
extern "C" int fm_batch_match(const void* a, const void* b, const float* a2m,
                              const float* b2m, int batch, int n, int m, int d, int mode,
                              int cross_check, int n_bits, float r2,
                              unsigned long long* col_key, int* idx, float* dist,
                              bool* valid, float* d2, float* t1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cross_check) {
    err = cudaMemsetAsync(col_key, 0xff, sizeof(unsigned long long) * batch * m, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (mode == 0) {
    err = launch_tiles<0>(a, b, a2m, b2m, batch, n, m, d, cross_check, n_bits, col_key, idx,
                          dist, d2, t1, s);
  } else if (mode == 1) {
    err = launch_tiles<1>(a, b, a2m, b2m, batch, n, m, d, cross_check, n_bits, col_key, idx,
                          dist, d2, t1, s);
  } else if (mode == 2) {
    err = launch_tiles<2>(a, b, a2m, b2m, batch, n, m, d, cross_check, n_bits, col_key, idx,
                          dist, d2, t1, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(batch) * n;
  batch_match_finalize<<<static_cast<unsigned int>((total + 255) / 256), 256, 0, s>>>(
      a2m, col_key, idx, d2, t1, batch, n, m, mode != 0, cross_check, r2, dist, valid);
  return static_cast<int>(cudaGetLastError());
}
