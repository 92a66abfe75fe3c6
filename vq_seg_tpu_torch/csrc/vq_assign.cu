// Fused VQ codebook assignment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vq_seg_tpu/ops/vq_pallas.py::_kernel (driven
// by _vq_assign_pallas_impl).  For every row of x (N, C) it finds the code of
// the codebook E (K, C) with the lowest score and counts how often each code
// was chosen:
//   euclidean: score = ||e||^2 - 2 x.e        (argmin; ||x||^2 is row-constant)
//   cosine:    score = -(x.e)                 (argmax of x.e on normalised rows)
// Ties resolve to the lowest code index, as torch.argmin / jnp.argmin do:
// k-means codebooks hold exactly duplicated rows.
//
// What bounds it on the H100: f32 FMA.  The work is 2*N*K*C operations on the
// non-tensor f32 pipes (67 TFLOP/s on the SXM part), while the bytes are only
// N*C*4 + K*C*4 in and N*4 + K*4 out; at the flagship shapes the arithmetic
// intensity is about K/2 = 256 FLOP per byte, far above the f32 ridge.  The
// scores are plain f32 FMA and never TF32 or bf16 tensor-core products, so
// the chosen index matches the f32 plain version except on proven near-ties.
//
// What this design does about it: it keeps the (N, K) score matrix out of
// device memory and feeds the FMA pipes from registers.  A block owns a tile
// of 16*TM rows and walks a range of the codebook in tiles of 16*TN codes; C
// is staged through shared memory in BK-wide chunks and each of its 256
// threads accumulates a TM x TN register micro-tile, read from shared memory
// as float4.  The next chunk's global loads are issued into registers before
// the current chunk is multiplied, so their latency hides behind the FMAs.
// Each thread keeps a running best (score, code) per row with a
// strict '<' (its codes arrive in increasing order), packed into one 64-bit
// key: the order-preserving bits of the score above the code index, so that
// the smaller key is the lower score and, on an equal score, the lower index.
// The 16 threads that share rows take the minimum key with warp shuffles.
// Where the rows alone give too few blocks to fill the card (the deep,
// small-N stages), the codebook is split over blockIdx.y and the blocks of
// one row tile meet through a 64-bit atomicMin on the key, which is
// order-free.  A second small kernel unpacks idx and counts it in a per-block
// shared-memory histogram flushed with int32 atomics, so the counts are
// deterministic.  A tensor-core design (3xTF32 or wgmma with an exact
// rescoring of near-ties) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libvq_assign.so vq_assign.cu
// Bound with ctypes by vq_seg_tpu_torch/ops/vq_cuda.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of (ty, tx)
constexpr int BK = 16;        // C chunk staged through shared memory
// +4 floats per shared row keep float4 reads aligned and spread the
// transposed stores over the banks (two-way at worst)
constexpr int PAD = 4;
constexpr int MAX_SMEM_HIST_BYTES = 48 * 1024;
constexpr unsigned long long NO_KEY = ~0ull;

// float -> uint32 with the same order (non-NaN); -0 and +0 map together
__device__ __forceinline__ uint32_t ordered_bits(float s) {
  if (s == 0.f) s = 0.f;
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Chunk [k0, k0 + BK) of rows [r0, r0 + L*THREADS/BK) of m (row length c)
// into registers, L values a thread, zero outside rows [0, r_end) and
// columns [0, c).  Consecutive threads read consecutive columns of one row.
template <int L>
__device__ __forceinline__ void load_chunk(float (&v)[L], const float* __restrict__ m,
                                           int r0, int r_end, int c, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int e = tid + i * THREADS, r = r0 + e / BK, col = k0 + e % BK;
    v[i] = (r < r_end && col < c) ? m[(size_t)r * c + col] : 0.f;
  }
}

// The registers of load_chunk into a shared tile, transposed to [BK][rows].
template <int L, int W>
__device__ __forceinline__ void store_chunk(float (*s)[W], const float (&v)[L], int tid) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int e = tid + i * THREADS;
    s[e % BK][e / BK] = v[i];
  }
}

// Thread (ty, tx) holds rows ty*4 + 64*(i/4) + i%4 and codes
// tx*4 + 64*(j/4) + j%4 of the tile: every shared read is one float4, and a
// thread's codes increase with j.
template <bool kCosine, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
vq_score_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                const float* __restrict__ cb_sq, int n, int c, int k,
                int codes_per_split, unsigned long long* __restrict__ best) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 micro-tiles");
  static_assert(BM * BK % THREADS == 0 && BN * BK % THREADS == 0, "whole chunks a thread");
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float es[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * BM;
  const int code_begin = blockIdx.y * codes_per_split;
  const int code_end = min(k, code_begin + codes_per_split);

  unsigned long long key[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) key[i] = NO_KEY;

  for (int n0 = code_begin; n0 < code_end; n0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    float xr[BM * BK / THREADS], er[BN * BK / THREADS];
    load_chunk(xr, x, row0, n, c, 0, tid);
    load_chunk(er, cb, n0, code_end, c, 0, tid);
    for (int k0 = 0; k0 < c; k0 += BK) {
      store_chunk(xs, xr, tid);
      store_chunk(es, er, tid);
      __syncthreads();
      if (k0 + BK < c) {  // in flight while this chunk is multiplied
        load_chunk(xr, x, row0, n, c, k0 + BK, tid);
        load_chunk(er, cb, n0, code_end, c, k0 + BK, tid);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&xs[kk][ty * 4 + 16 * i]);
          a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&es[kk][tx * 4 + 16 * j]);
          b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int code = n0 + tx * 4 + 16 * (j & ~3) + (j & 3);
      if (code < code_end) {
        const float sq = kCosine ? 0.f : cb_sq[code];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = kCosine ? -acc[i][j] : sq - 2.f * acc[i][j];
          const unsigned long long kv =
              ((unsigned long long)ordered_bits(s) << 32) | (unsigned)code;
          if (kv < key[i]) key[i] = kv;
        }
      }
    }
  }

  // the 16 lanes with one ty hold disjoint codes of the same rows
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, key[i], off);
      if (o < key[i]) key[i] = o;
    }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty * 4 + 16 * (i & ~3) + (i & 3);
      // rows of the ragged last tile write nothing
      if (row < n && key[i] != NO_KEY) atomicMin(&best[row], key[i]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
vq_finish_kernel(const unsigned long long* __restrict__ best, int n, int k,
                 int* __restrict__ idx, int* __restrict__ counts, bool smem_hist) {
  extern __shared__ int hist[];
  if (smem_hist) {
    for (int i = threadIdx.x; i < k; i += THREADS) hist[i] = 0;
    __syncthreads();
  }
  for (int row = blockIdx.x * THREADS + threadIdx.x; row < n; row += gridDim.x * THREADS) {
    const int code = (int)(best[row] & 0xffffffffull);
    idx[row] = code;
    atomicAdd(smem_hist ? &hist[code] : &counts[code], 1);
  }
  if (smem_hist) {
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += THREADS) {
      if (hist[i] != 0) atomicAdd(&counts[i], hist[i]);
    }
  }
}

template <bool kCosine, int T>
cudaError_t launch_tiles(const float* x, const float* cb, const float* cb_sq, int n, int c,
                         int k, int sms, unsigned long long* best, cudaStream_t s) {
  constexpr int B = 16 * T;  // rows and codes per tile
  const int row_tiles = (n + B - 1) / B;
  const int code_tiles = (k + B - 1) / B;
  // split the codebook until there are two blocks per SM, or one tile each
  const int want = (2 * sms + row_tiles - 1) / row_tiles;
  const int tiles_per_split = (code_tiles + want - 1) / want;
  const int splits = (code_tiles + tiles_per_split - 1) / tiles_per_split;
  const dim3 grid((unsigned)row_tiles, (unsigned)splits);
  vq_score_kernel<kCosine, T, T><<<grid, THREADS, 0, s>>>(x, cb, cb_sq, n, c, k,
                                                          tiles_per_split * B, best);
  return cudaGetLastError();
}

template <bool kCosine>
cudaError_t launch_score(const float* x, const float* cb, const float* cb_sq, int n, int c,
                         int k, unsigned long long* best, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // 128 x 128 tiles where they give every SM a block; 64 x 64 below that
  const long long big_blocks = (long long)((n + 127) / 128) * ((k + 127) / 128);
  if (big_blocks >= sms) return launch_tiles<kCosine, 8>(x, cb, cb_sq, n, c, k, sms, best, s);
  return launch_tiles<kCosine, 4>(x, cb, cb_sq, n, c, k, sms, best, s);
}

}  // namespace

// x (n, c), cb (k, c), cb_sq (k) f32 contiguous (cb_sq unused and may be
// null for cosine); best (n) 64-bit scratch; idx (n) int32; counts (k)
// int32, zeroed by the caller.  Launches on `stream`, does not synchronise,
// and returns the first CUDA error of the launches (0 on success).
extern "C" int vq_assign_launch(const float* x, const float* cb, const float* cb_sq,
                                int n, int c, int k, int cosine, void* best, int* idx,
                                int* counts, void* stream) {
  if (n <= 0 || c <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* keys = static_cast<unsigned long long*>(best);
  cudaError_t err = cudaMemsetAsync(keys, 0xff, (size_t)n * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  err = cosine ? launch_score<true>(x, cb, cb_sq, n, c, k, keys, s)
               : launch_score<false>(x, cb, cb_sq, n, c, k, keys, s);
  if (err != cudaSuccess) return (int)err;
  const size_t hist_bytes = (size_t)k * sizeof(int);
  const bool smem_hist = hist_bytes <= (size_t)MAX_SMEM_HIST_BYTES;
  // about 8 rows a thread: few blocks, so few histogram flushes
  const int blocks = (n + 8 * THREADS - 1) / (8 * THREADS);
  vq_finish_kernel<<<blocks, THREADS, smem_hist ? hist_bytes : 0, s>>>(keys, n, k, idx, counts,
                                                                       smem_hist);
  return (int)cudaGetLastError();
}
