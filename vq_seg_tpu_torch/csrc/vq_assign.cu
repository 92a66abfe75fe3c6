// Fused VQ codebook assignment for Hopper (sm_90a), on the tensor cores.
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
// What bounds it on the H100: tensor-core operations.  The product x.E^T is
// 2*N*K*C operations, done as three TF32 products (below) at 495 TFLOP/s
// dense; the bytes are only N*C*4 + K*C*4 in and N*4 + K*4 out, so at the
// flagship shapes the arithmetic intensity is about K/2 = 256 FLOP per byte,
// far above the ridge.  The warp-level mma.sync used here reaches about
// 320 TFLOP/s in TF32 on an H100 SXM at 700 W even from registers alone
// (tools/vq_kernel_ab.py --mma-peak), about 107 TFLOP/s of f32 product in
// 3xTF32; only the warpgroup wgmma reaches the 495.
//
// Precision: 3xTF32, CUTLASS's "big + small" split.  Each f32 operand v is
// split into hi = rna_tf32(v) and lo = rna_tf32(v - hi) (round to nearest,
// ties away, to 10 mantissa bits; v - hi is exact in f32).  Then
// |v - hi| <= 2^-11 |v|, |lo| <= (2^-11 + 2^-22) |v| and
// |v - hi - lo| <= 2^-11 |v - hi| <= 2^-22 |v|.  The kernel sums
// lo_x*hi_e + hi_x*lo_e + hi_x*hi_e; it drops lo_x*lo_e and the two split
// residues, so for one term
//   |x*e - (lo_x*hi_e + hi_x*lo_e + hi_x*hi_e)| <= 3.01 * 2^-22 |x*e| < 2^-20 |x*e|.
// Each TF32 product (11 x 11 significant bits) is exact in f32, and the
// three terms' magnitudes sum to at most (1 + 2^-8) |x*e|.  The tensor core
// adds 8 products at a time into the f32 accumulator; taking each such mma
// as one f32 rounding of at most 2^-23 of the running sum of magnitudes
// (truncation at worst), the 3*ceil(C/8) mmas of one score give
//   |dot_3xTF32 - x.e| <= (2^-20 + 3*ceil(C/8) * 2^-23 * (1 + 2^-8)) * sum_i |x_i e_i|,
// about (0.75*C + 16) f32 unit roundoffs (2^-24): the same order as the f32
// FMA dot product's C*2^-24 worst case, and far from TF32's own 2^-11.
// tests/test_torch_vq.py holds a numpy emulation of the split and of this
// sum against the f64 product.
//
// What this design does about the bound: it runs the product on the tensor
// cores with mma.sync.m16n8k8 in TF32 and keeps the (N, K) score matrix out
// of device memory.  A block owns a tile of BM rows and walks a range of the
// codebook in tiles of BN codes, C in BK-wide chunks.  The (code tile, C
// chunk) steps form one sequence that a ring of STAGES shared-memory buffers
// streams through: cp.async copies global -> shared without registers (16
// bytes a copy where C is a multiple of 4 and the bases are 16-byte aligned,
// 4 bytes otherwise; rows and columns outside the matrix are zero-filled
// through the copy's source size), STAGES - 1 steps ahead of the mma, with
// one __syncthreads a step.  Shared rows are padded to BK + 4 floats so that
// the fragment reads of a warp hit 32 distinct banks.  Each warp owns a
// WM x WN piece of the tile; it splits its fragments into hi and lo as it
// reads them and issues lo*hi, hi*lo, then hi*hi into one f32 accumulator.
// (Splitting once per block when a tile lands, into a buffer in fragment
// order, was measured slower: it doubles the shared-memory reads and
// serialises the split with the mma.)
// Every code's score comes from the same sequence of the same products over
// C, whatever block, warp or lane holds it, so exactly duplicated codes
// score exactly equal.  Scores are folded into a running best per row as one
// 64-bit key: the order-preserving bits of the score above the code index,
// so that the smaller key is the lower score and, on an equal score, the
// lower index.  The four lanes of a quad that share rows take the minimum
// with shuffles, the warps that share rows meet in shared memory, and each
// block issues one 64-bit atomicMin per row.  Large-N calls take 128 x 128
// tiles on 8 warps, the deep, small-N stages 64 x 64 tiles on 4 warps, and
// the codebook is split over blockIdx.y into as many equal ranges as fill
// the last wave of resident blocks best; atomicMin on the key is
// order-free, so the split changes no result.  A second small
// kernel unpacks idx and counts it in a per-block shared-memory histogram
// flushed with int32 atomics, so the counts are deterministic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libvq_assign.so vq_assign.cu
// Bound with ctypes by vq_seg_tpu_torch/ops/vq_cuda.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;          // C chunk staged through shared memory
constexpr int LDS = BK + 4;     // shared row stride: g*LDS + t covers 32 banks
constexpr int FINISH_THREADS = 256;
constexpr int MAX_SMEM_HIST_BYTES = 48 * 1024;
constexpr unsigned long long NO_KEY = ~0ull;

// float -> uint32 with the same order (non-NaN); -0 and +0 map together
__device__ __forceinline__ uint32_t ordered_bits(float s) {
  if (s == 0.f) s = 0.f;
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// cvt.rna.tf32.f32 for finite v, in two integer operations: add half of
// TF32's last place to the magnitude bits (ties go away from zero), then
// clear the 13 bits that TF32 drops
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + r with |r| <= 2^-22 |v|
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a b on the tensor cores: a 16x8 (row), b 8x8 (col), d 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) x columns [k0, k0 + BK) of m (row length c) into the
// shared tile s (row stride LDS), zero outside rows [0, r_end) and columns
// [0, c).  With vec16, c is a multiple of 4, so a 16-byte chunk lies wholly
// inside or wholly outside the columns.
template <int ROWS, int THREADS>
__device__ __forceinline__ void copy_tile(float* s, const float* __restrict__ m, int r0,
                                          int r_end, int c, int k0, bool vec16, int tid) {
  if (vec16) {
    constexpr int CHUNKS = ROWS * BK / 4;
    static_assert(CHUNKS % THREADS == 0, "whole 16-byte chunks a thread");
#pragma unroll
    for (int i = 0; i < CHUNKS / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BK / 4), col = 4 * (e % (BK / 4));
      const bool in = r0 + r < r_end && k0 + col < c;
      cp_async16(s + r * LDS + col, in ? m + (size_t)(r0 + r) * c + k0 + col : m, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < ROWS * BK; e += THREADS) {
      const int r = e / BK, col = e % BK;
      const bool in = r0 + r < r_end && k0 + col < c;
      cp_async4(s + r * LDS + col, in ? m + (size_t)(r0 + r) * c + k0 + col : m, in ? 4 : 0);
    }
  }
}

template <int BM, int BN, int STAGES>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)STAGES * (BM + BN) * LDS * sizeof(float);
}

// Fragment layout of m16n8k8 (PTX ISA), lane = 4g + t:
//   a: (row g, k t), (g+8, t), (g, t+4), (g+8, t+4)
//   b: (k t, code g), (k t+4, code g)
//   d: (row g, code 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
template <bool kCosine, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
vq_mma_kernel(const float* __restrict__ x, const float* __restrict__ cb,
              const float* __restrict__ cb_sq, int n, int c, int k, int codes_per_split,
              bool vec16, unsigned long long* __restrict__ best) {
  constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MI = WM / 16;
  constexpr int NI = WN / 8;
  constexpr int STAGE_FLOATS = (BM + BN) * LDS;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "whole mma tiles a warp");
  static_assert(WARPS_N * BM * sizeof(unsigned long long) <= smem_bytes<BM, BN, STAGES>(),
                "the row minima reuse the ring");
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int code_begin = blockIdx.y * codes_per_split;
  const int code_end = min(k, code_begin + codes_per_split);
  const int steps = (code_end - code_begin + BN - 1) / BN * ((c + BK - 1) / BK);

  // a step is one (code tile, C chunk); the loads run STAGES - 1 steps ahead
  int ld_n0 = code_begin, ld_k0 = 0, ld_slot = 0;
  auto load_next = [&]() {
    float* xs = smem + ld_slot * STAGE_FLOATS;
    copy_tile<BM, THREADS>(xs, x, row0, n, c, ld_k0, vec16, tid);
    copy_tile<BN, THREADS>(xs + BM * LDS, cb, ld_n0, code_end, c, ld_k0, vec16, tid);
    ld_slot = ld_slot + 1 == STAGES ? 0 : ld_slot + 1;
    ld_k0 += BK;
    if (ld_k0 >= c) {
      ld_k0 = 0;
      ld_n0 += BN;
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) load_next();
    cp_async_commit();  // an empty group keeps the count of groups in step
  }

  unsigned long long key[MI][2];
  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    key[mi][0] = key[mi][1] = NO_KEY;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
  }

  int n0 = code_begin, k0 = 0, slot = 0;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES - 2>();  // step i has landed for this thread ...
    __syncthreads();              // ... and for all; the slot of step i - 1 is free
    if (i + STAGES - 1 < steps) load_next();
    cp_async_commit();
    const float* xs = smem + slot * STAGE_FLOATS;
    const float* es = xs + BM * LDS;
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    const int g = lane >> 2;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float* p = es + (wn * WN + ni * 8 + g) * LDS + kk + t;
        split_tf32(p[0], bh[ni][0], bl[ni][0]);
        split_tf32(p[4], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t ah[4], al[4];
        const float* p = xs + (wm * WM + mi * 16 + g) * LDS + kk + t;
        split_tf32(p[0], ah[0], al[0]);
        split_tf32(p[8 * LDS], ah[1], al[1]);
        split_tf32(p[4], ah[2], al[2]);
        split_tf32(p[8 * LDS + 4], ah[3], al[3]);
        // small terms first, then big*big (CUTLASS's OpMultiplyAddFastF32 order)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], al, bh[ni]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah, bl[ni]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah, bh[ni]);
      }
    }

    k0 += BK;
    if (k0 >= c) {
      // the code tile is done: fold it into the running keys
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int code = n0 + wn * WN + ni * 8 + 2 * t + j;
          const float sq = (kCosine || code >= code_end) ? 0.f : cb_sq[code];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float a = acc[mi][ni][2 * h + j];
              acc[mi][ni][2 * h + j] = 0.f;
              const float s = kCosine ? -a : sq - 2.f * a;
              const unsigned long long kv =
                  ((unsigned long long)ordered_bits(s) << 32) | (unsigned)code;
              if (code < code_end && kv < key[mi][h]) key[mi][h] = kv;
            }
        }
      k0 = 0;
      n0 += BN;
    }
  }

  // the four lanes of a quad hold disjoint codes of the same rows
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, key[mi][h], off);
        if (o < key[mi][h]) key[mi][h] = o;
      }
  // the WARPS_N warps of one row band hold disjoint codes of the same rows;
  // they meet in the ring, which no copy writes any more
  cp_async_wait<0>();
  __syncthreads();
  auto* red = reinterpret_cast<unsigned long long*>(smem);  // [WARPS_N][BM]
  if (t == 0) {
    const int g = lane >> 2;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) red[wn * BM + wm * WM + mi * 16 + 8 * h + g] = key[mi][h];
  }
  __syncthreads();
  for (int r = tid; r < BM; r += THREADS) {
    unsigned long long kv = red[r];
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w) kv = min(kv, red[w * BM + r]);
    // rows of the ragged last tile write nothing
    if (row0 + r < n && kv != NO_KEY) atomicMin(&best[row0 + r], kv);
  }
}

__global__ void __launch_bounds__(FINISH_THREADS)
vq_finish_kernel(const unsigned long long* __restrict__ best, int n, int k,
                 int* __restrict__ idx, int* __restrict__ counts, bool smem_hist) {
  extern __shared__ int hist[];
  if (smem_hist) {
    for (int i = threadIdx.x; i < k; i += FINISH_THREADS) hist[i] = 0;
    __syncthreads();
  }
  for (int row = blockIdx.x * FINISH_THREADS + threadIdx.x; row < n;
       row += gridDim.x * FINISH_THREADS) {
    const int code = (int)(best[row] & 0xffffffffull);
    idx[row] = code;
    atomicAdd(smem_hist ? &hist[code] : &counts[code], 1);
  }
  if (smem_hist) {
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += FINISH_THREADS) {
      if (hist[i] != 0) atomicAdd(&counts[i], hist[i]);
    }
  }
}

template <bool kCosine, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
cudaError_t launch_tiles(const float* x, const float* cb, const float* cb_sq, int n, int c,
                         int k, int sms, bool vec16, unsigned long long* best, cudaStream_t s) {
  auto* kernel = vq_mma_kernel<kCosine, BM, BN, WARPS_M, WARPS_N, STAGES>;
  constexpr int threads = 32 * WARPS_M * WARPS_N;
  constexpr size_t bytes = smem_bytes<BM, BN, STAGES>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int row_tiles = (n + BM - 1) / BM;
  const int code_tiles = (k + BN - 1) / BN;
  // Split the codebook over blockIdx.y into equal ranges of whole tiles: the
  // split whose blocks fill the last wave of resident blocks best, the
  // fewest splits on a tie
  int splits = 1;
  double best_fill = 0.0;
  for (int sp = 1; sp <= code_tiles; ++sp) {
    if (code_tiles % sp != 0) continue;
    const long long blocks = (long long)row_tiles * sp;
    const double fill = (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
    if (fill > best_fill + 1e-9) {
      best_fill = fill;
      splits = sp;
    }
  }
  const dim3 grid((unsigned)row_tiles, (unsigned)splits);
  kernel<<<grid, threads, bytes, s>>>(x, cb, cb_sq, n, c, k, code_tiles / splits * BN, vec16,
                                      best);
  return cudaGetLastError();
}

template <bool kCosine>
cudaError_t launch_score(const float* x, const float* cb, const float* cb_sq, int n, int c,
                         int k, unsigned long long* best, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool vec16 = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  // 128 x 128 tiles where they give every SM two blocks; 64 x 64 below that
  const long long big_blocks = (long long)((n + 127) / 128) * ((k + 127) / 128);
  if (big_blocks >= 2 * sms)
    return launch_tiles<kCosine, 128, 128, 2, 4, 3>(x, cb, cb_sq, n, c, k, sms, vec16, best, s);
  return launch_tiles<kCosine, 64, 64, 2, 2, 3>(x, cb, cb_sq, n, c, k, sms, vec16, best, s);
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
  const int blocks = (n + 8 * FINISH_THREADS - 1) / (8 * FINISH_THREADS);
  vq_finish_kernel<<<blocks, FINISH_THREADS, smem_hist ? hist_bytes : 0, s>>>(
      keys, n, k, idx, counts, smem_hist);
  return (int)cudaGetLastError();
}
