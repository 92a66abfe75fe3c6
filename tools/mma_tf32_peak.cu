// Throughput of warp-level mma.sync.m16n8k8 in TF32 on one card: each warp
// issues `iters` rounds of 8 independent mmas on register operands, with no
// memory traffic in the loop.  The ceiling that csrc/vq_assign.cu's score
// loop, which issues the same instruction, can reach.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmma_tf32_peak.so mma_tf32_peak.cu
// Run by tools/vq_kernel_ab.py --mma-peak.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 8;

__global__ void mma_tf32_peak_kernel(float* out, int iters) {
  float d[CHAINS][4];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
  const uint32_t v = 0x3f800000u + (threadIdx.x << 13);  // 1.0 and up, TF32-exact
  const uint32_t a0 = v, a1 = v + 0x2000u, a2 = v + 0x4000u, a3 = v + 0x6000u;
  const uint32_t b0 = v, b1 = v + 0x2000u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (s == -1.f) out[0] = s;  // never true: keeps the loop alive
}

}  // namespace

// blocks x threads threads, each warp 8 * iters mmas of 2 * 16 * 8 * 8 FLOP.
// Returns the launch's CUDA error (0 on success); does not synchronise.
extern "C" int mma_tf32_peak_launch(float* out, int blocks, int threads, int iters,
                                    void* stream) {
  mma_tf32_peak_kernel<<<blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(out,
                                                                                        iters);
  return (int)cudaGetLastError();
}

extern "C" int mma_tf32_peak_chains() { return CHAINS; }
