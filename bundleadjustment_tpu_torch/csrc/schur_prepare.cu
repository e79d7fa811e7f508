// Schur prepare (kernel D): the per-iteration point-side math of the dense
// LM step, with G written to device memory for an outside Pf / Q Q^T
// product.
//
// Replaces the TPU kernel bundleadjustment_tpu/solvers/pallas_dense_eval.py:
// fused_schur_prepare / _schur_kernel, the reference's route for shapes its
// S kernel does not take (O > 64 on this port).
//
// Per landmark l (one thread), in point_prepare.cuh: the damped V (identity
// for invalid points), closed-form V^-1 -> vinv6 [6][L], lower
// chol(V^-1) = C, zv = V^-1 g_p -> zv [3][L]; then for every slot o:
// G[18][O][L] = W_o C (rows i*3 + m), and the rhs term W_o zv added to
// red6 [6][K] (row i, column cam_o: the (i, k) order of kernel C's rhs).
//
// What bounds it on H100: bytes. It reads W18 once and writes G once,
// 2 * 18 * O * L * 4 B (112 MB at 71 cameras / 10,842 landmarks / O = 72,
// ~33 us at 3.35 TB/s); ~200 flops per slot are far below the float32 rate.
//
// Design: one thread per landmark loops over its O slots, keeping C and zv
// in registers; L is the fastest axis of W18 and G, so a warp reads and
// writes 32 consecutive floats per row. Each block sums its W zv terms into
// a shared-memory [6][K] table with shared atomics and adds the table to
// the zero-initialised global red6 with one atomic per non-zero entry; when
// 6K floats exceed 48 KB (K > 2048) the terms go straight to global atomics.
// Slots whose W is all zero (invalid or fixed-camera observations) add
// nothing to red6 and are skipped there; their G is written (exactly zero).
// Float atomics make red6's summation order vary from run to run; G, zv and
// vinv6 are per-landmark and round as the plain version does
// (--fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

#include "point_prepare.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSmemLimit = 48 * 1024;

__global__ void schur_prepare_kernel(const float* __restrict__ lam_ptr,
                                     const float* __restrict__ Vu,
                                     const float* __restrict__ g_p,
                                     const uint8_t* __restrict__ pt_valid,
                                     const float* __restrict__ W18,
                                     const int* __restrict__ cam_t, int O,
                                     int L, int K, int use_smem,
                                     float* __restrict__ G_out,
                                     float* __restrict__ zv_out,
                                     float* __restrict__ vinv_out,
                                     float* __restrict__ red6) {
  extern __shared__ float sred[];
  if (use_smem)
    for (int e = threadIdx.x; e < 6 * K; e += blockDim.x) sred[e] = 0.f;
  __syncthreads();

  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < L) {
    const PointPrep p = point_prepare(*lam_ptr, Vu, g_p, pt_valid, l, L,
                                      zv_out, vinv_out);
    const long long OL = (long long)O * L;
    float* acc = use_smem ? sred : red6;
    for (int o = 0; o < O; ++o) {
      const long long s = (long long)o * L + l;
      float W[18], G[6][3];
      const bool any = load_w_g(W18, OL, s, p.C, W, G);
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int m = 0; m < 3; ++m) G_out[(i * 3 + m) * OL + s] = G[i][m];
      if (!any) continue;
      const int cam = cam_t[s];
#pragma unroll
      for (int i = 0; i < 6; ++i) atomicAdd(&acc[i * K + cam], w_zv(W, p.zv, i));
    }
  }
  if (use_smem) {
    __syncthreads();
    for (int e = threadIdx.x; e < 6 * K; e += blockDim.x)
      if (sred[e] != 0.f) atomicAdd(&red6[e], sred[e]);
  }
}

}  // namespace

extern "C" int schur_prepare(const void* lam, const void* Vu, const void* g_p,
                             const void* pt_valid, const void* W18,
                             const void* cam_t, int O, int L, int K, void* G,
                             void* zv, void* vinv6, void* red6, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(red6, 0, sizeof(float) * 6LL * K, s);
  if (L > 0) {
    const size_t smem_bytes = (size_t)K * 6 * sizeof(float);
    const int use_smem = smem_bytes <= (size_t)kSmemLimit;
    schur_prepare_kernel<<<(L + kThreads - 1) / kThreads, kThreads,
                           use_smem ? smem_bytes : 0, s>>>(
        (const float*)lam, (const float*)Vu, (const float*)g_p,
        (const uint8_t*)pt_valid, (const float*)W18, (const int*)cam_t, O, L, K,
        use_smem, (float*)G, (float*)zv, (float*)vinv6, (float*)red6);
  }
  return (int)cudaGetLastError();
}
