// Schur-S with the folded damped U block (kernel C), and its unfolded
// partial (K5): one landmark loop, launched onto the damped U (C) or onto
// zero (K5).
//
// Replaces the TPU kernel bundleadjustment_tpu/solvers/pallas_dense_eval.py:
// fused_schur_prepare_s / _schur_s_kernel, held to its float32 path
// (s_bf16=False):
// - schur_prepare_s: fold_u=True (red27 and cam_fixed given), the
//   single-device path;
// - schur_qqt_partial: fold_u=False, the per-shard term of the sharded
//   engine, which all-reduces it and adds the replicated U outside.
//
// Per landmark l (one thread), in point_prepare.cuh:
//   V = Vu damped as diag * (1 + lam * clip(diag, 1e-6)), identity for
//   invalid points; closed-form V^-1 -> vinv6; lower chol(V^-1) = C;
//   zv = V^-1 g_p; then for each valid observation slot o: G_o = W_o C
//   (6x3), the rhs term W_o zv added at camera cam_o, and for every pair of
//   its slots (o, o') the 6x6 block G_o G_o'^T added at cameras
//   (cam_o, cam_o'), times `sign`.
// Both outputs are in (i, k) row order (row i*K + k).
// Kernel C (sign -1) outputs S = U_damped_embed + 1e-8 I - Q Q^T and
// b = -(g_c - sum W zv), with U's fixed-camera blocks and g_c's
// fixed-camera rows replaced by identity / zero, as the reference emits
// them: a first launch (schur_s_init) writes the damped U embed + 1e-8 I
// into every entry of S and -g_c into b.
// K5 (sign +1) outputs S_qqt = +Q Q^T and red6 [6][K] = sum W zv from zero
// (memset). The reference returns K5's terms in (k, i) order; the order is
// internal to the solve, which here folds U in (i, k) order for every route
// (dense_kernels.damped_system). The QQ^T product is computed here, in the
// kernel body, as in the reference; no library GEMM.
//
// What bounds it on H100: the atomic traffic into S. Each landmark with n
// valid slots adds 36 n^2 entries (n(n+1)/2 pair blocks, mirrored); at
// 100k landmarks x ~6 slots that is ~1e8 float atomics into a 6K x 6K
// matrix (2.4 MB at K = 128, resident in the 50 MB L2). The arithmetic
// (~110 flops per pair block) is small beside it. By bytes alone (W18 read
// once, S written once) the bound at 128c/100k/O=8 is ~20 us.
//
// Design: one thread per landmark keeps V^-1, C and zv in registers,
// recomputes G_o' from W for the inner slot instead of holding O x 18
// values (any O works, no size gate), visits only pairs o <= o' and mirrors
// the off-diagonal blocks, and skips slots whose W is all zero (invalid or
// fixed-camera observations, which add exactly zero). Atomic order varies
// from run to run, so S and the rhs agree with a sequential sum to float32
// rounding of the order. The damped U and lam are read on the device: no
// host sync.

#include <cstdint>
#include <cuda_runtime.h>

#include "point_prepare.cuh"

namespace {

constexpr int kThreads = 128;

__constant__ int kSym6[6][6] = {{0, 1, 2, 3, 4, 5},     {1, 6, 7, 8, 9, 10},
                                {2, 7, 11, 12, 13, 14}, {3, 8, 12, 15, 16, 17},
                                {4, 9, 13, 16, 18, 19}, {5, 10, 14, 17, 19, 20}};

__global__ void schur_s_init(const float* __restrict__ lam_ptr,
                             const float* __restrict__ red27,
                             const uint8_t* __restrict__ cam_fixed, int K,
                             float* __restrict__ S) {
  const float lam = *lam_ptr;
  const long long n6 = 6LL * K;
  const long long total = n6 * n6;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / n6, col = e % n6;
    const int i = (int)(row / K), k = (int)(row % K);
    const int ip = (int)(col / K), kp = (int)(col % K);
    float v = 0.f;
    if (k == kp) {
      if (cam_fixed[k]) {
        v = i == ip ? 1.f : 0.f;
      } else {
        v = red27[k * 27 + kSym6[i][ip]];
        if (i == ip) v = v + lam * fmaxf(v, 1e-6f);
      }
    }
    if (row == col) v += 1e-8f;
    S[e] = v;
  }
}

__global__ void rhs_init(const float* __restrict__ red27,
                         const uint8_t* __restrict__ cam_fixed, int K,
                         float* __restrict__ b) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 6 * K) return;
  const int i = e / K, k = e % K;
  b[e] = cam_fixed[k] ? 0.f : -red27[k * 27 + 21 + i];
}

// Landmark terms, one thread per landmark: S += sign * G G'^T and
// rhs += W zv, both in (i, k) row order, onto what the caller put there.
__global__ void schur_s_accum(const float* __restrict__ lam_ptr,
                              const float* __restrict__ Vu,
                              const float* __restrict__ g_p,
                              const uint8_t* __restrict__ pt_valid,
                              const float* __restrict__ W18,
                              const int* __restrict__ cam_t, int O, int L, int K,
                              float sign, float* __restrict__ S,
                              float* __restrict__ rhs,
                              float* __restrict__ zv_out,
                              float* __restrict__ vinv_out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const PointPrep p = point_prepare(*lam_ptr, Vu, g_p, pt_valid, l, L, zv_out,
                                    vinv_out);
  const long long OL = (long long)O * L;
  const long long n6 = 6LL * K;
  for (int o = 0; o < O; ++o) {
    const long long s = (long long)o * L + l;
    float W[18], G[6][3];
    if (!load_w_g(W18, OL, s, p.C, W, G)) continue;
    const int cam = cam_t[s];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      atomicAdd(&rhs[(long long)i * K + cam], w_zv(W, p.zv, i));
    for (int o2 = o; o2 < O; ++o2) {
      const long long s2 = (long long)o2 * L + l;
      float W2[18], G2[6][3];
      if (!load_w_g(W18, OL, s2, p.C, W2, G2)) continue;
      const int cam2 = cam_t[s2];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const long long r = (long long)i * K + cam;
#pragma unroll
        for (int i2 = 0; i2 < 6; ++i2) {
          const long long r2 = (long long)i2 * K + cam2;
          const float q = G[i][0] * G2[i2][0] + G[i][1] * G2[i2][1] + G[i][2] * G2[i2][2];
          atomicAdd(&S[r * n6 + r2], sign * q);
          if (o2 != o) atomicAdd(&S[r2 * n6 + r], sign * q);
        }
      }
    }
  }
}

}  // namespace

extern "C" int schur_prepare_s(const void* lam, const void* red27,
                               const void* cam_fixed, const void* Vu,
                               const void* g_p, const void* pt_valid,
                               const void* W18, const void* cam_t, int O, int L,
                               int K, void* S, void* b, void* zv, void* vinv6,
                               void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = 36LL * K * K;
  const int init_blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  schur_s_init<<<init_blocks, 256, 0, s>>>((const float*)lam, (const float*)red27,
                                          (const uint8_t*)cam_fixed, K, (float*)S);
  rhs_init<<<(6 * K + 255) / 256, 256, 0, s>>>((const float*)red27,
                                               (const uint8_t*)cam_fixed, K,
                                               (float*)b);
  if (L > 0) {
    schur_s_accum<<<(L + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const float*)lam, (const float*)Vu, (const float*)g_p,
        (const uint8_t*)pt_valid, (const float*)W18, (const int*)cam_t, O, L, K,
        -1.f, (float*)S, (float*)b, (float*)zv, (float*)vinv6);
  }
  return (int)cudaGetLastError();
}

extern "C" int schur_qqt_partial(const void* lam, const void* Vu, const void* g_p,
                                 const void* pt_valid, const void* W18,
                                 const void* cam_t, int O, int L, int K, void* S,
                                 void* red6, void* zv, void* vinv6, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(S, 0, sizeof(float) * 36LL * K * K, s);
  cudaMemsetAsync(red6, 0, sizeof(float) * 6LL * K, s);
  if (L > 0) {
    schur_s_accum<<<(L + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const float*)lam, (const float*)Vu, (const float*)g_p,
        (const uint8_t*)pt_valid, (const float*)W18, (const int*)cam_t, O, L, K,
        1.f, (float*)S, (float*)red6, (float*)zv, (float*)vinv6);
  }
  return (int)cudaGetLastError();
}
