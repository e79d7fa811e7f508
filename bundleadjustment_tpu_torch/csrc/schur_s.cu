// Schur-S with the folded damped U block (kernel C).
//
// Replaces the TPU kernel bundleadjustment_tpu/solvers/pallas_dense_eval.py:
// fused_schur_prepare_s(..., red27=..., cam_fixed=...) / _schur_s_kernel with
// fold_u=True, held to its float32 path (s_bf16=False).
//
// Per landmark l (one thread):
//   V = Vu damped as diag * (1 + lam * clip(diag, 1e-6)), identity for
//   invalid points; closed-form V^-1 -> vinv6; lower chol(V^-1) = C;
//   zv = V^-1 g_p; for each valid observation slot o: G_o = W_o C (6x3),
//   the rhs term W_o zv added to b at camera cam_o, and for every pair of
//   its slots (o, o') the 6x6 block -G_o G_o'^T added to S at cameras
//   (cam_o, cam_o').
// Output S = U_damped_embed + 1e-8 I - Q Q^T and b = -(g_c - sum W zv), both
// in (i, k) row order (row i*K + k), with U's fixed-camera blocks and g_c's
// fixed-camera rows replaced by identity / zero, as the reference emits them.
//
// A first launch (schur_s_init) writes the damped U embed + 1e-8 I into
// every entry of S and -g_c into b; the main launch (schur_s_accum) then
// accumulates the landmark terms with float atomics. The QQ^T product is
// computed here, in the kernel body, as in the reference; no library GEMM.
//
// What bounds it on H100: the atomic traffic into S. Each landmark with n
// valid slots adds 36 n^2 entries (n(n+1)/2 pair blocks, mirrored); at
// 100k landmarks x ~6 slots that is ~1e8 float atomics into a 6K x 6K
// matrix (2.4 MB at K = 128, resident in the 50 MB L2). The arithmetic
// (~110 flops per pair block) is small beside it.
//
// Design: one thread per landmark keeps V^-1, C and zv in registers,
// recomputes G_o' from W for the inner slot instead of holding O x 18
// values (any O works, no size gate), visits only pairs o <= o' and mirrors
// the off-diagonal blocks, and skips slots whose W is all zero (invalid or
// fixed-camera observations, which add exactly zero). Atomic order varies
// from run to run, so S and b agree with a sequential sum to float32
// rounding of the order. The damped U and lam are read on the device: no
// host sync. A later kernel can take a fold_u flag to emit the unfolded
// +QQ^T partial of the sharded engine.

#include <cstdint>
#include <cuda_runtime.h>

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

__device__ __forceinline__ bool load_g(const float* __restrict__ W18,
                                       long long OL, long long s,
                                       const float C[3][3], float G[6][3]) {
  float W[18];
  bool any = false;
#pragma unroll
  for (int c = 0; c < 18; ++c) {
    W[c] = W18[c * OL + s];
    any |= W[c] != 0.f;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int m = 0; m < 3; ++m)
      G[i][m] = W[i * 3] * C[0][m] + W[i * 3 + 1] * C[1][m] + W[i * 3 + 2] * C[2][m];
  return any;
}

__global__ void schur_s_accum(const float* __restrict__ lam_ptr,
                              const float* __restrict__ Vu,
                              const float* __restrict__ g_p,
                              const uint8_t* __restrict__ pt_valid,
                              const float* __restrict__ W18,
                              const int* __restrict__ cam_t, int O, int L, int K,
                              float* __restrict__ S, float* __restrict__ b,
                              float* __restrict__ zv_out,
                              float* __restrict__ vinv_out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const float lam = *lam_ptr;
  float v00 = Vu[l], v01 = Vu[L + l], v02 = Vu[2 * L + l];
  float v11 = Vu[3 * L + l], v12 = Vu[4 * L + l], v22 = Vu[5 * L + l];
  v00 = v00 + lam * fmaxf(v00, 1e-6f);
  v11 = v11 + lam * fmaxf(v11, 1e-6f);
  v22 = v22 + lam * fmaxf(v22, 1e-6f);
  if (!pt_valid[l]) {
    v00 = v11 = v22 = 1.f;
    v01 = v02 = v12 = 0.f;
  }
  const float A = v11 * v22 - v12 * v12;
  const float B = v02 * v12 - v01 * v22;
  const float Cc = v01 * v12 - v02 * v11;
  float det = v00 * A + v01 * B + v02 * Cc;
  det = fabsf(det) < 1e-20f ? 1e-20f : det;
  const float inv_det = 1.f / det;
  const float D = v00 * v22 - v02 * v02;
  const float E = v01 * v02 - v00 * v12;
  const float F = v00 * v11 - v01 * v01;
  const float i00 = A * inv_det, i01 = B * inv_det, i02 = Cc * inv_det;
  const float i11 = D * inv_det, i12 = E * inv_det, i22 = F * inv_det;
  vinv_out[l] = i00;
  vinv_out[L + l] = i01;
  vinv_out[2 * L + l] = i02;
  vinv_out[3 * L + l] = i11;
  vinv_out[4 * L + l] = i12;
  vinv_out[5 * L + l] = i22;

  const float l00 = sqrtf(fmaxf(i00, 1e-20f));
  const float l10 = i01 / l00;
  const float l20 = i02 / l00;
  const float l11 = sqrtf(fmaxf(i11 - l10 * l10, 1e-20f));
  const float l21 = (i12 - l20 * l10) / l11;
  const float l22 = sqrtf(fmaxf(i22 - l20 * l20 - l21 * l21, 1e-20f));
  const float C[3][3] = {{l00, 0.f, 0.f}, {l10, l11, 0.f}, {l20, l21, l22}};

  const float gp0 = g_p[l], gp1 = g_p[L + l], gp2 = g_p[2 * L + l];
  const float zv[3] = {i00 * gp0 + i01 * gp1 + i02 * gp2,
                       i01 * gp0 + i11 * gp1 + i12 * gp2,
                       i02 * gp0 + i12 * gp1 + i22 * gp2};
  zv_out[l] = zv[0];
  zv_out[L + l] = zv[1];
  zv_out[2 * L + l] = zv[2];

  const long long OL = (long long)O * L;
  const long long n6 = 6LL * K;
  for (int o = 0; o < O; ++o) {
    const long long s = (long long)o * L + l;
    float G[6][3];
    if (!load_g(W18, OL, s, C, G)) continue;
    const int cam = cam_t[s];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float wz = W18[(i * 3) * OL + s] * zv[0] +
                       W18[(i * 3 + 1) * OL + s] * zv[1] +
                       W18[(i * 3 + 2) * OL + s] * zv[2];
      atomicAdd(&b[i * K + cam], wz);
    }
    for (int o2 = o; o2 < O; ++o2) {
      const long long s2 = (long long)o2 * L + l;
      float G2[6][3];
      if (!load_g(W18, OL, s2, C, G2)) continue;
      const int cam2 = cam_t[s2];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int i2 = 0; i2 < 6; ++i2) {
          const float q = G[i][0] * G2[i2][0] + G[i][1] * G2[i2][1] + G[i][2] * G2[i2][2];
          atomicAdd(&S[(i * K + cam) * n6 + i2 * K + cam2], -q);
          if (o2 != o) atomicAdd(&S[(i2 * K + cam2) * n6 + i * K + cam], -q);
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
        (float*)S, (float*)b, (float*)zv, (float*)vinv6);
  }
  return (int)cudaGetLastError();
}
