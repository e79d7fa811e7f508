// Per-landmark Schur-prepare math shared by kernel C and K5 (schur_s.cu) and
// kernel D (schur_prepare.cu): the damped point block, its closed-form
// inverse, the lower Cholesky factor of the inverse, zv = V^-1 g_p
// (point_solve; point_store writes V^-1 and zv), and G_o = W_o chol(V^-1)
// for one observation slot, at a camera width of 6 or 9 (W_o 6x3 or 9x3). The formulas and their
// operation order are those of the reference's _schur_kernel /
// _schur_s_kernel (bundleadjustment_tpu/solvers/pallas_dense_eval.py) and of
// the plain PyTorch version (`_point_prepare_plain` in
// solvers/dense_kernels.py); built with --fmad=false they round alike.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct PointPrep {
  float C[3][3];  // lower chol(V^-1)
  float zv[3];    // V^-1 g_p
  float vinv[6];  // V^-1: (0,0) (0,1) (0,2) (1,1) (1,2) (2,2)
};

// Damped V (identity for invalid points), V^-1, chol(V^-1) and zv of
// landmark l, in registers; nothing is written.
__device__ __forceinline__ PointPrep point_solve(
    float lam, const float* __restrict__ Vu, const float* __restrict__ g_p,
    const uint8_t* __restrict__ pt_valid, int l, int L) {
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

  PointPrep p;
  p.vinv[0] = i00; p.vinv[1] = i01; p.vinv[2] = i02;
  p.vinv[3] = i11; p.vinv[4] = i12; p.vinv[5] = i22;
  const float l00 = sqrtf(fmaxf(i00, 1e-20f));
  const float l10 = i01 / l00;
  const float l20 = i02 / l00;
  const float l11 = sqrtf(fmaxf(i11 - l10 * l10, 1e-20f));
  const float l21 = (i12 - l20 * l10) / l11;
  const float l22 = sqrtf(fmaxf(i22 - l20 * l20 - l21 * l21, 1e-20f));
  p.C[0][0] = l00; p.C[0][1] = 0.f; p.C[0][2] = 0.f;
  p.C[1][0] = l10; p.C[1][1] = l11; p.C[1][2] = 0.f;
  p.C[2][0] = l20; p.C[2][1] = l21; p.C[2][2] = l22;

  const float gp0 = g_p[l], gp1 = g_p[L + l], gp2 = g_p[2 * L + l];
  p.zv[0] = i00 * gp0 + i01 * gp1 + i02 * gp2;
  p.zv[1] = i01 * gp0 + i11 * gp1 + i12 * gp2;
  p.zv[2] = i02 * gp0 + i12 * gp1 + i22 * gp2;
  return p;
}

// V^-1 -> vinv_out[6][L] and zv -> zv_out[3][L] for landmark l.
__device__ __forceinline__ void point_store(const PointPrep& p, int l, int L,
                                            float* __restrict__ zv_out,
                                            float* __restrict__ vinv_out) {
#pragma unroll
  for (int j = 0; j < 6; ++j) vinv_out[j * L + l] = p.vinv[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) zv_out[j * L + l] = p.zv[j];
}

// point_solve, then point_store: returns C and zv for the slot loop.
__device__ __forceinline__ PointPrep point_prepare(
    float lam, const float* __restrict__ Vu, const float* __restrict__ g_p,
    const uint8_t* __restrict__ pt_valid, int l, int L,
    float* __restrict__ zv_out, float* __restrict__ vinv_out) {
  const PointPrep p = point_solve(lam, Vu, g_p, pt_valid, l, L);
  point_store(p, l, L, zv_out, vinv_out);
  return p;
}

// G = W C for one slot's W (3 kP values: a camera width of kP). Returns
// whether any W value is non-zero (an all-zero slot, invalid or of a fixed
// camera, adds exactly zero to every sum).
template <int kP = 6>
__device__ __forceinline__ bool w_g(const float* W, const float C[3][3],
                                    float (*G)[3]) {
  bool any = false;
#pragma unroll
  for (int c = 0; c < 3 * kP; ++c) any |= W[c] != 0.f;
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int m = 0; m < 3; ++m)
      G[i][m] = W[i * 3] * C[0][m] + W[i * 3 + 1] * C[1][m] + W[i * 3 + 2] * C[2][m];
  return any;
}

// W_o (3 kP values of slot s of W [3 kP][O*L]) into W; G = W C (w_g).
template <int kP = 6>
__device__ __forceinline__ bool load_w_g(const float* __restrict__ W18,
                                         long long OL, long long s,
                                         const float C[3][3], float* W,
                                         float (*G)[3]) {
#pragma unroll
  for (int c = 0; c < 3 * kP; ++c) W[c] = W18[c * OL + s];
  return w_g<kP>(W, C, G);
}

// (W_o zv)_i for i < kP: the slot's term of the camera rhs rows.
__device__ __forceinline__ float w_zv(const float* W, const float zv[3], int i) {
  return W[i * 3] * zv[0] + W[i * 3 + 1] * zv[1] + W[i * 3 + 2] * zv[2];
}
