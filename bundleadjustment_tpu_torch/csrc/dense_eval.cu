// Dense-BA evaluation + normal-equation block assembly, with an optional
// fused landmark back-substitution (kernel B).
//
// Replaces the TPU kernels bundleadjustment_tpu/solvers/pallas_dense_eval.py:
// fused_eval_assemble / _kernel (seed eval, bs = 0) and
// fused_eval_assemble_bs / _kernel_bs (bs = 1), which share _eval_tile_body.
//
// Per landmark l (one thread) and per observation slot o of it:
//   bs = 1 first forms the trial point
//     Xt_new = Xt - V^-1 (g_p + sum_o W_prev[o]^T dc[cam_o])   (valid points)
//   then, at the (trial) point: projection, sigma-whitened residuals, Huber
//   weights (delta = sqrt(5.991)), the cheirality penalty (z <= 1e-6) and the
//   analytic Jacobians (left-multiplicative so(3) camera perturbation).
// Outputs: the robust cost; red[K][27] = per-camera sums of the 21 upper-
// triangle U entries and 6 g_c entries; point-side Vu[6][L], g_p[3][L];
// W[18][O][L]; Xt_new[3][L] (bs = 1).
//
// What bounds it on H100: memory traffic. Per observation it reads ~5
// floats of problem data (+18 of W_prev with bs) and writes 18 floats of W,
// about 100 B against ~300 flops, so at 100k landmarks x O = 8 one call moves
// ~80 MB and should take tens of microseconds at 3.35 TB/s; the per-camera
// reduction is the other cost.
//
// Design: one thread per landmark loops over its O slots, so Vu, g_p and
// the back-substitution stay in registers and every [O][L] plane is read
// and written coalesced along L. The TPU carried the per-camera sums across
// a sequential grid; GPU blocks run in parallel, so each block sums its
// landmarks' rows into a shared-memory [K][27] table with shared atomics and
// then adds the table to the zero-initialised global red with one atomic per
// non-zero entry (when 27*K floats exceed 48 KB the rows go straight to
// global atomics). The cost is reduced by warp shuffles first. Float atomics
// make the summation order vary from run to run: red and cost agree with a
// sequential sum to float32 rounding of the order, not bit for bit.
// Invalid slots and fixed-camera slots add nothing to red (their rows are
// exactly zero in the reference), so they are skipped. Any K and O work:
// there is no size gate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kHuber = 2.4477f;
constexpr float kCheirality = 1.0e4f;
constexpr int kRed = 27;
constexpr int kThreads = 128;
constexpr int kSmemLimit = 48 * 1024;

__device__ __forceinline__ void red_add(float* smem, float* gmem, bool use_smem,
                                        int idx, float v) {
  if (use_smem) atomicAdd(&smem[idx], v);
  else atomicAdd(&gmem[idx], v);
}

template <bool kBS>
__global__ void dense_eval_kernel(
    const float* __restrict__ k4, const float* __restrict__ R,
    const float* __restrict__ t, const float* __restrict__ dc,
    const int* __restrict__ cam_t, const float* __restrict__ uv_t,
    const float* __restrict__ isig_t, const uint8_t* __restrict__ valid_t,
    const uint8_t* __restrict__ fixed_t, const float* __restrict__ Xt,
    const float* __restrict__ w_prev, const float* __restrict__ vinv6,
    const float* __restrict__ gp_prev, const uint8_t* __restrict__ pt_valid,
    int O, int L, int K, int robust, int use_smem, float* __restrict__ red,
    float* __restrict__ cost, float* __restrict__ vu_out,
    float* __restrict__ gp_out, float* __restrict__ w_out,
    float* __restrict__ xt_new) {
  extern __shared__ float sred[];
  __shared__ float scost;
  if (use_smem)
    for (int e = threadIdx.x; e < K * kRed; e += blockDim.x) sred[e] = 0.f;
  if (threadIdx.x == 0) scost = 0.f;
  __syncthreads();

  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const long long OL = (long long)O * L;
  float my_cost = 0.f;
  if (l < L) {
    const float fx = k4[0], fy = k4[1], cx = k4[2], cy = k4[3];
    float X0 = Xt[l], X1 = Xt[L + l], X2 = Xt[2 * L + l];
    if (kBS) {
      float y[3] = {0.f, 0.f, 0.f};
      for (int o = 0; o < O; ++o) {
        const long long s = (long long)o * L + l;
        const float* d = dc + 6 * cam_t[s];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < 6; ++i) acc += w_prev[(i * 3 + j) * OL + s] * d[i];
          y[j] += acc;
        }
      }
      const float a0 = gp_prev[l] + y[0];
      const float a1 = gp_prev[L + l] + y[1];
      const float a2 = gp_prev[2 * L + l] + y[2];
      const float* v = vinv6;
      if (pt_valid[l]) {
        X0 += -(v[l] * a0 + v[L + l] * a1 + v[2 * L + l] * a2);
        X1 += -(v[L + l] * a0 + v[3 * L + l] * a1 + v[4 * L + l] * a2);
        X2 += -(v[2 * L + l] * a0 + v[4 * L + l] * a1 + v[5 * L + l] * a2);
      }
      xt_new[l] = X0;
      xt_new[L + l] = X1;
      xt_new[2 * L + l] = X2;
    }

    float vu[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float gp[3] = {0.f, 0.f, 0.f};
    for (int o = 0; o < O; ++o) {
      const long long s = (long long)o * L + l;
      if (!valid_t[s]) {
#pragma unroll
        for (int c = 0; c < 18; ++c) w_out[c * OL + s] = 0.f;
        continue;
      }
      const int cam = cam_t[s];
      const float* Rc = R + 9 * cam;
      const float* tc = t + 3 * cam;
      float RX[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        RX[i] = Rc[3 * i] * X0 + Rc[3 * i + 1] * X1 + Rc[3 * i + 2] * X2;
      const float x0 = RX[0] + tc[0];
      const float x1 = RX[1] + tc[1];
      const float z = RX[2] + tc[2];
      const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
      const float inv_z = 1.f / zs;
      const float isig = isig_t[s];
      float r0 = (fx * x0 * inv_z + cx - uv_t[s]) * isig;
      float r1 = (fy * x1 * inv_z + cy - uv_t[OL + s]) * isig;
      const float r2 = r0 * r0 + r1 * r1;
      float rho;
      if (robust) {
        const float n2 = sqrtf(fmaxf(r2, 1e-20f));
        rho = n2 <= kHuber ? 0.5f * r2 : kHuber * (n2 - 0.5f * kHuber);
      } else {
        rho = 0.5f * r2;
      }
      const bool front = z > 1e-6f;
      my_cost += front ? rho : kCheirality;

      float w = front ? 1.f : 0.f;
      if (robust) {
        const float n = sqrtf(fmaxf(r2, 1e-24f));
        w *= n <= kHuber ? 1.f : kHuber / n;
      }
      const float sw = sqrtf(w);
      r0 *= sw * (front ? 1.f : 0.f);
      r1 *= sw * (front ? 1.f : 0.f);
      const float sw_free = fixed_t[s] ? 0.f : sw;

      const float a = fx * inv_z * isig;
      const float b = fy * inv_z * isig;
      const float duv[2][3] = {{a, 0.f, -a * x0 * inv_z}, {0.f, b, -b * x1 * inv_z}};
      const float ns[3][3] = {{0.f, RX[2], -RX[1]}, {-RX[2], 0.f, RX[0]},
                              {RX[1], -RX[0], 0.f}};
      float Jc[2][6], Jp[2][3];
#pragma unroll
      for (int al = 0; al < 2; ++al) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          Jc[al][j] = (duv[al][0] * ns[0][j] + duv[al][1] * ns[1][j] +
                       duv[al][2] * ns[2][j]) * sw_free;
          Jc[al][3 + j] = duv[al][j] * sw_free;
          Jp[al][j] = (duv[al][0] * Rc[j] + duv[al][1] * Rc[3 + j] +
                       duv[al][2] * Rc[6 + j]) * sw;
        }
      }

      if (sw_free != 0.f) {  // fixed cameras' rows are exactly zero
        int n = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = i; j < 6; ++j, ++n)
            red_add(sred, red, use_smem, cam * kRed + n,
                    Jc[0][i] * Jc[0][j] + Jc[1][i] * Jc[1][j]);
#pragma unroll
        for (int i = 0; i < 6; ++i)
          red_add(sred, red, use_smem, cam * kRed + 21 + i,
                  Jc[0][i] * r0 + Jc[1][i] * r1);
      }
      int n = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = i; j < 3; ++j, ++n) vu[n] += Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j];
#pragma unroll
      for (int i = 0; i < 3; ++i) gp[i] += Jp[0][i] * r0 + Jp[1][i] * r1;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          w_out[(i * 3 + j) * OL + s] = Jc[0][i] * Jp[0][j] + Jc[1][i] * Jp[1][j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) vu_out[i * L + l] = vu[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) gp_out[i * L + l] = gp[i];
  }

  // cost: warp shuffle tree, then one shared and one global atomic per block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_cost += __shfl_down_sync(0xffffffffu, my_cost, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(&scost, my_cost);
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(cost, scost);
  if (use_smem)
    for (int e = threadIdx.x; e < K * kRed; e += blockDim.x)
      if (sred[e] != 0.f) atomicAdd(&red[e], sred[e]);
}

}  // namespace

extern "C" int dense_eval_assemble(
    const void* k4, const void* R, const void* t, const void* dc,
    const void* cam_t, const void* uv_t, const void* isig_t,
    const void* valid_t, const void* fixed_t, const void* Xt,
    const void* w_prev, const void* vinv6, const void* gp_prev,
    const void* pt_valid, int O, int L, int K, int robust, int bs, void* red,
    void* cost, void* vu, void* gp, void* w, void* xt_new, void* stream) {
  if (L <= 0) return 0;
  const size_t smem_bytes = (size_t)K * kRed * sizeof(float);
  const int use_smem = smem_bytes <= (size_t)kSmemLimit;
  const dim3 grid((L + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t shm = use_smem ? smem_bytes : 0;
  if (bs) {
    dense_eval_kernel<true><<<grid, kThreads, shm, s>>>(
        (const float*)k4, (const float*)R, (const float*)t, (const float*)dc,
        (const int*)cam_t, (const float*)uv_t, (const float*)isig_t,
        (const uint8_t*)valid_t, (const uint8_t*)fixed_t, (const float*)Xt,
        (const float*)w_prev, (const float*)vinv6, (const float*)gp_prev,
        (const uint8_t*)pt_valid, O, L, K, robust, use_smem, (float*)red,
        (float*)cost, (float*)vu, (float*)gp, (float*)w, (float*)xt_new);
  } else {
    dense_eval_kernel<false><<<grid, kThreads, shm, s>>>(
        (const float*)k4, (const float*)R, (const float*)t, nullptr,
        (const int*)cam_t, (const float*)uv_t, (const float*)isig_t,
        (const uint8_t*)valid_t, (const uint8_t*)fixed_t, (const float*)Xt,
        nullptr, nullptr, nullptr, nullptr, O, L, K, robust, use_smem,
        (float*)red, (float*)cost, (float*)vu, (float*)gp, (float*)w, nullptr);
  }
  return (int)cudaGetLastError();
}
