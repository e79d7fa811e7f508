// Dense-BA evaluation + normal-equation block assembly, with an optional
// fused landmark back-substitution (kernel B).
//
// Replaces the TPU kernels bundleadjustment_tpu/solvers/pallas_dense_eval.py:
// fused_eval_assemble / _kernel (seed eval, bs = 0) and
// fused_eval_assemble_bs / _kernel_bs (bs = 1), which share _eval_tile_body.
//
// Per landmark l and per observation slot o of it:
//   bs = 1 first forms the trial point
//     Xt_new = Xt - V^-1 (g_p + sum_o W_prev[o]^T dc[cam_o])   (valid points)
//   then, at the (trial) point: projection, sigma-whitened residuals, Huber
//   weights (delta = sqrt(5.991)), the cheirality penalty (z <= 1e-6) and the
//   analytic Jacobians (left-multiplicative so(3) camera perturbation).
// Outputs: the robust cost; red[K][NR] = per-camera sums of the P (P + 1) / 2
// upper-triangle U entries and P g_c entries; point-side Vu[6][L], g_p[3][L];
// W[3P][O][L]; Xt_new[3][L] (bs = 1).
//
// The camera width P is a template parameter (NR = 27 rows a camera at 6, 54
// at 9):
// - P = 6, the pinhole model: rt6 cameras through one shared K4 = (fx, fy,
//   cx, cy);
// - P = 9, BAL's camera (dense_ba.CAMERA_WIDTH), in the solve's axes (the
//   host turns BAL's -z camera into a +z one, dense_ba.bal_axes): intr[K][3]
//   = (f, k1, k2) a camera, p = P_xy / P_z, n = |p|^2, rd = 1 + k1 n + k2 n^2,
//   u = f rd p about the principal point; the 2x9 camera Jacobian is the
//   rotation's and the translation's through d(f rd p)/dp = f (rd I +
//   2 (k1 + 2 k2 n) p p^T), then rd p, f n p and f n^2 p for f, k1, k2.
//
// What bounds it on H100: memory traffic at large L. Per observation it
// reads ~5 floats of problem data (+18 of W_prev with bs) and writes 18
// floats of W, about 100 B against ~320 flops: 0.023 ms (seed) and 0.042
// ms (bs) at 128c/100k/O=8. At the pipeline's final BA (8 cameras, ~1,000
// landmarks, O = 8) the bound is under a microsecond, and what is left is
// the latency of one unit of work and of the per-camera reduction.
//
// Design (the host plan dense_kernels.dense_eval_plan picks the numbers):
// - Work unit: a warp takes 32 / S landmarks at once, S lanes a landmark
//   (S a power of two up to 32, at most O rounded up), lane s taking slots
//   s, s + S, ...; the plan takes the smallest S that gives the card about
//   eight warps an SM, so ~1,000 landmarks at O = 8 fill 256 warps while
//   100k landmarks keep one lane a landmark (W stores coalesced along L).
//   The point-side sums (Vu, g_p, and bs's sum of W^T dc) are reduced over
//   a landmark's S lanes by xor shuffles, which leave the same bits in every
//   lane of the segment. A grid of at most ~16 warps an SM walks the units
//   (rounds).
// - Per-camera rows without atomics: each warp owns a [T][27] table in
//   shared memory. After each round of slots, the lanes are grouped by
//   camera (__match_any_sync) and each group's 27 rows are summed into its
//   lowest lane by a shuffle tree (pointer jumping over the group's lanes,
//   a fixed order), which adds them into the table with plain loads and
//   stores: the groups of a warp hold distinct cameras. At the end a block
//   sums its warps' tables in warp order and writes them, with its cost, to
//   a slab of its own; dense_eval_finish sums the slabs of each entry in a
//   fixed order (16 strided partial sums, then those in order). So red and
//   cost are the same bits from run to run, and every entry of red and cost
//   is written: no zeroing launch. Invalid and fixed-camera slots add nothing
//   (their rows are exactly zero in the reference).
// - Large K: the cameras are cut into n_tiles tiles of T <= 128 (the plan);
//   grid.y is the tile. The blocks of tile 0 write every per-landmark output
//   and the cost; those of the other tiles evaluate only the slots whose
//   camera lies in their tile and add their rows. With bs, a first pass
//   (dense_eval_backsub) forms the trial landmarks once, and the tiles
//   evaluate there as the seed eval does, so no tile reads W_prev again.
// Float32 on the CUDA cores; the library is built with --fmad=false, so the
// per-slot values round as in the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_groups.cuh"

namespace {

constexpr float kHuber = 2.4477f;
constexpr float kCheirality = 1.0e4f;
constexpr int kParts = 16;    // dense_eval_finish: partial sums an entry
constexpr int kEntries = 16;  // dense_eval_finish: entries a block
constexpr int kMaxSmem = 232448;

// rows of red a camera at camera width P
__host__ __device__ constexpr int n_red(int P) { return P * (P + 1) / 2 + P; }

template <bool kBS, int kP>
__global__ void dense_eval_units(
    const float* __restrict__ k4, const float* __restrict__ intr,
    const float* __restrict__ R,
    const float* __restrict__ t, const float* __restrict__ dc,
    const int* __restrict__ cam_t, const float* __restrict__ uv_t,
    const float* __restrict__ isig_t, const uint8_t* __restrict__ valid_t,
    const uint8_t* __restrict__ fixed_t, const float* __restrict__ Xt,
    const float* __restrict__ w_prev, const float* __restrict__ vinv6,
    const float* __restrict__ gp_prev, const uint8_t* __restrict__ pt_valid,
    int O, int L, int robust, int lanes_log2, int tile, float* __restrict__ slab,
    float* __restrict__ vu_out, float* __restrict__ gp_out,
    float* __restrict__ w_out, float* __restrict__ xt_new) {
  constexpr int kRed = n_red(kP);
  extern __shared__ float smem[];  // [warps][tile * kRed] tables, [warps] costs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwb = blockDim.x >> 5;
  const int TR = tile * kRed;
  float* table = smem + warp * TR;
  for (int e = lane; e < TR; e += 32) table[e] = 0.f;
  __syncwarp();

  const int S = 1 << lanes_log2, G = 32 >> lanes_log2;
  const int g = lane >> lanes_log2, s = lane & (S - 1);
  const int cam0 = blockIdx.y * tile;
  const bool primary = blockIdx.y == 0;  // writes the per-landmark outputs
  const long long OL = (long long)O * L;
  const int units = (L + G - 1) / G;
  const float fx = k4[0], fy = k4[1], cx = k4[2], cy = k4[3];
  float my_cost = 0.f;

  for (int u = blockIdx.x * nwb + warp; u < units; u += gridDim.x * nwb) {
    const int l = u * G + g;
    const bool act = l < L;
    float X0 = 0.f, X1 = 0.f, X2 = 0.f;
    if (act) {
      X0 = Xt[l];
      X1 = Xt[L + l];
      X2 = Xt[2 * L + l];
    }
    if (kBS) {
      float y[3] = {0.f, 0.f, 0.f};
      if (act) {
        for (int o = s; o < O; o += S) {
          const long long q = (long long)o * L + l;
          const float* d = dc + kP * cam_t[q];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < kP; ++i) acc += w_prev[(i * 3 + j) * OL + q] * d[i];
            y[j] += acc;
          }
        }
      }
      for (int off = S >> 1; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < 3; ++j) y[j] += __shfl_xor_sync(kFull, y[j], off);
      if (act) {
        const float a0 = gp_prev[l] + y[0];
        const float a1 = gp_prev[L + l] + y[1];
        const float a2 = gp_prev[2 * L + l] + y[2];
        const float* v = vinv6;
        if (pt_valid[l]) {
          X0 += -(v[l] * a0 + v[L + l] * a1 + v[2 * L + l] * a2);
          X1 += -(v[L + l] * a0 + v[3 * L + l] * a1 + v[4 * L + l] * a2);
          X2 += -(v[2 * L + l] * a0 + v[4 * L + l] * a1 + v[5 * L + l] * a2);
        }
        if (primary && s == 0) {
          xt_new[l] = X0;
          xt_new[L + l] = X1;
          xt_new[2 * L + l] = X2;
        }
      }
    }

    float vu[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float gp[3] = {0.f, 0.f, 0.f};
    for (int o0 = 0; o0 < O; o0 += S) {  // the same rounds in every lane
      const int o = o0 + s;
      const long long q = (long long)o * L + l;
      const bool live = act && o < O;
      const bool valid = live && valid_t[q];
      int key = -1;
      float rows[kRed];
#pragma unroll
      for (int n = 0; n < kRed; ++n) rows[n] = 0.f;
      if (live && !valid && primary) {
#pragma unroll
        for (int c = 0; c < 3 * kP; ++c) w_out[c * OL + q] = 0.f;
      }
      const int cam = valid ? cam_t[q] : -1;
      const bool in_tile = cam >= cam0 && cam < cam0 + tile;
      if (valid && (primary || in_tile)) {
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
        const float isig = isig_t[q];
        float r0, r1;
        float px = 0.f, py = 0.f, n2 = 0.f, rd = 0.f, f = 0.f, k1 = 0.f, k2 = 0.f;
        if (kP == 6) {
          r0 = (fx * x0 * inv_z + cx - uv_t[q]) * isig;
          r1 = (fy * x1 * inv_z + cy - uv_t[OL + q]) * isig;
        } else {
          f = intr[3 * cam];
          k1 = intr[3 * cam + 1];
          k2 = intr[3 * cam + 2];
          px = x0 * inv_z;
          py = x1 * inv_z;
          n2 = px * px + py * py;
          rd = 1.f + n2 * (k1 + k2 * n2);
          const float fr = f * rd;
          r0 = (fr * px - uv_t[q]) * isig;
          r1 = (fr * py - uv_t[OL + q]) * isig;
        }
        const float r2 = r0 * r0 + r1 * r1;
        float rho;
        if (robust) {
          const float n2 = sqrtf(fmaxf(r2, 1e-20f));
          rho = n2 <= kHuber ? 0.5f * r2 : kHuber * (n2 - 0.5f * kHuber);
        } else {
          rho = 0.5f * r2;
        }
        const bool front = z > 1e-6f;
        float w = front ? 1.f : 0.f;
        if (robust) {
          const float n = sqrtf(fmaxf(r2, 1e-24f));
          w *= n <= kHuber ? 1.f : kHuber / n;
        }
        const float sw = sqrtf(w);
        r0 *= sw * (front ? 1.f : 0.f);
        r1 *= sw * (front ? 1.f : 0.f);
        const float sw_free = fixed_t[q] ? 0.f : sw;

        float duv[2][3];
        if (kP == 6) {
          const float a = fx * inv_z * isig;
          const float b = fy * inv_z * isig;
          duv[0][0] = a;
          duv[0][1] = 0.f;
          duv[0][2] = -a * x0 * inv_z;
          duv[1][0] = 0.f;
          duv[1][1] = b;
          duv[1][2] = -b * x1 * inv_z;
        } else {
          const float c = 2.f * (k1 + 2.f * k2 * n2);
          const float fi = f * isig;
          const float a00 = fi * (rd + c * px * px);
          const float a01 = fi * (c * px * py);
          const float a11 = fi * (rd + c * py * py);
          duv[0][0] = a00 * inv_z;
          duv[0][1] = a01 * inv_z;
          duv[0][2] = -(a00 * px + a01 * py) * inv_z;
          duv[1][0] = a01 * inv_z;
          duv[1][1] = a11 * inv_z;
          duv[1][2] = -(a01 * px + a11 * py) * inv_z;
        }
        const float ns[3][3] = {{0.f, RX[2], -RX[1]}, {-RX[2], 0.f, RX[0]},
                                {RX[1], -RX[0], 0.f}};
        float Jc[2][kP], Jp[2][3];
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
        if (kP == 9) {  // f, k1, k2: rd p, f n p, f n^2 p
          const float ji[3] = {rd * isig, f * n2 * isig, f * n2 * n2 * isig};
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            Jc[0][6 + m] = ji[m] * px * sw_free;
            Jc[1][6 + m] = ji[m] * py * sw_free;
          }
        }
        if (in_tile && sw_free != 0.f) {  // fixed cameras' rows are exactly zero
          key = cam - cam0;
          int n = 0;
#pragma unroll
          for (int i = 0; i < kP; ++i)
#pragma unroll
            for (int j = i; j < kP; ++j, ++n)
              rows[n] = Jc[0][i] * Jc[0][j] + Jc[1][i] * Jc[1][j];
#pragma unroll
          for (int i = 0; i < kP; ++i) rows[n + i] = Jc[0][i] * r0 + Jc[1][i] * r1;
        }
        if (primary) {
          my_cost += front ? rho : kCheirality;
          int n = 0;
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = i; j < 3; ++j, ++n)
              vu[n] += Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j];
#pragma unroll
          for (int i = 0; i < 3; ++i) gp[i] += Jp[0][i] * r0 + Jp[1][i] * r1;
#pragma unroll
          for (int i = 0; i < kP; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j)
              w_out[(i * 3 + j) * OL + q] = Jc[0][i] * Jp[0][j] + Jc[1][i] * Jp[1][j];
        }
      }
      group_add(table, key, rows, lane);
    }
    if (primary) {  // a landmark's slots, over its S lanes
      for (int off = S >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < 6; ++i) vu[i] += __shfl_xor_sync(kFull, vu[i], off);
#pragma unroll
        for (int i = 0; i < 3; ++i) gp[i] += __shfl_xor_sync(kFull, gp[i], off);
      }
      if (act && s == 0) {
#pragma unroll
        for (int i = 0; i < 6; ++i) vu_out[i * L + l] = vu[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) gp_out[i * L + l] = gp[i];
      }
    }
  }

  // the block's slab: its warps' tables and costs, summed in warp order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_cost += __shfl_down_sync(kFull, my_cost, off);
  float* wcost = smem + nwb * TR;
  if (lane == 0) wcost[warp] = my_cost;
  __syncthreads();
  float* out = slab + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * (TR + 1);
  for (int e = threadIdx.x; e < TR; e += blockDim.x) {
    float acc = smem[e];
    for (int w = 1; w < nwb; ++w) acc += smem[w * TR + e];
    out[e] = acc;
  }
  if (threadIdx.x == 0) {
    float c = wcost[0];
    for (int w = 1; w < nwb; ++w) c += wcost[w];
    out[TR] = c;
  }
}

// red[k][n] and cost: entry e of the slabs of every block of its tile, in
// kParts strided partial sums (block b in part b % kParts, in increasing b),
// then the parts in order.
template <int kRed>
__global__ void dense_eval_finish(const float* __restrict__ slab, int blocks,
                                  int tile, int K, float* __restrict__ red,
                                  float* __restrict__ cost) {
  __shared__ float part[kParts][kEntries];
  const int el = threadIdx.x % kEntries, p = threadIdx.x / kEntries;
  const int e = blockIdx.x * kEntries + el;
  const int TR = tile * kRed, n_all = K * kRed;
  float acc = 0.f;
  if (e <= n_all) {
    int j = 0, off = TR;  // the cost
    if (e < n_all) {
      const int k = e / kRed;
      j = k / tile;
      off = (k - j * tile) * kRed + e % kRed;
    }
    const float* base = slab + (long long)j * blocks * (TR + 1) + off;
#pragma unroll 8
    for (int b = p; b < blocks; b += kParts) acc += base[(long long)b * (TR + 1)];
  }
  part[p][el] = acc;
  __syncthreads();
  if (p == 0 && e <= n_all) {
    float sum = part[0][el];
    for (int i = 1; i < kParts; ++i) sum += part[i][el];
    if (e < n_all) red[e] = sum;
    else *cost = sum;
  }
}

// The trial landmarks alone, in the units kernel's lanes (S lanes a
// landmark, its slots summed lane by lane, then over the lanes by xor
// shuffles), so Xt_new has the same bits as the fused kernel's: the back-
// substitution pass of the camera-tiled case.
template <int kP>
__global__ void dense_eval_backsub(const float* __restrict__ dc,
                                   const int* __restrict__ cam_t,
                                   const float* __restrict__ Xt,
                                   const float* __restrict__ w_prev,
                                   const float* __restrict__ vinv6,
                                   const float* __restrict__ gp_prev,
                                   const uint8_t* __restrict__ pt_valid, int O,
                                   int L, int lanes_log2, float* __restrict__ xt_new) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int S = 1 << lanes_log2, G = 32 >> lanes_log2;
  const int l = u * G + (lane >> lanes_log2), s = lane & (S - 1);
  const bool act = l < L;
  const long long OL = (long long)O * L;
  float y[3] = {0.f, 0.f, 0.f};
  if (act) {
    for (int o = s; o < O; o += S) {
      const long long q = (long long)o * L + l;
      const float* d = dc + kP * cam_t[q];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kP; ++i) acc += w_prev[(i * 3 + j) * OL + q] * d[i];
        y[j] += acc;
      }
    }
  }
  for (int off = S >> 1; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < 3; ++j) y[j] += __shfl_xor_sync(kFull, y[j], off);
  if (!act || s != 0) return;
  float X0 = Xt[l], X1 = Xt[L + l], X2 = Xt[2 * L + l];
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

template <bool kBS, int kP>
int launch_units(dim3 grid, int threads, size_t smem, cudaStream_t s,
                 const float* k4, const float* intr, const float* R, const float* t,
                 const float* dc, const int* cam_t, const float* uv_t,
                 const float* isig_t, const uint8_t* valid_t, const uint8_t* fixed_t,
                 const float* Xt, const float* w_prev, const float* vinv6,
                 const float* gp_prev, const uint8_t* pt_valid, int O, int L,
                 int robust, int lanes_log2, int tile, float* slab, float* vu,
                 float* gp, float* w, float* xt_new) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_eval_units<kBS, kP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dense_eval_units<kBS, kP><<<grid, threads, smem, s>>>(
      k4, intr, R, t, dc, cam_t, uv_t, isig_t, valid_t, fixed_t, Xt, w_prev, vinv6,
      gp_prev, pt_valid, O, L, robust, lanes_log2, tile, slab, vu, gp, w, xt_new);
  return (int)cudaGetLastError();
}

template <int kP>
int launch(const float* k4, const float* intr, const float* R, const float* t,
           const float* dc, const int* cam_t, const float* uv_t, const float* isig_t,
           const uint8_t* valid_t, const uint8_t* fixed_t, const float* Xt,
           const float* w_prev, const float* vinv6, const float* gp_prev,
           const uint8_t* pt_valid, int O, int L, int K, int robust, int bs,
           int lanes_log2, int warps, int blocks, int tile, int n_tiles, float* slab,
           float* red, float* cost, float* vu, float* gp, float* w, float* xt_new,
           cudaStream_t s) {
  constexpr int kRed = n_red(kP);
  if (blocks > 0 && L > 0) {
    const size_t smem = ((size_t)warps * tile * kRed + warps) * sizeof(float);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    const dim3 grid(blocks, n_tiles);
    if (bs && n_tiles > 1) {
      // every tile needs the trial landmarks: form them once, then evaluate
      // there as the seed eval does
      const int units = (L + (32 >> lanes_log2) - 1) / (32 >> lanes_log2);
      dense_eval_backsub<kP><<<(units + 3) / 4, 128, 0, s>>>(
          dc, cam_t, Xt, w_prev, vinv6, gp_prev, pt_valid, O, L, lanes_log2, xt_new);
      Xt = xt_new;
      bs = 0;
    }
    const int code =
        bs ? launch_units<true, kP>(grid, warps * 32, smem, s, k4, intr, R, t, dc,
                                    cam_t, uv_t, isig_t, valid_t, fixed_t, Xt, w_prev,
                                    vinv6, gp_prev, pt_valid, O, L, robust, lanes_log2,
                                    tile, slab, vu, gp, w, xt_new)
           : launch_units<false, kP>(grid, warps * 32, smem, s, k4, intr, R, t,
                                     nullptr, cam_t, uv_t, isig_t, valid_t, fixed_t,
                                     Xt, nullptr, nullptr, nullptr, nullptr, O, L,
                                     robust, lanes_log2, tile, slab, vu, gp, w,
                                     nullptr);
    if (code != 0) return code;
  } else {
    blocks = 0;  // nothing to sum: red and cost are written as zeros
  }
  const int entries = K * kRed + 1;
  dense_eval_finish<kRed><<<(entries + kEntries - 1) / kEntries, kParts * kEntries, 0, s>>>(
      slab, blocks, tile, K, red, cost);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's numbers (dense_kernels.dense_eval_plan): lanes_log2 = log2 S,
// warps a block, blocks (grid.x; 0 when L = 0), tile T, n_tiles (grid.y);
// slab holds n_tiles * blocks * (NR T + 1) floats. width: 6 (the pinhole
// K4, intr null) or 9 (intr [K][3]).
extern "C" int dense_eval_assemble(
    const void* k4, const void* intr, const void* R, const void* t, const void* dc,
    const void* cam_t, const void* uv_t, const void* isig_t,
    const void* valid_t, const void* fixed_t, const void* Xt,
    const void* w_prev, const void* vinv6, const void* gp_prev,
    const void* pt_valid, int O, int L, int K, int width, int robust, int bs,
    int lanes_log2, int warps, int blocks, int tile, int n_tiles, void* slab,
    void* red, void* cost, void* vu, void* gp, void* w, void* xt_new,
    void* stream) {
  if (width != 6 && !(width == 9 && intr != nullptr)) return (int)cudaErrorInvalidValue;
  auto run = width == 6 ? launch<6> : launch<9>;
  return run((const float*)k4, (const float*)intr, (const float*)R, (const float*)t,
             (const float*)dc, (const int*)cam_t, (const float*)uv_t,
             (const float*)isig_t, (const uint8_t*)valid_t, (const uint8_t*)fixed_t,
             (const float*)Xt, (const float*)w_prev, (const float*)vinv6,
             (const float*)gp_prev, (const uint8_t*)pt_valid, O, L, K, robust, bs,
             lanes_log2, warps, blocks, tile, n_tiles, (float*)slab, (float*)red,
             (float*)cost, (float*)vu, (float*)gp, (float*)w, (float*)xt_new,
             (cudaStream_t)stream);
}
