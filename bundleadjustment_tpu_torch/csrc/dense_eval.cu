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
// Outputs: the robust cost; red[K][27] = per-camera sums of the 21 upper-
// triangle U entries and 6 g_c entries; point-side Vu[6][L], g_p[3][L];
// W[18][O][L]; Xt_new[3][L] (bs = 1).
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
constexpr int kRed = 27;
constexpr int kParts = 16;    // dense_eval_finish: partial sums an entry
constexpr int kEntries = 16;  // dense_eval_finish: entries a block
constexpr int kMaxSmem = 232448;

template <bool kBS>
__global__ void dense_eval_units(
    const float* __restrict__ k4, const float* __restrict__ R,
    const float* __restrict__ t, const float* __restrict__ dc,
    const int* __restrict__ cam_t, const float* __restrict__ uv_t,
    const float* __restrict__ isig_t, const uint8_t* __restrict__ valid_t,
    const uint8_t* __restrict__ fixed_t, const float* __restrict__ Xt,
    const float* __restrict__ w_prev, const float* __restrict__ vinv6,
    const float* __restrict__ gp_prev, const uint8_t* __restrict__ pt_valid,
    int O, int L, int robust, int lanes_log2, int tile, float* __restrict__ slab,
    float* __restrict__ vu_out, float* __restrict__ gp_out,
    float* __restrict__ w_out, float* __restrict__ xt_new) {
  extern __shared__ float smem[];  // [warps][tile * 27] tables, [warps] costs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwb = blockDim.x >> 5;
  const int T27 = tile * kRed;
  float* table = smem + warp * T27;
  for (int e = lane; e < T27; e += 32) table[e] = 0.f;
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
          const float* d = dc + 6 * cam_t[q];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < 6; ++i) acc += w_prev[(i * 3 + j) * OL + q] * d[i];
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
        for (int c = 0; c < 18; ++c) w_out[c * OL + q] = 0.f;
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
        float r0 = (fx * x0 * inv_z + cx - uv_t[q]) * isig;
        float r1 = (fy * x1 * inv_z + cy - uv_t[OL + q]) * isig;
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
        if (in_tile && sw_free != 0.f) {  // fixed cameras' rows are exactly zero
          key = cam - cam0;
          int n = 0;
#pragma unroll
          for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = i; j < 6; ++j, ++n)
              rows[n] = Jc[0][i] * Jc[0][j] + Jc[1][i] * Jc[1][j];
#pragma unroll
          for (int i = 0; i < 6; ++i) rows[21 + i] = Jc[0][i] * r0 + Jc[1][i] * r1;
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
          for (int i = 0; i < 6; ++i)
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
  float* wcost = smem + nwb * T27;
  if (lane == 0) wcost[warp] = my_cost;
  __syncthreads();
  float* out = slab + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * (T27 + 1);
  for (int e = threadIdx.x; e < T27; e += blockDim.x) {
    float acc = smem[e];
    for (int w = 1; w < nwb; ++w) acc += smem[w * T27 + e];
    out[e] = acc;
  }
  if (threadIdx.x == 0) {
    float c = wcost[0];
    for (int w = 1; w < nwb; ++w) c += wcost[w];
    out[T27] = c;
  }
}

// red[k][n] and cost: entry e of the slabs of every block of its tile, in
// kParts strided partial sums (block b in part b % kParts, in increasing b),
// then the parts in order.
__global__ void dense_eval_finish(const float* __restrict__ slab, int blocks,
                                  int tile, int K, float* __restrict__ red,
                                  float* __restrict__ cost) {
  __shared__ float part[kParts][kEntries];
  const int el = threadIdx.x % kEntries, p = threadIdx.x / kEntries;
  const int e = blockIdx.x * kEntries + el;
  const int T27 = tile * kRed, n_red = K * kRed;
  float acc = 0.f;
  if (e <= n_red) {
    int j = 0, off = T27;  // the cost
    if (e < n_red) {
      const int k = e / kRed;
      j = k / tile;
      off = (k - j * tile) * kRed + e % kRed;
    }
    const float* base = slab + (long long)j * blocks * (T27 + 1) + off;
#pragma unroll 8
    for (int b = p; b < blocks; b += kParts) acc += base[(long long)b * (T27 + 1)];
  }
  part[p][el] = acc;
  __syncthreads();
  if (p == 0 && e <= n_red) {
    float sum = part[0][el];
    for (int i = 1; i < kParts; ++i) sum += part[i][el];
    if (e < n_red) red[e] = sum;
    else *cost = sum;
  }
}

// The trial landmarks alone, in the units kernel's lanes (S lanes a
// landmark, its slots summed lane by lane, then over the lanes by xor
// shuffles), so Xt_new has the same bits as the fused kernel's: the back-
// substitution pass of the camera-tiled case.
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
      const float* d = dc + 6 * cam_t[q];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) acc += w_prev[(i * 3 + j) * OL + q] * d[i];
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

template <bool kBS>
int launch_units(dim3 grid, int threads, size_t smem, cudaStream_t s,
                 const float* k4, const float* R, const float* t, const float* dc,
                 const int* cam_t, const float* uv_t, const float* isig_t,
                 const uint8_t* valid_t, const uint8_t* fixed_t, const float* Xt,
                 const float* w_prev, const float* vinv6, const float* gp_prev,
                 const uint8_t* pt_valid, int O, int L, int robust, int lanes_log2,
                 int tile, float* slab, float* vu, float* gp, float* w,
                 float* xt_new) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_eval_units<kBS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dense_eval_units<kBS><<<grid, threads, smem, s>>>(
      k4, R, t, dc, cam_t, uv_t, isig_t, valid_t, fixed_t, Xt, w_prev, vinv6,
      gp_prev, pt_valid, O, L, robust, lanes_log2, tile, slab, vu, gp, w, xt_new);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's numbers (dense_kernels.dense_eval_plan): lanes_log2 = log2 S,
// warps a block, blocks (grid.x; 0 when L = 0), tile T, n_tiles (grid.y);
// slab holds n_tiles * blocks * (27 T + 1) floats.
extern "C" int dense_eval_assemble(
    const void* k4, const void* R, const void* t, const void* dc,
    const void* cam_t, const void* uv_t, const void* isig_t,
    const void* valid_t, const void* fixed_t, const void* Xt,
    const void* w_prev, const void* vinv6, const void* gp_prev,
    const void* pt_valid, int O, int L, int K, int robust, int bs,
    int lanes_log2, int warps, int blocks, int tile, int n_tiles, void* slab,
    void* red, void* cost, void* vu, void* gp, void* w, void* xt_new,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0 && L > 0) {
    const size_t smem = ((size_t)warps * tile * kRed + warps) * sizeof(float);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    const dim3 grid(blocks, n_tiles);
    if (bs && n_tiles > 1) {
      // every tile needs the trial landmarks: form them once, then evaluate
      // there as the seed eval does
      const int units = (L + (32 >> lanes_log2) - 1) / (32 >> lanes_log2);
      dense_eval_backsub<<<(units + 3) / 4, 128, 0, s>>>(
          (const float*)dc, (const int*)cam_t, (const float*)Xt,
          (const float*)w_prev, (const float*)vinv6, (const float*)gp_prev,
          (const uint8_t*)pt_valid, O, L, lanes_log2, (float*)xt_new);
      Xt = xt_new;
      bs = 0;
    }
    const int code =
        bs ? launch_units<true>(
                 grid, warps * 32, smem, s, (const float*)k4, (const float*)R,
                 (const float*)t, (const float*)dc, (const int*)cam_t,
                 (const float*)uv_t, (const float*)isig_t, (const uint8_t*)valid_t,
                 (const uint8_t*)fixed_t, (const float*)Xt, (const float*)w_prev,
                 (const float*)vinv6, (const float*)gp_prev,
                 (const uint8_t*)pt_valid, O, L, robust, lanes_log2, tile,
                 (float*)slab, (float*)vu, (float*)gp, (float*)w, (float*)xt_new)
           : launch_units<false>(
                 grid, warps * 32, smem, s, (const float*)k4, (const float*)R,
                 (const float*)t, nullptr, (const int*)cam_t, (const float*)uv_t,
                 (const float*)isig_t, (const uint8_t*)valid_t,
                 (const uint8_t*)fixed_t, (const float*)Xt, nullptr, nullptr,
                 nullptr, nullptr, O, L, robust, lanes_log2, tile, (float*)slab,
                 (float*)vu, (float*)gp, (float*)w, nullptr);
    if (code != 0) return code;
  } else {
    blocks = 0;  // nothing to sum: red and cost are written as zeros
  }
  const int entries = K * kRed + 1;
  dense_eval_finish<<<(entries + kEntries - 1) / kEntries, kParts * kEntries, 0, s>>>(
      (const float*)slab, blocks, tile, K, (float*)red, (float*)cost);
  return (int)cudaGetLastError();
}
