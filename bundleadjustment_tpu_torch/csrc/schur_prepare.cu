// Schur prepare (kernel D): the per-iteration point-side math of the dense
// LM step, with G written to device memory for an outside Pf / Q Q^T
// product.
//
// Replaces the TPU kernel bundleadjustment_tpu/solvers/pallas_dense_eval.py:
// fused_schur_prepare / _schur_kernel, the reference's route for shapes its
// S kernel does not take (O > 64 on this port).
//
// Per landmark l, in point_prepare.cuh: the damped V (identity for invalid
// points), closed-form V^-1 -> vinv6 [6][L], lower chol(V^-1) = C,
// zv = V^-1 g_p -> zv [3][L]; then for every slot o: G[18][O][L] = W_o C
// (rows i*3 + m), and the rhs term W_o zv added to red6 [6][K] (row i,
// column cam_o: the (i, k) order of kernel C's rhs).
//
// What bounds it on H100: bytes. It reads W18 once and writes G once,
// 2 * 18 * O * L * 4 B (112 MB at 71 cameras / 10,842 landmarks / O = 72,
// ~33 us at 3.35 TB/s); ~120 flops per slot are far below the float32 rate.
//
// Design (the host plan dense_kernels.schur_prepare_plan picks the numbers):
// - Work unit: 32 consecutive landmarks, a lane each, over a chunk of
//   `slots` consecutive slots, so a warp's loads of W and stores of G are 32
//   consecutive floats of a row (L is the fastest axis). A landmark's O slots
//   are cut into `chunks` chunks, so that short maps (~1,000 landmarks) and
//   long tracks (O = 72) both give the card enough warps to keep the loads
//   in flight; each unit solves its landmarks' point blocks again (9 loads
//   and ~60 flops a lane, the same arithmetic, so the same bits), and the
//   unit of chunk 0 writes zv and vinv6. A grid of at most ~32 warps an SM
//   walks the units (rounds).
// - red6 without atomics: after each slot the lanes are grouped by camera
//   (__match_any_sync, warp_groups.cuh) and each group's six terms are summed
//   by a shuffle tree in lane order into the warp's own [T][6] table in
//   shared memory. At the end a block sums its warps' tables in warp order
//   into a slab of its own, and schur_prepare_finish sums the slabs of each
//   entry in a fixed order (16 strided partial sums, then those in order).
//   So red6 is the same bits from run to run, and every entry is written:
//   no zeroing launch. Slots whose W is all zero (invalid or fixed-camera
//   observations) add nothing to red6; their G is written (exactly zero).
// - Large K: the cameras are cut into n_tiles tiles of T (the plan), grid.y
//   the tile. The blocks of tile 0 write G, zv and vinv6 and sum the terms of
//   their tile's cameras; those of the other tiles read a slot's W only
//   where its camera lies in their tile.
// G, zv and vinv6 are per landmark and round as the plain version does
// (--fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

#include "point_prepare.cuh"
#include "warp_groups.cuh"

namespace {

constexpr int kRows = 6;      // red6 rows: a camera's rhs terms
constexpr int kParts = 16;    // schur_prepare_finish: partial sums an entry
constexpr int kEntries = 16;  // schur_prepare_finish: entries a block
constexpr int kMaxSmem = 232448;

__global__ void schur_prepare_units(const float* __restrict__ lam_ptr,
                                    const float* __restrict__ Vu,
                                    const float* __restrict__ g_p,
                                    const uint8_t* __restrict__ pt_valid,
                                    const float* __restrict__ W18,
                                    const int* __restrict__ cam_t, int O, int L,
                                    int slots, int chunks, int tile,
                                    float* __restrict__ slab,
                                    float* __restrict__ G_out,
                                    float* __restrict__ zv_out,
                                    float* __restrict__ vinv_out) {
  extern __shared__ float smem[];  // [warps][tile * 6] tables
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwb = blockDim.x >> 5;
  const int T6 = tile * kRows;
  float* table = smem + warp * T6;
  {  // zero the tables, in float4 where the count allows
    const int n = nwb * T6, n4 = n / 4;
    float4* s4 = reinterpret_cast<float4*>(smem);
    for (int e = threadIdx.x; e < n4; e += blockDim.x) s4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = 4 * n4 + threadIdx.x; e < n; e += blockDim.x) smem[e] = 0.f;
  }
  __syncthreads();

  const int cam0 = blockIdx.y * tile;
  const bool primary = blockIdx.y == 0;  // writes G, zv and vinv6
  const long long OL = (long long)O * L;
  const int units = (L + 31) / 32 * chunks;
  const float lam = *lam_ptr;

  for (int u = blockIdx.x * nwb + warp; u < units; u += gridDim.x * nwb) {
    const int c = u % chunks;
    const int l = u / chunks * 32 + lane;
    const bool act = l < L;
    PointPrep p;
    if (act) {
      p = point_solve(lam, Vu, g_p, pt_valid, l, L);
      if (primary && c == 0) point_store(p, l, L, zv_out, vinv_out);
    }
    const int o_end = min(O, (c + 1) * slots);
    for (int o = c * slots; o < o_end; ++o) {  // the same slots in every lane
      const long long s = (long long)o * L + l;
      int key = -1;
      float wz[kRows] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (act && primary) {  // W's loads do not wait for the camera's
        float W[18], G[6][3];
        const bool any = load_w_g(W18, OL, s, p.C, W, G);
        const int cam = cam_t[s];
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int m = 0; m < 3; ++m) G_out[(i * 3 + m) * OL + s] = G[i][m];
        if (any && cam < tile) {
          key = cam;
#pragma unroll
          for (int i = 0; i < kRows; ++i) wz[i] = w_zv(W, p.zv, i);
        }
      } else if (act) {
        const int cam = cam_t[s];
        if (cam >= cam0 && cam < cam0 + tile) {
          float W[18], G[6][3];
          if (load_w_g(W18, OL, s, p.C, W, G)) {
            key = cam - cam0;
#pragma unroll
            for (int i = 0; i < kRows; ++i) wz[i] = w_zv(W, p.zv, i);
          }
        }
      }
      if (__any_sync(kFull, key >= 0)) group_add(table, key, wz, lane);
    }
  }

  // the block's slab: its warps' tables, summed in warp order (in float4
  // where 6T is a multiple of 4)
  __syncthreads();
  float* out = slab + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * T6;
  if (T6 % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(smem);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int e = threadIdx.x; e < T6 / 4; e += blockDim.x) {
      float4 acc = s4[e];
      for (int w = 1; w < nwb; ++w) {
        const float4 x = s4[w * (T6 / 4) + e];
        acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
      }
      o4[e] = acc;
    }
  } else {
    for (int e = threadIdx.x; e < T6; e += blockDim.x) {
      float acc = smem[e];
      for (int w = 1; w < nwb; ++w) acc += smem[w * T6 + e];
      out[e] = acc;
    }
  }
}

// red6[i][k]: entry (k, i) of the slabs of every block of its tile, in
// kParts strided partial sums (block b in part b % kParts, in increasing b),
// then the parts in order.
__global__ void schur_prepare_finish(const float* __restrict__ slab, int blocks,
                                     int tile, int K, float* __restrict__ red6) {
  __shared__ float part[kParts][kEntries];
  const int el = threadIdx.x % kEntries, p = threadIdx.x / kEntries;
  const int e = blockIdx.x * kEntries + el;  // k * 6 + i
  const int T6 = tile * kRows;
  float acc = 0.f;
  if (e < K * kRows) {
    const int k = e / kRows, j = k / tile;
    const float* base = slab + (long long)j * blocks * T6 + (k - j * tile) * kRows +
                        e % kRows;
#pragma unroll 8
    for (int b = p; b < blocks; b += kParts) acc += base[(long long)b * T6];
  }
  part[p][el] = acc;
  __syncthreads();
  if (p == 0 && e < K * kRows) {
    float sum = part[0][el];
    for (int i = 1; i < kParts; ++i) sum += part[i][el];
    red6[(e % kRows) * K + e / kRows] = sum;
  }
}

}  // namespace

// The plan's numbers (dense_kernels.schur_prepare_plan): slots a unit,
// chunks a landmark, warps a block, blocks (grid.x; 0 when L = 0), tile T,
// n_tiles (grid.y); slab holds n_tiles * blocks * 6 T floats.
extern "C" int schur_prepare(const void* lam, const void* Vu, const void* g_p,
                             const void* pt_valid, const void* W18,
                             const void* cam_t, int O, int L, int K, int slots,
                             int chunks, int warps, int blocks, int tile,
                             int n_tiles, void* slab, void* G, void* zv,
                             void* vinv6, void* red6, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0 && L > 0) {
    const size_t smem = (size_t)warps * tile * kRows * sizeof(float);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          schur_prepare_units, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    schur_prepare_units<<<dim3(blocks, n_tiles), warps * 32, smem, s>>>(
        (const float*)lam, (const float*)Vu, (const float*)g_p,
        (const uint8_t*)pt_valid, (const float*)W18, (const int*)cam_t, O, L,
        slots, chunks, tile, (float*)slab, (float*)G, (float*)zv, (float*)vinv6);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else {
    blocks = 0;  // nothing to sum: red6 is written as zeros
  }
  const int entries = K * kRows;
  schur_prepare_finish<<<(entries + kEntries - 1) / kEntries, kParts * kEntries, 0, s>>>(
      (const float*)slab, blocks, tile, K, (float*)red6);
  return (int)cudaGetLastError();
}
