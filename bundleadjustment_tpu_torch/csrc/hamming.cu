// Hamming top-2 search over packed 256-bit binary descriptors (kernel A).
//
// Replaces the TPU kernel bundleadjustment_tpu/ops/pallas_matching.py:
// hamming_top2_pallas / _hamming_top2_kernel.
//
// What it computes, per query row q of one batch entry: the smallest and
// second-smallest Hamming distance to the VALID train rows and the index of
// the smallest, without ever materialising the [M1, M2] distance matrix.
// Contract (bit-identical to the Pallas kernel): `best` takes the lowest
// train index among equal minima; `second` may equal `best` when two rows
// tie; with no valid train row, idx = -1 and best = second = +inf.
//
// What bounds it on H100: integer throughput. Each query/train pair costs
// 8 XOR + 8 POPC + adds on 32 bytes that come from shared memory, so at
// M1 = M2 = 1000 the work is ~1e6 pairs * ~24 integer ops, far below any
// memory limit (the inputs are 32 KB per side).
//
// Design: one thread per query keeps its 8 descriptor words and its running
// (best, second, idx) in registers. The block walks the train set in tiles
// of 256 rows staged once in shared memory, where all threads of a warp read
// the same row (a broadcast, no bank conflicts). Rows are visited in
// increasing index order with strict `<`, which gives the lowest-index tie
// rule. grid.y is the batch axis (the keyframe neighbour search matches one
// query set against ~25 train sets in one launch); a query batch stride of 0
// shares one query set across the batch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kQueryTile = 128;
constexpr int kTrainTile = 256;

__global__ void hamming_top2_kernel(const uint32_t* __restrict__ q,
                                    long long q_bstride,
                                    const uint32_t* __restrict__ t,
                                    const uint8_t* __restrict__ tvalid,
                                    int m1, int m2,
                                    float* __restrict__ best_out,
                                    float* __restrict__ second_out,
                                    int* __restrict__ idx_out) {
  __shared__ uint32_t ts[kTrainTile * kWords];
  __shared__ uint8_t tv[kTrainTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kQueryTile + threadIdx.x;
  const bool active = qi < m1;
  const uint32_t* qb = q + (long long)b * q_bstride;
  const uint32_t* tb = t + (long long)b * m2 * kWords;
  const uint8_t* vb = tvalid + (long long)b * m2;

  uint32_t qw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) qw[w] = active ? qb[(long long)qi * kWords + w] : 0u;

  int best = INT_MAX, second = INT_MAX, idx = -1;
  for (int base = 0; base < m2; base += kTrainTile) {
    const int n = min(kTrainTile, m2 - base);
    for (int e = threadIdx.x; e < n * kWords; e += blockDim.x)
      ts[e] = tb[(long long)base * kWords + e];
    for (int e = threadIdx.x; e < n; e += blockDim.x) tv[e] = vb[base + e];
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        if (!tv[j]) continue;  // invalid train rows count as +inf
        int d = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) d += __popc(qw[w] ^ ts[j * kWords + w]);
        if (d < best) {
          second = best;
          best = d;
          idx = base + j;
        } else if (d < second) {
          second = d;
        }
      }
    }
    __syncthreads();
  }
  if (active) {
    const long long o = (long long)b * m1 + qi;
    best_out[o] = best == INT_MAX ? __int_as_float(0x7f800000) : (float)best;
    second_out[o] = second == INT_MAX ? __int_as_float(0x7f800000) : (float)second;
    idx_out[o] = idx;
  }
}

}  // namespace

extern "C" int hamming_top2(const void* q, long long q_bstride, const void* t,
                            const void* tvalid, int n_batch, int m1, int m2,
                            void* best, void* second, void* idx, void* stream) {
  if (n_batch <= 0 || m1 <= 0) return 0;
  dim3 grid((m1 + kQueryTile - 1) / kQueryTile, n_batch);
  hamming_top2_kernel<<<grid, kQueryTile, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)q, q_bstride, (const uint32_t*)t, (const uint8_t*)tvalid,
      m1, m2, (float*)best, (float*)second, (int*)idx);
  return (int)cudaGetLastError();
}
