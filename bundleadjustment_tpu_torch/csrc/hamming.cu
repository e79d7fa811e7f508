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
// What bounds it on H100: the popcounts. Each query/train pair costs 8 XOR,
// 8 POPC and adds on 32 bytes that come from shared memory; POPC issues at
// 16 a clock on an SM, so at M1 = M2 = 1000 one batch entry needs ~2 us of
// the whole card, and the inputs are 32 KB a side.
//
// Design (the host plan ops/hamming.py:hamming_plan picks the numbers):
// - The train axis is split: block (query tile, train chunk, batch entry)
//   stages its chunk of rows in shared memory, and its four warps walk
//   four consecutive quarters of it. At M1 = 1000, B = 1 that is 16 query
//   tiles x 16 chunks = 256 blocks for 132 SMs, where one block a query
//   tile gave 8.
// - Each lane keeps kQpt queries (descriptor words and running top-2) in
//   registers, so a train row read once from shared memory (a broadcast:
//   every lane reads the same row) serves kQpt queries. The top-2 update is
//   branch-free (compare and select).
// - Merging, in increasing train order, keeps the contract bit for bit: a
//   later piece's best replaces the running one only if strictly smaller
//   (lowest index among equal minima), and second = min(the loser's best,
//   the other's second), so a tie across two pieces gives second == best,
//   and a piece without a valid row (best = INT_MAX, idx = -1) changes
//   nothing. The warps' quarters are merged in warp order in shared memory;
//   with several chunks each writes its top-2 to a scratch plane and
//   hamming_merge folds the chunks in chunk order (all of a query's chunks
//   loaded at once, then folded from shared memory).
// grid.z is the batch axis (the keyframe neighbour search matches one
// query set against ~25 train sets in one launch); a query batch stride of 0
// shares one query set across the batch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kWarps = 4;
constexpr int kQpt = 2;               // queries a lane
constexpr int kQTile = 32 * kQpt;     // queries a block
constexpr int kChunkMax = 1024;       // train rows a block stages

__device__ __forceinline__ void merge(int& b1, int& s1, int& i1, int b2, int s2,
                                      int i2) {
  const bool lt = b2 < b1;
  s1 = lt ? min(b1, s2) : min(s1, b2);
  i1 = lt ? i2 : i1;
  b1 = lt ? b2 : b1;
}

__device__ __forceinline__ float as_dist(int d) {
  return d == INT_MAX ? __int_as_float(0x7f800000) : (float)d;
}

__global__ void __launch_bounds__(kWarps * 32) hamming_chunks(
    const uint32_t* __restrict__ q, long long q_bstride,
    const uint32_t* __restrict__ t, const uint8_t* __restrict__ tvalid, int m1,
    int m2, int chunk, int n_chunks, float* __restrict__ best_out,
    float* __restrict__ second_out, int* __restrict__ idx_out,
    int* __restrict__ part) {
  __shared__ uint4 ts[kChunkMax * 2];
  __shared__ uint8_t tv[kChunkMax];
  __shared__ int mb[kWarps][kQTile], ms[kWarps][kQTile], mi[kWarps][kQTile];
  const int b = blockIdx.z, c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = c * chunk, n = min(chunk, m2 - row0);
  const uint4* tb = reinterpret_cast<const uint4*>(t + ((long long)b * m2 + row0) * kWords);
  for (int e = threadIdx.x; e < 2 * n; e += blockDim.x) ts[e] = tb[e];
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    tv[e] = tvalid[(long long)b * m2 + row0 + e];

  uint32_t qw[kQpt][kWords];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = blockIdx.x * kQTile + i * 32 + lane;
    const uint4* qr = reinterpret_cast<const uint4*>(
        q + (long long)b * q_bstride + (long long)min(qi, m1 - 1) * kWords);
    const uint4 lo = qr[0], hi = qr[1];
    qw[i][0] = lo.x; qw[i][1] = lo.y; qw[i][2] = lo.z; qw[i][3] = lo.w;
    qw[i][4] = hi.x; qw[i][5] = hi.y; qw[i][6] = hi.z; qw[i][7] = hi.w;
  }
  __syncthreads();

  int best[kQpt], second[kQpt], idx[kQpt];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    best[i] = INT_MAX;
    second[i] = INT_MAX;
    idx[i] = -1;
  }
  const int sub = (n + kWarps - 1) / kWarps;
  const int r0 = warp * sub, r1 = min(n, r0 + sub);
  for (int j = r0; j < r1; ++j) {  // increasing train index
    const uint4 lo = ts[2 * j], hi = ts[2 * j + 1];
    const bool ok = tv[j] != 0;  // invalid train rows count as +inf
#pragma unroll
    for (int i = 0; i < kQpt; ++i) {
      int d = __popc(qw[i][0] ^ lo.x) + __popc(qw[i][1] ^ lo.y) +
              __popc(qw[i][2] ^ lo.z) + __popc(qw[i][3] ^ lo.w) +
              __popc(qw[i][4] ^ hi.x) + __popc(qw[i][5] ^ hi.y) +
              __popc(qw[i][6] ^ hi.z) + __popc(qw[i][7] ^ hi.w);
      d = ok ? d : INT_MAX;
      const bool lt = d < best[i];
      second[i] = lt ? best[i] : min(second[i], d);
      idx[i] = lt ? row0 + j : idx[i];
      best[i] = lt ? d : best[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    mb[warp][i * 32 + lane] = best[i];
    ms[warp][i * 32 + lane] = second[i];
    mi[warp][i * 32 + lane] = idx[i];
  }
  __syncthreads();
  if (threadIdx.x < kQTile) {
    const int k = threadIdx.x, qi = blockIdx.x * kQTile + k;
    int b1 = mb[0][k], s1 = ms[0][k], i1 = mi[0][k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) merge(b1, s1, i1, mb[w][k], ms[w][k], mi[w][k]);
    if (qi < m1) {
      if (n_chunks == 1) {
        const long long o = (long long)b * m1 + qi;
        best_out[o] = as_dist(b1);
        second_out[o] = as_dist(s1);
        idx_out[o] = i1;
      } else {
        const long long P = (long long)gridDim.z * n_chunks * m1;
        const long long o = ((long long)b * n_chunks + c) * m1 + qi;
        part[o] = b1;
        part[P + o] = s1;
        part[2 * P + o] = i1;
      }
    }
  }
}

// The chunks' top-2s of one (batch entry, query), folded in chunk order.
// A block takes kMergeQ queries; its threads load kMergeC chunks of each at
// once (one load round trip a pass), and one thread a query folds them from
// shared memory.
constexpr int kMergeQ = 16, kMergeC = 16;

__global__ void hamming_merge(const int* __restrict__ part, int n_batch, int m1,
                              int n_chunks, float* __restrict__ best_out,
                              float* __restrict__ second_out,
                              int* __restrict__ idx_out) {
  __shared__ int sb[kMergeC][kMergeQ], ss[kMergeC][kMergeQ], si[kMergeC][kMergeQ];
  const int ql = threadIdx.x % kMergeQ, cl = threadIdx.x / kMergeQ;
  const long long i = (long long)blockIdx.x * kMergeQ + ql;
  const bool act = i < (long long)n_batch * m1;
  const long long b = act ? i / m1 : 0, qi = act ? i % m1 : 0;
  const long long P = (long long)n_batch * n_chunks * m1;
  int b1 = INT_MAX, s1 = INT_MAX, i1 = -1;
  for (int c0 = 0; c0 < n_chunks; c0 += kMergeC) {
    const int c = c0 + cl;
    int vb = INT_MAX, vs = INT_MAX, vi = -1;
    if (act && c < n_chunks) {
      const long long o = (b * n_chunks + c) * m1 + qi;
      vb = part[o];
      vs = part[P + o];
      vi = part[2 * P + o];
    }
    sb[cl][ql] = vb;
    ss[cl][ql] = vs;
    si[cl][ql] = vi;
    __syncthreads();
    if (cl == 0)
#pragma unroll
      for (int k = 0; k < kMergeC; ++k) merge(b1, s1, i1, sb[k][ql], ss[k][ql], si[k][ql]);
    __syncthreads();
  }
  if (cl == 0 && act) {
    best_out[i] = as_dist(b1);
    second_out[i] = as_dist(s1);
    idx_out[i] = i1;
  }
}

}  // namespace

// chunk, n_chunks: the plan's (ops/hamming.py:hamming_plan; chunk <= 1024);
// part holds 3 n_batch n_chunks m1 ints when n_chunks > 1. q and t must be
// 16-byte aligned.
extern "C" int hamming_top2(const void* q, long long q_bstride, const void* t,
                            const void* tvalid, int n_batch, int m1, int m2,
                            int chunk, int n_chunks, void* part, void* best,
                            void* second, void* idx, void* stream) {
  if (n_batch <= 0 || m1 <= 0 || m2 <= 0) return 0;
  if (chunk <= 0 || chunk > kChunkMax || (long long)chunk * n_chunks < m2 ||
      (n_chunks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((m1 + kQTile - 1) / kQTile, n_chunks, n_batch);
  hamming_chunks<<<grid, kWarps * 32, 0, s>>>(
      (const uint32_t*)q, q_bstride, (const uint32_t*)t, (const uint8_t*)tvalid,
      m1, m2, chunk, n_chunks, (float*)best, (float*)second, (int*)idx,
      (int*)part);
  if (n_chunks > 1) {
    const long long n = (long long)n_batch * m1;
    hamming_merge<<<(unsigned)((n + kMergeQ - 1) / kMergeQ), kMergeQ * kMergeC, 0, s>>>(
        (const int*)part, n_batch, m1, n_chunks, (float*)best, (float*)second,
        (int*)idx);
  }
  return (int)cudaGetLastError();
}
