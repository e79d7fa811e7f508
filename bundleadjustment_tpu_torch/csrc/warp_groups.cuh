// Per-camera sums without atomics, shared by kernel B (dense_eval.cu) and
// kernel D (schur_prepare.cu): the lanes of a warp that hold the same key (a
// camera of the block's camera tile) are summed by a fixed shuffle tree and
// added to the warp's own shared-memory table by the group's lowest lane.

#pragma once

#include <cuda_runtime.h>

constexpr unsigned kFull = 0xffffffffu;

// Sum v[N] over the lanes that hold the same key (>= 0) and add the sum into
// table[key][N] from the group's lowest lane. The sum is a tree over the
// group's lanes in lane order (pointer jumping), so the same inputs give the
// same bits; the groups of a warp hold distinct keys, so their lowest lanes
// add with plain loads and stores. Lanes with key < 0 add nothing.
template <int N>
__device__ __forceinline__ void group_add(float* table, int key, float (&v)[N],
                                          int lane) {
  const unsigned peers = __match_any_sync(kFull, key);
  const int maxg = __reduce_max_sync(kFull, key >= 0 ? __popc(peers) : 1);
  if (maxg > 1) {
    const unsigned above = lane == 31 ? 0u : peers & (kFull << (lane + 1));
    int nxt = above ? __ffs(above) - 1 : 32;  // the lane of rank + d, d = 1
    const int rank = __popc(peers & ((1u << lane) - 1u));
    for (int d = 1; d < maxg; d <<= 1) {
      const int src = nxt & 31;
      const bool take = (rank & (2 * d - 1)) == 0 && nxt < 32;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float x = __shfl_sync(kFull, v[n], src);
        if (take) v[n] += x;
      }
      const int nn = __shfl_sync(kFull, nxt, src);
      nxt = nxt < 32 ? nn : 32;
    }
    if (key < 0 || rank != 0) return;
  } else if (key < 0) {
    return;
  }
  float* row = table + key * N;
#pragma unroll
  for (int n = 0; n < N; ++n) row[n] += v[n];
}
