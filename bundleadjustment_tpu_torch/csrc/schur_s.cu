// Schur-S with the folded damped U block (kernel C), and its unfolded
// partial (K5): one pass over tiles of S, then one pass that sums, folds
// and writes S in (i, k) order.
//
// Replaces the TPU kernel bundleadjustment_tpu/solvers/pallas_dense_eval.py:
// fused_schur_prepare_s / _schur_s_kernel, held to its float32 path
// (s_bf16=False):
// - schur_prepare_s: fold_u=True (red27 and cam_fixed given), the
//   single-device path;
// - schur_qqt_partial: fold_u=False, the per-shard term of the sharded
//   engine, which all-reduces it and adds the replicated U outside.
//
// Per landmark l, in point_prepare.cuh: V = Vu damped as
// diag * (1 + lam * clip(diag, 1e-6)), identity for invalid points;
// closed-form V^-1 -> vinv6; lower chol(V^-1) = C; zv = V^-1 g_p; for each
// valid observation slot o, G_o = W_o C (6x3) and the rhs term W_o zv at
// camera cam_o; for every ordered pair of its slots (o, o') the 6x6 block
// G_o G_o'^T at cameras (cam_o, cam_o').
// Kernel C outputs S = U_damped_embed + 1e-8 I - Q Q^T and
// b = -(g_c - sum W zv), with U's fixed-camera blocks and g_c's
// fixed-camera rows replaced by identity / zero, as the reference emits
// them. K5 outputs S_qqt = +Q Q^T and red6 [6][K] = sum W zv. Both in (i, k)
// row order (row i*K + k); the order is internal to the solve, which folds U
// in (i, k) order for every route (dense_kernels.damped_system). Q Q^T is
// summed here, in the kernel body, as in the reference; no library GEMM.
//
// The camera width P is a template parameter: 6 (the pinhole model, the
// numbers below) or 9 (BAL's camera, dense_ba.CAMERA_WIDTH): PxP blocks of
// G_o G_o'^T, W_o of 3P floats a slot, S of (PK)^2 floats, red of
// P (P + 1) / 2 + P rows a camera. Each camera takes P rows and, in the
// shared tile and the rhs rows, P columns at a stride of P rounded up to
// even (kPc: 6, or 10 with one column of zeros), so a camera's entries of a
// row start 8 bytes aligned for add_row's 64-bit compare-and-swaps.
//
// The bound on H100: bytes. W18 (72 bytes a slot), cam_t, Vu and g_p read
// once, S (36 K^2 floats), b, zv and vinv6 written once: 0.021 ms at
// 128c/100k/O=8 and 0.018 ms at 71c/10,842/O=72. The operations, 216 a slot
// pair (36 entries of G_o G_o'^T, 3 multiplies and 2 adds each, and the add
// into S) plus the prepare, need less on the float32 CUDA cores.
//
// Design, against the four causes that held the one-thread-per-landmark
// kernel at 57x its bound:
// - Global atomics: none. The cameras are cut into tiles of T (the host
//   plan, dense_kernels.schur_s_plan, picks T so a 6T x 6T float tile and
//   the staged slots sit in shared memory: one tile up to K = 32-35).
//   Block (tile pair I <= J, landmark chunk c) adds G_o G_o'^T for the slot
//   pairs with cam_o in I and cam_o' in J (all ordered pairs when I == J)
//   into its shared tile and writes the tile to a scratch slab of its own;
//   the diagonal pairs' blocks also sum W zv. A second kernel
//   (schur_finish) sums each tile's chunk slabs in chunk order, folds in
//   the damped U and 1e-8 I (C) or nothing (K5), writes the upper tile
//   pairs to S and mirrors them into the lower ones.
// - Contention: a landmark seen by every camera adds into a block's own
//   shared tile, not into one global S. A float atomicAdd on shared memory
//   is a compare-and-swap loop on this card (ATOMS.CAST.SPIN, also for
//   red.shared.add.f32), one entry after the other, so a lane adds a row
//   of six entries as three 64-bit compare-and-swaps in flight at once
//   (add6); only a pair whose swap lost a race is added again. The W zv
//   terms go to one rhs row per warp, summed at the end.
// - Load imbalance: a warp takes up to four landmarks at once and spreads
//   their (slot pair, row) items over its 32 lanes (a 71-slot track is
//   5,041 ordered pairs); landmarks go to chunks round-robin in units of
//   32, so the heavy landmarks of a map spread over every chunk whatever
//   their order; a block scans its units and queues only the landmarks
//   with slots in both I and J; the grid (pairs x chunks) is at most two
//   waves of one block an SM, the diagonal pairs first.
// - Repeated loads: G_o = W_o C (and W_o zv) is computed once per slot a
//   block needs and staged in shared memory, neighbouring threads loading
//   neighbouring landmarks; every pair reads it from there (odd stride; a
//   camera-major tile whose rows are 8-byte aligned and 2 banks apart).
// What is left (chip_smoke.py, 128c/100k/O=8 with random camera subsets):
// a landmark touches 2.6 of the 4 tiles, so 5 of the 10 tile pairs stage
// and pair it, each visit with a few items; the time goes to those visits'
// latency chains (scan, staging loads, compare-and-swaps), not to bytes.
// Float32 on the CUDA cores: each S entry is an explicit fmaf chain; no
// TF32. zv and vinv6 come from point_prepare.cuh's arithmetic (the library
// is built with --fmad=false), written once per landmark by the blocks of
// tile pair (0, 0), and are the same in every call. Two calls do NOT give
// bit-identical S and rhs: the warps of a block add into shared entries in
// an order that changes from run to run (the chunk sums of the second pass
// are in a fixed order). The damped U and lam are read on the device: no
// host sync.

#include <cstdint>
#include <cuda_runtime.h>

#include "point_prepare.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kUnit = 32;  // landmarks a scan unit: l is in chunk (l / 32) % chunks
constexpr unsigned kFull = 0xffffffffu;

// floats a staged slot: G (3P), W zv (P), 1 pad (an odd stride): 25 at P = 6
__host__ __device__ constexpr int gs_floats(int P) { return 4 * P + 1; }
// a camera's columns in the tile and the rhs rows: P rounded up to even
__host__ __device__ constexpr int cols_of(int P) { return P + (P & 1); }
// rows of red a camera, and entry (i, j) of a PxP block in its upper triangle
__host__ __device__ constexpr int n_red(int P) { return P * (P + 1) / 2 + P; }
__device__ __forceinline__ int sym_idx(int i, int j, int P) {
  if (i > j) {
    const int x = i;
    i = j;
    j = x;
  }
  return i * P - i * (i - 1) / 2 + (j - i);
}

// Whether the staged slots of a batch are compact (width 9): a landmark's
// member slots one after the other, so a batch holds as many landmarks as
// their members fill `slots`. The O-dense layout of width 6 (landmark k's
// slot o at k O + o) holds slots / O landmarks a batch: 6 at O = 56, where
// the tracks average 5.5 members.
__host__ __device__ constexpr bool compact_of(int P) { return P == 9; }

// Dynamic shared memory of schur_tiles at tile size T with `slots` staged
// observation slots, O slots a landmark and camera width P;
// dense_kernels.schur_tile_bytes computes the same: the PT x (kPc T + 2)
// tile, a [kPc T] rhs row a warp, the staged slots (gs_floats floats, a
// uint16 in each of the two pair lists and a tile-local camera), per scanned
// landmark its index, its queue entry and two slot masks of ceil(O / 32)
// words, the warps' counts, and (compact) the queue's member offsets.
__host__ __device__ inline long long tile_smem_bytes(int T, int slots, int O, int P) {
  const long long n = (long long)P * T, nc = (long long)cols_of(P) * T;
  const long long mw = (O + 31) / 32;
  return 4LL * (n * (nc + 2) + kWarps * nc + (long long)slots * gs_floats(P) +
                kWarps * kUnit * (2 + 2 * mw) + kWarps + 1 +
                (compact_of(P) ? kWarps * kUnit + 1 : 0)) +
         5LL * slots;
}

// Tile pair p: the nt diagonal pairs (p, p) first, then the pairs I < J in
// row-major order.
__device__ inline void pair_of(int p, int nt, int& I, int& J) {
  if (p < nt) {
    I = J = p;
    return;
  }
  p -= nt;
  I = 0;
  while (p >= nt - 1 - I) {
    p -= nt - 1 - I;
    ++I;
  }
  J = I + 1 + p;
}

// x[j] += v[j], j < kN (even), in shared memory, x 8-byte aligned: kN / 2
// 64-bit loads, then kN / 2 64-bit compare-and-swaps in flight at once (a
// float atomicAdd on shared memory is a compare-and-swap loop on this card,
// one entry after the other); a pair whose swap lost a race to another
// thread is added again with atomicAdd.
template <int kN>
__device__ __forceinline__ void add_row(float* x, const float (&v)[kN]) {
  constexpr int kH = kN / 2;
  unsigned long long* x2 = reinterpret_cast<unsigned long long*>(x);
  unsigned long long cur[kH], prev[kH];
#pragma unroll
  for (int j = 0; j < kH; ++j) cur[j] = x2[j];
#pragma unroll
  for (int j = 0; j < kH; ++j) {
    const float lo = __uint_as_float((unsigned)cur[j]) + v[2 * j];
    const float hi = __uint_as_float((unsigned)(cur[j] >> 32)) + v[2 * j + 1];
    prev[j] = atomicCAS(x2 + j, cur[j],
                        (unsigned long long)__float_as_uint(hi) << 32 | __float_as_uint(lo));
  }
#pragma unroll
  for (int j = 0; j < kH; ++j)
    if (prev[j] != cur[j]) {
      atomicAdd(x + 2 * j, v[2 * j]);
      atomicAdd(x + 2 * j + 1, v[2 * j + 1]);
    }
}

// Pass 1: block (tile pair p, chunk c). The shared tile is camera-major:
// row a*P + i, column b*kPc + i2 for cameras I0 + a, J0 + b. The block walks
// its chunk's landmarks, 16 units of 32 at a time:
// 1. scan: lane = landmark, reads its cam_t column into two slot masks
//    (camera in I, camera in J); the landmarks with slots in both go to a
//    queue in landmark order (the blocks of pair 0 also write zv and vinv6
//    of every landmark of the chunk);
// 2. stage each batch of queued landmarks: a thread takes one slot of one
//    landmark, neighbouring threads neighbouring landmarks at the same
//    slot, so the loads of W, cam_t, Vu and g_p share sectors; G = W C and
//    W zv go to shared memory, and the slot into the pair lists A (I) and
//    B (J) at the places its masks give;
// 3. accumulate, a warp on up to four landmarks at once: the lanes take
//    their (slot pair a in A, b in B, row i) items and add the row of
//    G_a G_b^T into the tile, P entries by add_row; the diagonal pairs also
//    add W zv of the A slots into the warp's rhs row.
// Then the tile and the sum of the rhs rows go to the block's scratch slabs
// in (i, k) order.
template <int kP>
__global__ void __launch_bounds__(kThreads, 1)
    schur_tiles(const float* __restrict__ lam_ptr, const float* __restrict__ Vu,
                const float* __restrict__ g_p,
                const uint8_t* __restrict__ pt_valid,
                const float* __restrict__ W18, const int* __restrict__ cam_t,
                const uint8_t* __restrict__ valid_t,
                int O, int L, int T, int nt, int chunks, int slots,
                float* __restrict__ Sp, float* __restrict__ Rp,
                float* __restrict__ zv_out, float* __restrict__ vinv_out) {
  constexpr int kGs = gs_floats(kP), kPc = cols_of(kP);
  constexpr bool kCompact = compact_of(kP);
  extern __shared__ float smem[];
  const int n6 = kP * T, nc = kPc * T, ld = nc + 2, MW = (O + 31) / 32;
  float* tile = smem;
  float* rhs = tile + n6 * ld;
  float* Gs = rhs + kWarps * nc;
  int* lmk = reinterpret_cast<int*>(Gs + slots * kGs);  // scan lane's landmark
  int* queue = lmk + kWarps * kUnit;                     // scan lanes with work
  unsigned* maskA = reinterpret_cast<unsigned*>(queue + kWarps * kUnit);
  unsigned* maskB = maskA + kWarps * kUnit * MW;
  int* wcount = reinterpret_cast<int*>(maskB + kWarps * kUnit * MW);
  // compact: base[e], the members of queue entries 0..e-1
  int* base = wcount + kWarps + 1;
  uint16_t* lists = reinterpret_cast<uint16_t*>(base + (kCompact ? kWarps * kUnit + 1 : 0));
  uint8_t* camloc = reinterpret_cast<uint8_t*>(lists + 2 * slots);

  const int p = blockIdx.x / chunks, c = blockIdx.x % chunks;
  int I, J;
  pair_of(p, nt, I, J);
  const bool diag = I == J, writer = p == 0;
  const int I0 = I * T, J0 = J * T;
  const bool pad_bytes = valid_t != nullptr && (I == 0 || J == 0);
  for (int e = threadIdx.x; e < n6 * ld + kWarps * nc; e += kThreads) smem[e] = 0.f;

  const float lam = *lam_ptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;  // lanes under this one
  const int BL = slots / max(O, 1);        // landmarks a batch
  const long long OL = (long long)O * L;
  const long long n_units = (L + kUnit - 1) / kUnit;
  const int me = warp * kUnit + lane;  // this lane's scan entry

  for (long long j0 = 0; c + chunks * j0 < n_units; j0 += kWarps) {
    // 1. scan
    const long long u = c + chunks * (j0 + warp);
    const long long l = u * kUnit + lane;
    const bool has_l = u < n_units && l < L;
    bool inI = false, inJ = false;
    for (int w = 0; w < MW; ++w) {
      unsigned mA = 0u, mB = 0u;
      for (int o0 = w * 32; has_l && o0 < min(O, w * 32 + 32); o0 += 8) {
        int cams[8];  // eight loads in flight, then the tests
        bool held[8];  // valid_t's bytes, where a tile holds camera 0
#pragma unroll
        for (int j = 0; j < 8; ++j)
          cams[j] = o0 + j < O ? cam_t[(long long)(o0 + j) * L + l] : -1;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          held[j] = pad_bytes && o0 + j < O && valid_t[(long long)(o0 + j) * L + l] != 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cam = cams[j];
          bool i_in = (unsigned)(cam - I0) < (unsigned)T;
          bool j_in = (unsigned)(cam - J0) < (unsigned)T;
          if ((i_in || j_in) && cam == 0) {
            // camera 0 is also the padding's: count the slot only if it
            // holds an observation (valid_t, where given: one byte, loaded
            // with the slots' cameras), else only if its W is not all zero
            const long long s = (long long)(o0 + j) * L + l;
            bool nz = false;
            if (valid_t != nullptr) {
              nz = held[j];
            } else {
#pragma unroll
              for (int e = 0; e < 3 * kP; ++e) nz |= W18[e * OL + s] != 0.f;
            }
            i_in &= nz;
            j_in &= nz;
          }
          mA |= (unsigned)i_in << (o0 + j - w * 32);
          mB |= (unsigned)j_in << (o0 + j - w * 32);
        }
      }
      maskA[me * MW + w] = mA;
      maskB[me * MW + w] = mB;
      inI |= mA != 0u;
      inJ |= mB != 0u;
    }
    lmk[me] = (int)l;
    if (has_l && writer)
      point_store(point_solve(lam, Vu, g_p, pt_valid, (int)l, L), (int)l, L,
                  zv_out, vinv_out);
    const unsigned work = __ballot_sync(kFull, has_l && inI && inJ);
    if (lane == 0) wcount[warp] = __popc(work);
    __syncthreads();
    int offset = 0, total = 0;
    for (int v = 0; v < kWarps; ++v) {
      offset += v < warp ? wcount[v] : 0;
      total += wcount[v];
    }
    if (work & (1u << lane)) queue[offset + __popc(work & below)] = me;
    __syncthreads();
    if (kCompact) {
      if (warp == 0) {  // base: the queue's member counts, summed in order
        int carry = 0;
        if (lane == 0) base[0] = 0;
        for (int q0 = 0; q0 < total; q0 += 32) {
          int m = 0;
          if (q0 + lane < total) {
            const int q = queue[q0 + lane];
            for (int v = 0; v < MW; ++v) m += __popc(maskA[q * MW + v] | maskB[q * MW + v]);
          }
          for (int d = 1; d < 32; d <<= 1) {
            const int x = __shfl_up_sync(kFull, m, d);
            if (lane >= d) m += x;
          }
          if (q0 + lane < total) base[q0 + lane + 1] = carry + m;
          carry += __shfl_sync(kFull, m, 31);
        }
      }
      __syncthreads();
    }

    for (int b0 = 0, nb = 0; b0 < total; b0 += nb) {
      if (kCompact) {  // the most landmarks whose members fit `slots` (one at least)
        int lo = b0 + 1, hi = total;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (base[mid] - base[b0] <= slots) lo = mid;
          else hi = mid - 1;
        }
        nb = lo - b0;
      } else {
        nb = min(BL, total - b0);
      }
      // a landmark's member lists: compact, at its first member's place in
      // each of two lists of `slots`; else [2k][O] and [2k + 1][O]
      auto list_a = [&](int k) -> uint16_t* {
        return kCompact ? lists + (base[b0 + k] - base[b0]) : lists + 2 * k * O;
      };
      auto list_b = [&](int k) -> uint16_t* {
        return kCompact ? lists + slots + (base[b0 + k] - base[b0]) : lists + (2 * k + 1) * O;
      };
      // 2. stage: thread f takes slot o = f / nb of landmark k = f % nb, so
      // neighbouring lanes load neighbouring landmarks' values
      for (int f = threadIdx.x; f < O * nb; f += kThreads) {
        const int o = f / nb, k = f - o * nb;
        const int q = queue[b0 + k], w = o >> 5;
        const unsigned bit = 1u << (o & 31);
        const unsigned* qa = maskA + q * MW;
        const unsigned* qb = maskB + q * MW;
        const bool mI = qa[w] & bit, mJ = qb[w] & bit;
        if (!(mI || mJ)) continue;
        const int lk = lmk[q];
        const long long s = (long long)o * L + lk;
        const int cam = cam_t[s];
        const PointPrep pp = point_solve(lam, Vu, g_p, pt_valid, lk, L);
        float W[3 * kP], G[kP][3];
        load_w_g<kP>(W18, OL, s, pp.C, W, G);  // an all-zero W stages zeros
        int pos = k * O + o;
        if (kCompact) {  // after the landmark's member slots before it
          int rm = __popc((qa[w] | qb[w]) & (bit - 1));
          for (int v = 0; v < w; ++v) rm += __popc(qa[v] | qb[v]);
          pos = base[b0 + k] - base[b0] + rm;
        }
        float* gs = Gs + pos * kGs;
#pragma unroll
        for (int i = 0; i < kP; ++i) {
#pragma unroll
          for (int mm = 0; mm < 3; ++mm) gs[i * 3 + mm] = G[i][mm];
          gs[3 * kP + i] = w_zv(W, pp.zv, i);
        }
        camloc[pos] = (uint8_t)(mI ? cam - I0 : cam - J0);
        // the slot's place in each list: the member slots before it
        int ra = __popc(qa[w] & (bit - 1)), rb = __popc(qb[w] & (bit - 1));
        for (int v = 0; v < w; ++v) {
          ra += __popc(qa[v]);
          rb += __popc(qb[v]);
        }
        if (mI) list_a(k)[ra] = (uint16_t)pos;
        if (mJ) list_b(k)[rb] = (uint16_t)pos;
      }
      __syncthreads();
      // 3. accumulate: the warp's landmarks k = warp + 16 j, four at a time,
      // their items in one run
      for (int k0 = warp; k0 < nb; k0 += 4 * kWarps) {
        int nA[4], nB[4], end[4], aend[4], n = 0, an = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + j * kWarps;
          nA[j] = nB[j] = 0;
          if (k < nb) {
            const int q = queue[b0 + k];
            for (int v = 0; v < MW; ++v) {
              nA[j] += __popc(maskA[q * MW + v]);
              nB[j] += __popc(maskB[q * MW + v]);
            }
          }
          n += kP * nA[j] * nB[j];
          end[j] = n;
          an += nA[j];
          aend[j] = an;
        }
        for (int q0 = lane; q0 < n; q0 += 32) {
          const int j = q0 < end[0] ? 0 : q0 < end[1] ? 1 : q0 < end[2] ? 2 : 3;
          const int items = kP * nA[j] * nB[j];
          // warps start at different items of a landmark, so warps on
          // landmarks that share cameras add into different rows at a time
          int it = q0 - (end[j] - items) + items * warp / kWarps;
          it = it < items ? it : it - items;
          const int pr = it / kP, i = it - kP * pr;
          const int a = pr / nB[j], b = pr - a * nB[j];
          const int sa = list_a(k0 + j * kWarps)[a], sb = list_b(k0 + j * kWarps)[b];
          const float* ga = Gs + sa * kGs + 3 * i;
          const float* gb = Gs + sb * kGs;
          float v[kPc];
#pragma unroll
          for (int i2 = 0; i2 < kP; ++i2)
            v[i2] = fmaf(ga[2], gb[3 * i2 + 2], fmaf(ga[1], gb[3 * i2 + 1], ga[0] * gb[3 * i2]));
#pragma unroll
          for (int i2 = kP; i2 < kPc; ++i2) v[i2] = 0.f;
          add_row(tile + (camloc[sa] * kP + i) * ld + camloc[sb] * kPc, v);
        }
        if (diag) {
          for (int a0 = lane; a0 < an; a0 += 32) {
            const int j = a0 < aend[0] ? 0 : a0 < aend[1] ? 1 : a0 < aend[2] ? 2 : 3;
            const int sa = list_a(k0 + j * kWarps)[a0 - (aend[j] - nA[j])];
            float v[kPc];
#pragma unroll
            for (int i = 0; i < kP; ++i) v[i] = Gs[sa * kGs + 3 * kP + i];
#pragma unroll
            for (int i = kP; i < kPc; ++i) v[i] = 0.f;
            add_row(rhs + warp * nc + camloc[sa] * kPc, v);
          }
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  // to the slabs in (i, k) order: slab row i*T + a, column i2*T + b. A
  // thread keeps one slab column; rows step by kThreads / n6.
  float* dst = Sp + (long long)blockIdx.x * n6 * n6;
  const int cpt = kThreads / n6, col = threadIdx.x % n6, r0 = threadIdx.x / n6;
  const int tcol = (col % T) * kPc + col / T;
  if (r0 < cpt) {
    int a = r0 % T, i = r0 / T;
    for (int r = r0; r < n6; r += cpt) {
      dst[(long long)r * n6 + col] = tile[(a * kP + i) * ld + tcol];
      for (a += cpt; a >= T; a -= T) ++i;
    }
  }
  if (diag) {  // the warps' rhs rows, summed in warp order
    float* rdst = Rp + ((long long)I * chunks + c) * n6;
    for (int e = threadIdx.x; e < n6; e += kThreads) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += rhs[w * nc + (e % T) * kPc + e / T];
      rdst[e] = v;
    }
  }
}

// Pass 2, 32 x 32 threads a block. Blocks [0, pairs * nsub): one 32 x 32
// piece of a tile pair's tile: the sum of its chunk slabs in chunk order,
// folded (C: damped U + 1e-8 I - sum; K5: +sum), written to S at (I, J)
// and, for I < J, mirrored to (J, I). Blocks from pairs * nsub: one tile's
// rhs rows (C: -(g_c - sum), g_c zero for fixed cameras; K5: +sum).
// `red27` (red [K][n_red(P)]) null selects K5.
template <int kP>
__global__ void __launch_bounds__(1024)
    schur_finish(const float* __restrict__ Sp, const float* __restrict__ Rp,
                 int K, int T, int nt, int chunks,
                 const float* __restrict__ lam_ptr,
                 const float* __restrict__ red27,
                 const uint8_t* __restrict__ cam_fixed, float* __restrict__ S,
                 float* __restrict__ rhs) {
  constexpr int kRed = n_red(kP), kU = kP * (kP + 1) / 2;
  __shared__ float sm[32][33];
  const int n6 = kP * T;
  const long long K6 = (long long)kP * K;
  const long long slab = (long long)n6 * n6;
  const int nsc = (n6 + 31) / 32, nsub = nsc * nsc;
  const int npairs = nt * (nt + 1) / 2;
  const bool fold = red27 != nullptr;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;

  if ((int)blockIdx.x >= npairs * nsub) {
    const int I = blockIdx.x - npairs * nsub;
    for (int e = threadIdx.x; e < n6; e += blockDim.x) {
      const int i = e / T, k = I * T + e % T;
      if (k >= K) continue;
      float v = 0.f;
      for (int c = 0; c < chunks; ++c) v += Rp[((long long)I * chunks + c) * n6 + e];
      if (fold) {
        const float gc = cam_fixed[k] ? 0.f : red27[k * kRed + kU + i];
        v = -(gc - v);
      }
      rhs[(long long)i * K + k] = v;
    }
    return;
  }
  const int p = blockIdx.x / nsub, sub = blockIdx.x % nsub;
  int I, J;
  pair_of(p, nt, I, J);
  const int tr0 = (sub / nsc) * 32, tc0 = (sub % nsc) * 32;
  {
    const int tr = tr0 + ty, tc = tc0 + tx;
    float v = 0.f;
    if (tr < n6 && tc < n6) {
      const float* src = Sp + (long long)p * chunks * slab + (long long)tr * n6 + tc;
#pragma unroll 8
      for (int c = 0; c < chunks; ++c) v += src[c * slab];
    }
    sm[ty][tx] = v;
  }
  __syncthreads();
  const float lam = fold ? *lam_ptr : 0.f;
  {
    const int tr = tr0 + ty, tc = tc0 + tx;
    const int i = tr / T, k = I * T + tr % T;
    const int i2 = tc / T, k2 = J * T + tc % T;
    if (tr < n6 && tc < n6 && k < K && k2 < K) {
      const long long r = (long long)i * K + k, col = (long long)i2 * K + k2;
      float v = sm[ty][tx];
      if (fold) {
        float base = 0.f;
        if (k == k2) {
          if (cam_fixed[k]) {
            base = i == i2 ? 1.f : 0.f;
          } else {
            base = red27[k * kRed + sym_idx(i, i2, kP)];
            if (i == i2) base = base + lam * fmaxf(base, 1e-6f);
          }
        }
        if (r == col) base += 1e-8f;
        v = base - v;
      }
      S[r * K6 + col] = v;
    }
  }
  if (I == J) return;
  // mirror: tile row tr runs along tx, so the writes along a row of S are
  // contiguous
  {
    const int tr = tr0 + tx, tc = tc0 + ty;
    const int i = tr / T, k = I * T + tr % T;
    const int i2 = tc / T, k2 = J * T + tc % T;
    if (tr < n6 && tc < n6 && k < K && k2 < K) {
      const float v = sm[tx][ty];
      S[((long long)i2 * K + k2) * K6 + (long long)i * K + k] = fold ? 0.f - v : v;
    }
  }
}

template <int kP>
int launch(const float* lam, const float* red27, const uint8_t* cam_fixed,
           const float* Vu, const float* g_p, const uint8_t* pt_valid,
           const float* W18, const int* cam_t, const uint8_t* valid_t, int O, int L,
           int K, int T, int chunks, int slots, float* Sp, float* Rp, float* S,
           float* rhs, float* zv, float* vinv6, cudaStream_t s) {
  if (K <= 0) return 0;
  if (T <= 0 || kP * T > kThreads || T > 256 ||
      (L > 0 && (chunks <= 0 || slots < O || slots > 65535)))
    return (int)cudaErrorInvalidValue;
  const int nt = (K + T - 1) / T;
  const int npairs = nt * (nt + 1) / 2;
  if (L > 0) {
    const long long smem = tile_smem_bytes(T, slots, O, kP);
    cudaError_t e = cudaFuncSetAttribute(
        schur_tiles<kP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    schur_tiles<kP><<<npairs * chunks, kThreads, smem, s>>>(
        lam, Vu, g_p, pt_valid, W18, cam_t, valid_t, O, L, T, nt, chunks, slots, Sp,
        Rp, zv, vinv6);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int nsc = (kP * T + 31) / 32;
  schur_finish<kP><<<npairs * nsc * nsc + nt, 1024, 0, s>>>(
      Sp, Rp, K, T, nt, L > 0 ? chunks : 0, lam, red27, cam_fixed, S, rhs);
  return (int)cudaGetLastError();
}

int launch_width(int width, const float* lam, const float* red27,
                 const uint8_t* cam_fixed, const float* Vu, const float* g_p,
                 const uint8_t* pt_valid, const float* W18, const int* cam_t,
                 const uint8_t* valid_t, int O, int L, int K, int T, int chunks,
                 int slots, float* Sp, float* Rp, float* S, float* rhs, float* zv,
                 float* vinv6, cudaStream_t s) {
  if (width != 6 && width != 9) return (int)cudaErrorInvalidValue;
  auto run = width == 6 ? launch<6> : launch<9>;
  return run(lam, red27, cam_fixed, Vu, g_p, pt_valid, W18, cam_t, valid_t, O, L, K, T,
             chunks, slots, Sp, Rp, S, rhs, zv, vinv6, s);
}

}  // namespace

// width: the camera width P, 6 or 9; valid_t [O][L] (the slots that hold an
// observation) or null (a slot at camera 0 counts where its W is not all
// zero); T, chunks, slots: the host plan (dense_kernels.schur_s_plan);
// Sp [pairs * chunks][PT][PT] and Rp [nt * chunks][PT]: its scratch, left as
// written.
extern "C" int schur_prepare_s(const void* lam, const void* red27,
                               const void* cam_fixed, const void* Vu,
                               const void* g_p, const void* pt_valid,
                               const void* W18, const void* cam_t,
                               const void* valid_t, int O, int L, int K, int width,
                               int T, int chunks, int slots, void* Sp, void* Rp,
                               void* S, void* b, void* zv, void* vinv6, void* stream) {
  return launch_width(width, (const float*)lam, (const float*)red27,
                      (const uint8_t*)cam_fixed, (const float*)Vu, (const float*)g_p,
                      (const uint8_t*)pt_valid, (const float*)W18, (const int*)cam_t,
                      (const uint8_t*)valid_t, O, L, K, T, chunks, slots, (float*)Sp,
                      (float*)Rp, (float*)S, (float*)b, (float*)zv, (float*)vinv6,
                      (cudaStream_t)stream);
}

extern "C" int schur_qqt_partial(const void* lam, const void* Vu, const void* g_p,
                                 const void* pt_valid, const void* W18,
                                 const void* cam_t, const void* valid_t, int O, int L,
                                 int K, int width, int T, int chunks, int slots,
                                 void* Sp, void* Rp, void* S, void* red6, void* zv,
                                 void* vinv6, void* stream) {
  return launch_width(width, (const float*)lam, nullptr, nullptr, (const float*)Vu,
                      (const float*)g_p, (const uint8_t*)pt_valid, (const float*)W18,
                      (const int*)cam_t, (const uint8_t*)valid_t, O, L, K, T, chunks,
                      slots, (float*)Sp, (float*)Rp, (float*)S, (float*)red6,
                      (float*)zv, (float*)vinv6, (cudaStream_t)stream);
}
