// Blocked Cholesky solve (kernel E): x with S x = b for the dense Schur
// camera system of one LM iteration, S [N,N] symmetric positive definite,
// float32, N from 1 to 46,340.
//
// Replaces the TPU kernel bundleadjustment_tpu/solvers/pallas_chol.py:
// pallas_chol_solve / _chol_solve_kernel (8x8 diagonal factor _chol8_inv).
//
// What it computes, as the TPU kernel does, over P-row panels (P = 32 here,
// 8 there): a right-looking factor. For panel j (rows p .. p+P-1 of the
// residual R, which starts as S): the PxP diagonal block is factored column
// by column with the pivot clamp sqrt(max(d, 1e-20)) into LT (upper),
// L^-1 = Linv comes from a forward substitution on the identity, the panel
// of L^T is A_j = Linv R[p:p+P, q:] (q = p + P), and the trailing residual
// loses A_j^T A_j. The forward substitution L y = b rides along: b is column
// N of the scratch copy [S | b], so y_j is A_j's last column and the
// trailing update of that column is res -= A_j^T y_j. The backward
// substitution L^T x = y then runs over the panels in reverse: x_j =
// Linv_j^T y_j, then y_i -= A[i, p:p+P] x_j for every row i < p. A last
// panel of fewer than P rows is padded with the identity inside the diagonal
// block. A non-positive pivot is clamped, not reported: an indefinite S gives
// huge or non-finite x, which the LM loop rejects through its cost test.
//
// What is not carried over: the TPU kernel extracts a panel row with a
// one-hot mask product and subtracts the full outer product so that finished
// rows vanish, because its compiler has no dynamic row slice. Here threads
// index rows directly, only the upper triangle of the trailing matrix is
// updated, the diagonal block of A_j (never read) is not formed, and the
// backward substitution goes by columns, so no sum crosses blocks.
//
// What bounds it on H100: not bytes (N^2 * 4 B read once: 0.18 us at
// N = 384) and not operations (N^3 / 3 + 2 N^2 at 67 TFLOP/s: 0.3 us at
// N = 384, 0.23 ms at N = 3,600), but the dependency chain. Every panel step
// waits for the one before, and each holds a chain of P dependent pivots.
// The earlier design of this kernel, one block on one SM, ran the chain
// with __syncthreads() and 1/132 of the card's arithmetic: 271 ms at N =
// 3,600. This one spreads each step over the card, so the chain becomes
// 3 ceil(N/P) - 1 grid-wide barriers (1 after the copy of [S | b] into
// scratch; per panel 1 after phase B and 1 after phase C, none after the last
// C, which has nothing to update; per backward step 1, none after the last),
// plus ceil(N/P) diagonal factors of P dependent steps each. On an H100
// (profile_chol.py --phases) that chain is most of the time up to N = 768;
// at N = 3,600 the trailing update is half of it, each tile's loads from L2
// waiting on the one before.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel) of G blocks
// of 256 threads, G = min(co-resident blocks, tiles of the first trailing
// update), at least 1 (the host computes G: solvers/chol.py:launch_plan);
// cooperative_groups' grid.sync() is the barrier. The scratch copy R = [S | b]
// ([N, ld] floats, ld = N + 1 rounded up to 4 so that panel columns are
// 16-byte aligned: 52 MB at N = 3,600, about what the 50 MB L2 holds) is read
// with __ldcg (L2, not the SM's L1: other blocks write it between barriers);
// S is not overwritten.
//   B: each block that owns columns of the panel row (64 a block, so the
//   work spreads over more SMs) and block 0, which also stores Linv for the
//   backward pass, factors the diagonal block itself: the same arithmetic in
//   every block, so no barrier hands Linv over. Warp 0 factors, lane c
//   holding column c in registers; the pivot and the factor's row move by
//   shuffles, so the P dependent steps wait on no barrier. Then one thread
//   per column loads its P entries at once and forms Linv R[p:p+P, k], Linv
//   read as float4 from shared memory.
//   C: the upper-triangle 64x64 tiles of the trailing matrix, b's column
//   included, spread over the blocks; the panel's two P x 64 slices staged in
//   shared memory, each thread a 4x4 register tile whose old values are
//   loaded before the slices arrive.
//   Backward: every block forms x_j = Linv_j^T y_j itself, block 0 stores
//   it, and one thread per row i < p subtracts A[i, p:p+P] x_j (eight float4
//   loads).
// Every sum is taken in a fixed order and no value goes through an atomic,
// so two runs on the same inputs give the same x. Multiply-adds are explicit
// fmaf: the library is built with --fmad=false (kernel B needs it), which
// would otherwise split each of them in two. One block an SM: at two, the
// 128-register cap spilled the factor's and phase B's register arrays, and
// both phases ran slower.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kP = 32;            // panel rows
constexpr int kL = kP + 1;        // a padded row of a PxP block in shared memory
constexpr int kLT = kP + 4;       // the same, 16-byte aligned (float4 reads)
constexpr int kBCols = 64;        // panel-row columns a block takes in phase B
constexpr int kThreads = 256;
constexpr int kTile = 64;         // trailing-update output tile, kTile^2
constexpr int kSub = kTile / 16;  // a thread's outputs along each side
constexpr float kEps = 1e-20f;
// Phase clock (profile_chol.py --phases builds with -DCHOL_PHASES): block 0's
// thread 0 records (phase, clock64()) at the end of every phase.
enum Phase { kStart, kCopy, kFactor, kPanelRow, kPanelRowWait, kUpdate,
             kUpdateWait, kBackX, kBackRows, kBackWait };
#ifdef CHOL_PHASES
constexpr unsigned kMaxStamps = 16384;
__device__ unsigned long long g_stamps[2][kMaxStamps];
__device__ unsigned g_nstamps;
#define PHASE(c)                                                             \
  do {                                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0 && g_nstamps < kMaxStamps) {    \
      g_stamps[0][g_nstamps] = (c);                                          \
      g_stamps[1][g_nstamps++] = clock64();                                  \
    }                                                                        \
  } while (0)
#else
#define PHASE(c) \
  do {           \
  } while (0)
#endif

// Factor the diagonal block of a panel (rows p .. p+w-1, identity pad) and
// write L^-1, transposed, into LiT [kP][kLT] (shared, row c = column c of
// L^-1); Lg (block 0 only) gets L^-1 [kP][kP] in device memory. Warp 0 does
// it, lane c holding column c: the pivot and the factor's row come by
// shuffles, so the P dependent column steps wait on no barrier.
__device__ void factor_diagonal(const float* R, size_t ld, int p, int w,
                                float* LiT, float* LT, float* Lg) {
  const int c = threadIdx.x;
  if (c < 32) {
    float d[kP];  // column c of the residual block, upper triangle (a <= c)
#pragma unroll
    for (int a = 0; a < kP; ++a) {
      float v = a == c ? 1.f : 0.f;
      if (a <= c && c < w) v = __ldcg(R + (size_t)(p + a) * ld + p + c);
      d[a] = v;
    }
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const float piv = __shfl_sync(0xffffffffu, d[k], k);
      const float r = c >= k ? d[k] * rsqrtf(fmaxf(piv, kEps)) : 0.f;
      LT[k * kL + c] = r;
#pragma unroll
      for (int a = k + 1; a < kP; ++a)
        d[a] = fmaf(-__shfl_sync(0xffffffffu, r, a), r, d[a]);
    }
    float* rdiag = LT + kP * kL;  // 1 / LT[k][k], clamped
    __syncwarp();
    rdiag[c] = __frcp_rn(fmaxf(LT[c * kL + c], kEps));
    __syncwarp();
    // L^-1 by columns: lane c solves L X[:, c] = e_c (L = LT^T); X[k] stays
    // 0 for k < c
    float X[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k) X[k] = k == c ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      X[k] = X[k] * rdiag[k];
#pragma unroll
      for (int a = k + 1; a < kP; ++a) X[a] = fmaf(-LT[k * kL + a], X[k], X[a]);
    }
#pragma unroll
    for (int a = 0; a < kP; ++a) {
      LiT[c * kLT + a] = X[a];
      if (Lg != nullptr) Lg[a * kP + c] = X[a];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
chol_solve_kernel(const float* __restrict__ S, const float* __restrict__ b,
                  int N,
                  float* R,     // [N, ld]: [S | b], then L^T panels | y
                  float* Linv,  // [ceil(N / P), P, P]
                  float* __restrict__ x) {
  __shared__ __align__(16) float sm[2 * kP * kTile];  // phase B or C
  __shared__ float ys[kP], xs[kP];      // backward: y_j, then x_j
  cg::grid_group grid = cg::this_grid();
  PHASE(kStart);
  const int tid = threadIdx.x;
  const size_t ld = (size_t)(N + 4) & ~(size_t)3;  // rows 16-byte aligned
  const int nb = (N + kP - 1) / kP;
  const unsigned gt = blockIdx.x * kThreads + tid, gs = gridDim.x * kThreads;

  // [S | b] into scratch, the upper triangle only (nothing reads below it);
  // four loads in flight a thread
  const unsigned NN = (unsigned)N * N;
  for (unsigned e0 = gt; e0 < NN; e0 += 4 * gs) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned e = e0 + u * gs, i = e / N, k = e - i * N;
      v[u] = e < NN && k >= i ? S[e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned e = e0 + u * gs, i = e / N, k = e - i * N;
      if (e < NN && k >= i) R[i * ld + k] = v[u];
    }
  }
  for (unsigned i = gt; i < (unsigned)N; i += gs) R[i * ld + N] = b[i];
  grid.sync();
  PHASE(kCopy);

  for (int j = 0; j < nb; ++j) {
    const int p = j * kP;
    const int w = min(kP, N - p);  // rows of this panel
    const int q = p + w;           // first trailing row and column
    const int ncol = N + 1 - q;    // panel-row columns q .. N (b's included)

    // B: Linv and the panel row of L^T, A_j[:, q:N+1] = Linv R[p:p+w, q:N+1]
    if (blockIdx.x == 0 || blockIdx.x * kBCols < ncol) {
      float* LiT = sm;  // [kP][kLT], then LT [kP][kL] and 1 / diag [kP]
      factor_diagonal(R, ld, p, w, LiT, sm + kP * kLT,
                      blockIdx.x == 0 ? Linv + (size_t)j * kP * kP : nullptr);
      PHASE(kFactor);
      const float4* Li4 = (const float4*)LiT;
      for (unsigned k = q + blockIdx.x * kBCols + tid; tid < kBCols && k <= (unsigned)N;
           k += gridDim.x * kBCols) {
        float a[kP], o[kP];  // the column in, all loads in flight; then out
#pragma unroll
        for (int c = 0; c < kP; ++c) {
          a[c] = c < w ? __ldcg(R + (size_t)(p + c) * ld + k) : 0.f;
          o[c] = 0.f;
        }
        // o[r] = sum_c Linv[r][c] a[c] in order of c; Linv[r][c] = 0 for r < c
#pragma unroll
        for (int c = 0; c < kP; ++c)
#pragma unroll
          for (int g = c / 4; g < kP / 4; ++g) {
            const float4 l = Li4[c * (kLT / 4) + g];
            o[4 * g] = fmaf(l.x, a[c], o[4 * g]);
            o[4 * g + 1] = fmaf(l.y, a[c], o[4 * g + 1]);
            o[4 * g + 2] = fmaf(l.z, a[c], o[4 * g + 2]);
            o[4 * g + 3] = fmaf(l.w, a[c], o[4 * g + 3]);
          }
#pragma unroll
        for (int r = 0; r < kP; ++r)
          if (r < w) R[(size_t)(p + r) * ld + k] = o[r];
      }
    }
    PHASE(kPanelRow);
    grid.sync();
    PHASE(kPanelRowWait);
    if (j == nb - 1) break;  // a last panel has nothing trailing it

    // C: R[i, k] -= sum_r A_j[r, i] A_j[r, k] over the upper-triangle tiles
    // of rows q .. N-1 and columns q .. N (here w == P)
    const int nrt = (N - q + kTile - 1) / kTile;
    const int nct = (ncol + kTile - 1) / kTile;
    const int ntiles = nrt * nct - nrt * (nrt - 1) / 2;
    float* Ar = sm;               // [P][kTile]: A_j[:, tile rows]
    float* Ac = sm + kP * kTile;  // [P][kTile]: A_j[:, tile columns]
    const int ty = tid / 16, tx = tid % 16;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int tr = 0, tt = t;
      while (tt >= nct - tr) {
        tt -= nct - tr;
        ++tr;
      }
      const int i0 = q + tr * kTile, k0 = q + (tr + tt) * kTile;
      // this thread's outputs: rows i0 + 4 ty + u, columns k0 + 4 tx + v,
      // loaded before the wait for the panel slices
      float acc[kSub][kSub];
#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int v = 0; v < kSub; ++v) {
          const int i = i0 + 4 * ty + u, k = k0 + 4 * tx + v;
          acc[u][v] = i < N && k <= N ? __ldcg(R + (size_t)i * ld + k) : 0.f;
        }
      __syncthreads();  // the previous tile's reads of Ar / Ac are done
#pragma unroll
      for (int e = tid; e < kP * kTile; e += kThreads) {
        const int r = e / kTile, cc = e % kTile;
        const float* row = R + (size_t)(p + r) * ld;
        Ar[e] = i0 + cc < N ? __ldcg(row + i0 + cc) : 0.f;
        Ac[e] = k0 + cc <= N ? __ldcg(row + k0 + cc) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < kP; ++r) {
        const float4 ar = ((const float4*)(Ar + r * kTile))[ty];
        const float4 ac = ((const float4*)(Ac + r * kTile))[tx];
        const float a4[kSub] = {ar.x, ar.y, ar.z, ar.w};
        const float c4[kSub] = {ac.x, ac.y, ac.z, ac.w};
#pragma unroll
        for (int u = 0; u < kSub; ++u)
#pragma unroll
          for (int v = 0; v < kSub; ++v) acc[u][v] = fmaf(-a4[u], c4[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int v = 0; v < kSub; ++v) {
          const int i = i0 + 4 * ty + u, k = k0 + 4 * tx + v;
          if (i < N && k <= N) R[(size_t)i * ld + k] = acc[u][v];
        }
    }
    PHASE(kUpdate);
    grid.sync();
    PHASE(kUpdateWait);
  }

  // backward substitution by columns: x_j = Linv_j^T y_j, then
  // y_i -= A[i, p:p+w] x_j for every row i < p, one thread a row
  for (int j = nb - 1; j >= 0; --j) {
    const int p = j * kP;
    const int w = min(kP, N - p);
    if (tid < w) {
      // column tid of Linv_j and y_j, all loads issued before any is used
      const float* Lj = Linv + (size_t)j * kP * kP;
      float l[kP];
#pragma unroll
      for (int r = 0; r < kP; ++r)
        l[r] = r >= tid && r < w ? __ldcg(Lj + r * kP + tid) : 0.f;
      ys[tid] = __ldcg(R + (size_t)(p + tid) * ld + N);
      __syncwarp(w == 32 ? 0xffffffffu : (1u << w) - 1);
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kP; ++r)
        if (r >= tid && r < w) s = fmaf(l[r], ys[r], s);
      xs[tid] = s;
      if (blockIdx.x == 0) x[p + tid] = s;
    }
    __syncthreads();
    PHASE(kBackX);
    for (unsigned i = gt; i < (unsigned)p; i += gs) {
      const float* row = R + i * ld + p;  // 16-byte aligned: p % 32 == 0
      const float y = __ldcg(R + i * ld + N);
      float s = 0.f;
      if (w == kP) {
        float4 v[kP / 4];
#pragma unroll
        for (int u = 0; u < kP / 4; ++u) v[u] = __ldcg((const float4*)row + u);
#pragma unroll
        for (int u = 0; u < kP / 4; ++u) {
          s = fmaf(v[u].x, xs[4 * u], s);
          s = fmaf(v[u].y, xs[4 * u + 1], s);
          s = fmaf(v[u].z, xs[4 * u + 2], s);
          s = fmaf(v[u].w, xs[4 * u + 3], s);
        }
      } else {
        for (int c = 0; c < w; ++c) s = fmaf(__ldcg(row + c), xs[c], s);
      }
      R[i * ld + N] = y - s;
    }
    PHASE(kBackRows);
    if (j > 0) grid.sync();
    PHASE(kBackWait);
  }
}

}  // namespace

// S [N,N], b [N] -> x [N] over `grid` co-resident blocks; work holds
// N ld + 32^2 ceil(N / 32) floats of scratch, ld = N + 1 rounded up to 4.
extern "C" int chol_solve(const void* S, const void* b, int N, int grid,
                          void* work, void* x, void* stream) {
  if (N <= 0) return 0;
  const float* Sp = (const float*)S;
  const float* bp = (const float*)b;
  float* R = (float*)work;
  float* Linv = R + (size_t)N * ((N + 4) & ~3);
  float* xp = (float*)x;
  void* args[] = {&Sp, &bp, &N, &R, &Linv, &xp};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)chol_solve_kernel, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many blocks of the kernel one SM holds at once (the cooperative
// launch's grid may not exceed this times the SM count).
extern "C" int chol_solve_blocks_per_sm(int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, chol_solve_kernel, kThreads, 0);
}

#ifdef CHOL_PHASES
// The stamps of the launches since the last call: out [2][kMaxStamps]
// (phases, clocks), n their count; clears them.
extern "C" int chol_solve_phases(unsigned long long* out, unsigned* n) {
  cudaError_t err = cudaMemcpyFromSymbol(n, g_nstamps, sizeof(unsigned));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  const unsigned zero = 0;
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_nstamps, &zero, sizeof(unsigned));
  return (int)err;
}
#endif
