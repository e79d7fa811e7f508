// Blocked Cholesky solve (kernel E): x with S x = b for the dense Schur
// camera system of one LM iteration, S [N,N] symmetric positive definite,
// float32, any N >= 1.
//
// Replaces the TPU kernel bundleadjustment_tpu/solvers/pallas_chol.py:
// pallas_chol_solve / _chol_solve_kernel (8x8 diagonal factor _chol8_inv).
//
// What it computes, as the TPU kernel does: a right-looking factor over
// 8-row panels. For panel j (rows p = 8j .. p+7 of the residual R, which
// starts as S): the 8x8 diagonal block is factored column by column with the
// pivot clamp sqrt(max(d, 1e-20)) into LT (upper), L^-1 = Linv comes from an
// unrolled forward substitution on the identity, the panel of L^T is
// A_j = Linv R[p:p+8, p+8:], and the trailing residual loses A_j^T A_j. The
// forward substitution L y = b rides along (y_j = Linv res_j, res -= y_j A_j)
// and the backward substitution L^T x = y runs over the panels in reverse
// (x_j = Linv^T (y_j - A_j x)). A last panel of fewer than 8 rows is padded
// with the identity inside the diagonal block. A non-positive pivot is
// clamped, not reported: an indefinite S gives huge or non-finite x, which
// the LM loop rejects through its cost test.
//
// What is not carried over: the TPU kernel extracts a panel row with a
// one-hot mask product and subtracts the full outer product so that finished
// rows vanish, because its compiler has no dynamic row slice. Here a thread
// indexes rows directly, only the upper triangle of the trailing submatrix
// is updated, and the diagonal block of A_j (never read by either
// substitution) is not formed.
//
// What bounds it on H100: neither bytes (N^2 * 4 B read once: 0.18 us at
// N = 384) nor operations (N^3 / 3 + 2 N^2) but the dependency chain: N / 8
// panel steps of four block-wide barriers each, then N / 8 backward steps of
// two, all in ONE block, because the barriers between panel steps are
// __syncthreads(). One SM does all the work; the trailing update reads and
// writes the residual through L2 once per panel (N^3 / 3 bytes in all).
//
// Design: one block of 1,024 threads. S does not fit shared memory (576 KB
// at N = 384), so the residual lives in a scratch copy in device memory that
// the 50 MB L2 holds; S is not overwritten. The panel A_j overwrites the
// residual rows it came from and is read from there. (A copy of it in shared
// memory was timed on an H100: 0.685 / 3.14 / 207.7 ms with it against
// 0.671 / 3.17 / 271.2 ms without at N = 384 / 768 / 3600. It helps only
// where this one-block design is two orders of magnitude behind a
// whole-card factorisation anyway, so it was left out.) Shared memory holds
// the right-hand side vector (res, then y, then x, in place; N floats, so
// N <= 57,344) and the 8x8 blocks. The 8x8 factor runs on 8 lanes of warp
// 0, lane c owning column c; the panel A_j is one
// thread per column; the trailing update is one warp per row, lanes along
// the row, so loads and stores are coalesced, each lane with 4 elements in
// flight (timed at 256 / 512 / 1,024 threads x 1 / 2 / 4 in flight: 1,024 x
// 4 was fastest, by 5% at N = 384 and 15% at N = 3600); each backward step
// is 8 dot products split over the 32 warps and reduced with shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int kPanel = 8;
constexpr int kThreads = 1024;
constexpr int kUnroll = 4;  // row elements a lane has in flight in step 4
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-20f;

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ S, const float* __restrict__ b,
                  int N,
                  float* __restrict__ A,     // [N, N] residual, then L^T panels
                  float* __restrict__ Linv,  // [ceil(N/8), 8, 8]
                  float* __restrict__ x) {
  extern __shared__ float vec[];  // [N]: res, overwritten by y, then by x
  __shared__ float D[kPanel][kPanel];   // residual diagonal block
  __shared__ float LT[kPanel][kPanel];  // its upper factor
  __shared__ float Li[kPanel][kPanel];  // LT^-T = L^-1 (lower)
  __shared__ float ysh[kPanel];
  __shared__ float tsh[kWarps / kPanel][kPanel];

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long NN = (long long)N * N;
  for (long long e = tid; e < NN; e += kThreads) A[e] = S[e];
  for (int n = tid; n < N; n += kThreads) vec[n] = b[n];
  __syncthreads();

  const int nb = (N + kPanel - 1) / kPanel;
  for (int j = 0; j < nb; ++j) {
    const int p = j * kPanel;
    const int w = min(kPanel, N - p);  // rows of this panel
    const int m = N - p;               // its columns, p .. N-1
    float* pan = A + (size_t)p * N + p;  // the panel's rows, from column p

    // 1. the diagonal block (upper triangle mirrored, identity pad)
    if (tid < kPanel * kPanel) {
      const int a = tid / kPanel, c = tid % kPanel;
      float v = a == c ? 1.f : 0.f;
      if (a < w && c < w)
        v = A[(size_t)(p + min(a, c)) * N + p + max(a, c)];
      D[a][c] = v;
    }
    __syncthreads();

    // 2. 8x8 factor, its inverse and y_j, on 8 lanes (lane c = column c)
    if (tid < kPanel) {
      const int c = tid;
      for (int k = 0; k < kPanel; ++k) {
        const float d = D[k][k];
        const float r = c >= k ? D[k][c] / sqrtf(fmaxf(d, kEps)) : 0.f;
        LT[k][c] = r;
        __syncwarp(0xff);
#pragma unroll
        for (int a = 0; a < kPanel; ++a) D[a][c] -= LT[k][a] * r;
        __syncwarp(0xff);
      }
      // forward substitution on the identity: column c of L^-1
      float xc[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) {
        float acc = k == c ? 1.f : 0.f;
#pragma unroll
        for (int i = 0; i < k; ++i) acc -= LT[i][k] * xc[i];
        xc[k] = acc / fmaxf(LT[k][k], kEps);
      }
#pragma unroll
      for (int k = 0; k < kPanel; ++k) {
        Li[k][c] = xc[k];
        Linv[(size_t)j * kPanel * kPanel + k * kPanel + c] = xc[k];
      }
      __syncwarp(0xff);
      float yc = 0.f;
      for (int k = 0; k < w; ++k) yc += Li[c][k] * vec[p + k];
      __syncwarp(0xff);
      ysh[c] = yc;
      if (c < w) vec[p + c] = yc;
    }
    __syncthreads();

    // 3. A_j = Linv R[p:p+8, p+8:], one thread per column, and the
    //    right-hand side's share of it: res -= y_j A_j
    for (int c = w + tid; c < m; c += kThreads) {
      float a[kPanel], o[kPanel];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) a[r] = pan[(size_t)r * N + c];
      float res = vec[p + c];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k <= r; ++k) s += Li[r][k] * a[k];
        o[r] = s;
        res -= ysh[r] * s;
      }
      vec[p + c] = res;
#pragma unroll
      for (int r = 0; r < kPanel; ++r) pan[(size_t)r * N + c] = o[r];
    }
    __syncthreads();

    // 4. trailing update, upper triangle: R[i, k] -= sum_r A_j[r,i] A_j[r,k]
    //    (a panel of fewer than 8 rows is the last one: nothing trails it)
    for (int i = w + wid; i < m; i += kWarps) {
      float ai[kPanel];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) ai[r] = pan[(size_t)r * N + i];
      float* row = A + (size_t)(p + i) * N + p;
      for (int k0 = i + lane; k0 < m; k0 += 32 * kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + 32 * u;
          v[u] = k < m ? row[k] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + 32 * u;
          if (k >= m) break;
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < kPanel; ++r) s += ai[r] * pan[(size_t)r * N + k];
          row[k] = v[u] - s;
        }
      }
    }
    __syncthreads();
  }

  // backward substitution: x_j = Linv_j^T (y_j - A_j x), panels in reverse
  for (int j = nb - 1; j >= 0; --j) {
    const int p = j * kPanel;
    const int w = min(kPanel, N - p);
    const int r = wid % kPanel, part = wid / kPanel;
    float s = 0.f;
    if (r < w) {
      const float* row = A + (size_t)(p + r) * N;
      for (int n = p + w + part * 32 + lane; n < N; n += 32 * (kWarps / kPanel))
        s += row[n] * vec[n];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) tsh[part][r] = s;
    __syncthreads();
    if (tid < kPanel) {
      const int c = tid;
      const float* Lj = Linv + (size_t)j * kPanel * kPanel;
      float acc = 0.f;
      for (int q = c; q < w; ++q) {
        float t = 0.f;
#pragma unroll
        for (int h = 0; h < kWarps / kPanel; ++h) t += tsh[h][q];
        acc += Lj[q * kPanel + c] * (vec[p + q] - t);
      }
      __syncwarp(0xff);
      if (c < w) vec[p + c] = acc;
    }
    __syncthreads();
  }
  for (int n = tid; n < N; n += kThreads) x[n] = vec[n];
}

}  // namespace

// S [N,N], b [N] -> x [N]; work holds N*N + 64*ceil(N/8) floats of scratch.
extern "C" int chol_solve(const void* S, const void* b, int N, void* work,
                          void* x, void* stream) {
  if (N <= 0) return 0;
  const size_t smem_bytes = sizeof(float) * (size_t)N;
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  float* A = (float*)work;
  chol_solve_kernel<<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)S, (const float*)b, N, A, A + (size_t)N * N, (float*)x);
  return (int)cudaGetLastError();
}
