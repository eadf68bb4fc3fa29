// K3: the whole coupled IRLS loop of one solver call (odometry 6x6 solve +
// 24-cluster segmentation solve, up to max_iter iterations).
//
// Replaces staticfusion_tpu/kernels/irls_pallas.py::irls_solve_call (body
// `_kernel`, wrapper `solve_irls_fused`).  Plain version:
// staticfusion_tpu_torch/solver/irls.py::solve_irls_xla.
//
// What bounds it on the card: the two reductions over all pixels in every
// iteration, between which nothing can proceed (the 6x6 solve needs all of
// A^T W A before the pass-1 residuals exist; the 24x24 solve needs all
// per-cluster sums before the next iteration's weights).  At QVGA a pass
// reads 14 floats + 1 int per pixel (4.6 MB at level 0, from L2 after the
// first pass), so each pass is a few microseconds of bandwidth; the cost
// is latency: the grid-wide dependency and the serial small solves.
//
// Design: a chain of launches per iteration on one stream, all enqueued by
// one host call with no host read in between:
//   pass0   (one block per 2048-pixel tile): residuals from the carried
//           twist, Cauchy x segmentation weights, per-tile partial
//           A^T W A (21 entries) and A^T W b (6);
//   final0  (one warp): sums the tile partials in tile order, 6x6 Cholesky
//           solve (smallsolve.cuh), marks convergence pending when
//           ||dxi||_inf < delta_thr;
//   pass1   (tiles): residuals from the new twist, per-tile per-cluster
//           sums of |r_c|+|r_d| and sum r^2;
//   final1  (one warp): sums in tile order, 24x24 segmentation solve,
//           commits the iteration's outputs, latches done = pending.
// Every kernel first reads the `done` flag in device memory and returns at
// once when it is set, so the converged iteration's values are kept and
// the remaining launches cost only their launch.  The GPU's blocks run in
// no order, so cross-block sums go through per-tile partials summed in a
// fixed order: no float atomics, and the sums (and the convergence test
// that reads them) are the same from run to run.  A cooperative grid-sync
// kernel would save the launches but ties the grid to co-residency; that
// and CUDA graphs are later speed work.
//
// The Jacobian stays in the JAX package's structure-of-arrays layout
// (12, N) = [A_c^T; A_d^T]: neighbouring threads read neighbouring pixels,
// so every load is coalesced without a repack.
#include <cuda_runtime.h>

#include "smallsolve.cuh"

namespace {

constexpr int kK = 24;          // clusters
constexpr int kThreads = 256;   // threads per tile block
constexpr int kWarps = kThreads / 32;
constexpr int kP0 = 27;         // 21 upper-triangle A^T W A + 6 A^T W b
constexpr int kP1 = kK + 1;     // 24 cluster sums + sum r^2

// State vector layout (float32, device).
constexpr int ST_TWIST = 0;     // 6
constexpr int ST_BEXT = 6;      // 25: b_segm, then 1 for the invalid label
constexpr int ST_AVER = 31;
constexpr int ST_PENDING = 32;
constexpr int ST_DONE = 33;
constexpr int ST_KB = 34;
constexpr int ST_N2 = 35;

__device__ __forceinline__ int tri_index(int r, int c) {
  // Row-major upper triangle of a 6x6, r <= c.
  return r * 6 - (r * (r - 1)) / 2 + (c - r);
}

// Deterministic block reduction of NV per-thread values; thread j < NV of
// the block gets total j.  Warp trees, then warps summed in order.
template <int NV>
__device__ __forceinline__ void block_reduce_store(float (&acc)[NV],
                                                   float* dst) {
  __shared__ float red[kWarps][NV];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(SF_FULL_MASK, v, off);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][threadIdx.x];
    dst[threadIdx.x] = t;
  }
}

__global__ void pass0_kernel(const float* __restrict__ at,
                             const float* __restrict__ b2,
                             const int* __restrict__ lbl, int n, int tile,
                             const float* __restrict__ st,
                             float* __restrict__ part0, float kc) {
  if (st[ST_DONE] != 0.f) return;
  float tw[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) tw[k] = st[ST_TWIST + k];
  const float inv_c = 1.f / (kc * fmaxf(st[ST_AVER], 1e-20f));
  float acc[kP0];
#pragma unroll
  for (int j = 0; j < kP0; ++j) acc[j] = 0.f;
  const int begin = blockIdx.x * tile;
  const int end = min(begin + tile, n);
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    float ac[6], ad[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      ac[k] = at[k * n + i];
      ad[k] = at[(6 + k) * n + i];
    }
    const float bc = b2[i];
    const float bd = b2[n + i];
    const float bw = fminf(fmaxf(st[ST_BEXT + lbl[i]], 0.f), 1.f);
    float pc = 0.f, pd = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      pc += tw[k] * ac[k];
      pd += tw[k] * ad[k];
    }
    const float tc = (pc - bc) * inv_c;
    const float td = (pd - bd) * inv_c;
    const float wc = bw * sqrtf(1.f / (1.f + tc * tc));
    const float wd = bw * sqrtf(1.f / (1.f + td * td));
    float u[6], v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      u[k] = ac[k] * wc;
      v[k] = ad[k] * wd;
    }
    const float ub = wc * bc;
    const float vb = wd * bd;
    int q = 0;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
#pragma unroll
      for (int c = r; c < 6; ++c) acc[q++] += u[r] * u[c] + v[r] * v[c];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) acc[21 + r] += u[r] * ub + v[r] * vb;
  }
  block_reduce_store<kP0>(acc, part0 + blockIdx.x * kP0);
}

__global__ void final0_kernel(const float* __restrict__ part0, int tiles,
                              float* __restrict__ st,
                              float* __restrict__ out_ata, float delta_thr) {
  if (st[ST_DONE] != 0.f) return;
  __shared__ float s[kP0];
  const int lane = threadIdx.x;
  if (lane < kP0) {
    float t = 0.f;
    for (int b = 0; b < tiles; ++b) t += part0[b * kP0 + lane];
    s[lane] = t;
  }
  __syncwarp();
  float a[8];
  float x[1];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = (lane < 6 && k < 6)
               ? s[tri_index(min(lane, k), max(lane, k))] : 0.f;
  }
  if (lane < 6) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      out_ata[lane * 6 + k] = a[k];
      if (k == lane) a[k] = a[k] + 1e-12f;  // ridge
    }
  }
  x[0] = lane < 6 ? s[21 + lane] : 0.f;
  warp_chol_solve<8, 1>(a, x, 6, 1);
  float delta = lane < 6 ? fabsf(st[ST_TWIST + lane] - x[0]) : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    delta = fmaxf(delta, __shfl_xor_sync(SF_FULL_MASK, delta, off));
  __syncwarp();
  if (lane < 6) st[ST_TWIST + lane] = x[0];
  if (lane == 0) st[ST_PENDING] = delta < delta_thr ? 1.f : 0.f;
}

__global__ void pass1_kernel(const float* __restrict__ at,
                             const float* __restrict__ b2,
                             const int* __restrict__ lbl, int n, int tile,
                             const float* __restrict__ st,
                             float* __restrict__ part1) {
  if (st[ST_DONE] != 0.f) return;
  float tw[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) tw[k] = st[ST_TWIST + k];
  float acc[kP1];
#pragma unroll
  for (int j = 0; j < kP1; ++j) acc[j] = 0.f;
  const int begin = blockIdx.x * tile;
  const int end = min(begin + tile, n);
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    float pc = 0.f, pd = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      pc += tw[k] * at[k * n + i];
      pd += tw[k] * at[(6 + k) * n + i];
    }
    const float rc = pc - b2[i];
    const float rd = pd - b2[n + i];
    const float ress = fabsf(rc) + fabsf(rd);
    const int l = lbl[i];
#pragma unroll
    for (int k = 0; k < kK; ++k) acc[k] += (l == k) ? ress : 0.f;
    acc[kK] += rc * rc + rd * rd;
  }
  block_reduce_store<kP1>(acc, part1 + blockIdx.x * kP1);
}

__global__ void final1_kernel(const float* __restrict__ part1, int tiles,
                              float* __restrict__ st,
                              const float* __restrict__ prior,
                              const float* __restrict__ counts,
                              const float* __restrict__ reg,
                              float* __restrict__ out, float kc,
                              float lambda_prior) {
  if (st[ST_DONE] != 0.f) return;
  const int lane = threadIdx.x;
  float sk = 0.f;
  if (lane < kP1) {
    for (int b = 0; b < tiles; ++b) sk += part1[b * kP1 + lane];
  }
  float tot = lane < kK ? sk : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tot += __shfl_down_sync(SF_FULL_MASK, tot, off);
  tot = __shfl_sync(SF_FULL_MASK, tot, 0);
  const float res_sq = __shfl_sync(SF_FULL_MASK, sk, kK);
  const float new_aver = tot / st[ST_N2];

  // Segmentation system (SegmentationBackground.cpp:133-174), the maths of
  // solver/segmentation.py::solve_segm_iteration.
  const float aver = st[ST_AVER];
  const float kb = st[ST_KB];
  const float repr = fmaxf(0.001f, aver);
  const float mult = 1.f / (kc * fmaxf(aver, 1e-20f));
  const float tf = kb * repr * mult;
  const float fixed = log1pf(tf * tf);
  float ad = 0.f, rhs = 0.f;
  if (lane < kK) {
    const float arl = sk / (2.f * (counts[lane] + 1.f));
    const float bp = prior[lane];
    const float lt = prior[kK + lane];
    const bool trusted = lt > 0.1f;
    const float ta = arl * mult;
    const float dataterm = fixed - log1pf(ta * ta);
    ad = trusted ? 2.f * lt * lambda_prior : 2.f * lt;
    const float br = trusted ? dataterm + 2.f * lambda_prior * lt * bp
                             : 2.f * lt * bp;
    rhs = ad * br;
  }
  float a[kK];
  float x[1];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    a[k] = lane < kK ? ((k == lane ? ad * ad : 0.f) + reg[lane * kK + k])
                     : 0.f;
    if (k == lane) a[k] = a[k] + 1e-6f;  // ridge covers empty clusters
  }
  x[0] = rhs;
  warp_chol_solve<kK, 1>(a, x, kK, 1);
  const float b_new = fminf(fmaxf(x[0], -1.f), 2.f);
  // Commit the iteration (the last executed iteration's values survive)
  // and latch the pending exit.
  if (lane < kK) {
    st[ST_BEXT + lane] = b_new;
    out[6 + lane] = b_new;
  }
  if (lane < 6) out[lane] = st[ST_TWIST + lane];
  if (lane == 0) {
    st[ST_AVER] = new_aver;
    out[30] = new_aver;
    out[31] = res_sq;
    st[ST_DONE] = st[ST_PENDING];
  }
}

}  // namespace

extern "C" {

// Runs the IRLS chain for one solve.  at (12, n), b2 (2, n), lbl (n) int32
// in [0, 24]; st (36) state, initialised by the caller (twist 0, b_ext,
// aver_res0, flags 0, kb, n2); prior (2, 24) = [b_prior; lambda_t_w];
// counts (24); reg (24, 24); part0 (tiles, 27) and part1 (tiles, 25)
// scratch with tiles = ceil(n / tile).  Writes out (32) = [twist 6,
// b_segm 24, aver_res, res_sq] and out_ata (6, 6).  Returns the first
// nonzero cudaGetLastError(), or 0.
int sf_irls_solve(const float* at, const float* b2, const int* lbl, int n,
                  int tile, float* st, const float* prior,
                  const float* counts, const float* reg, float* part0,
                  float* part1, float* out, float* out_ata, int max_iter,
                  float kc, float lambda_prior, float delta_thr,
                  cudaStream_t stream) {
  const int tiles = (n + tile - 1) / tile;
  for (int it = 0; it < max_iter; ++it) {
    pass0_kernel<<<tiles, kThreads, 0, stream>>>(at, b2, lbl, n, tile, st,
                                                 part0, kc);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    final0_kernel<<<1, 32, 0, stream>>>(part0, tiles, st, out_ata,
                                        delta_thr);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    pass1_kernel<<<tiles, kThreads, 0, stream>>>(at, b2, lbl, n, tile, st,
                                                 part1);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    final1_kernel<<<1, 32, 0, stream>>>(part1, tiles, st, prior, counts, reg,
                                        out, kc, lambda_prior);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
