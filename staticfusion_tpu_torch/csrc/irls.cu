// K3: the whole coupled IRLS loop of one solver call (odometry 6x6 solve +
// 24-cluster segmentation solve, up to max_iter iterations) and the
// covariance inverse after it, in ONE cooperative launch.
//
// Replaces staticfusion_tpu/kernels/irls_pallas.py:242 irls_solve_call (body
// `_kernel`, wrapper `solve_irls_fused`) and the est_cov step that
// solve_irls_fused runs right after it (irls_pallas.py:332,
// spd_inverse(AtA, 1e-12) * res_sq), and the motion filter's 6x6 solve
// that follows each solve on the solver's path (solver/irls.py:189
// motion_filter, by smallsolve_pallas.py:75 spd_solve).  Plain version:
// staticfusion_tpu_torch/solver/irls.py::solve_irls_xla, then
// ::motion_filter.
//
// What bounds it on the card.  The data is small: a pass reads 12 Jacobian
// floats, 2 residual floats and 1 label per pixel, 60 B/pixel or 4.6 MB at
// N = 76800 (QVGA level 0), about 1.4 us at 3.35 TB/s; ~200 flop per pixel
// and iteration is about 0.23 us per iteration at 67 TFLOP/s.  What is
// left is latency: each iteration has two grid-wide dependencies (the 6x6
// solve needs all of A^T W A before the pass-1 residuals exist; the 24x24
// solve needs every per-cluster sum before the next iteration's weights),
// each followed by a serial warp Cholesky solve.  On an H100 80GB HBM3
// (700 W) one solve at N = 76800 that converges in one iteration takes
// about 41 us on the device (chip_smoke.py): latency, not traffic.
//
// Design.  One persistent kernel, launched with cudaLaunchCooperativeKernel
// on at most as many blocks as can be co-resident, walks the whole loop
// with grid.sync() between phases: no launch and no host enqueue per
// iteration, and a converged solve leaves the loop at once, so iterations
// after convergence cost nothing.  Per solve:
//   prologue  per-tile sum|B_c|, sum|B_d| -> grid.sync -> aver_res0
//             (solver/irls.py::initial_aver_res) and the initial state;
//   iteration pass 0 (residuals from the carried twist, Cauchy x
//             segmentation weights, per-tile A^T W A (21) and A^T W b (6))
//             -> grid.sync -> 6x6 solve, convergence test ->
//             pass 1 (residuals from the new twist, per-tile per-cluster
//             sum |r_c|+|r_d| and sum r^2) -> grid.sync -> 24x24
//             segmentation solve, commit, leave when converged;
//   epilogue  est_cov = (A^T W A + 1e-12 I)^-1 * res_sq with K2's warp
//             solve against the identity (smallsolve.cuh), then the
//             motion filter of the twist (one more 6x6 warp solve), in
//             block 0.
// The small solves after each barrier run in warp 0 of EVERY block, on
// identical inputs with identical instructions, so every block holds the
// same twist, weights and exit flag in its own shared memory.  That makes
// the exit uniform across the grid (as grid.sync() requires) and needs two
// barriers per iteration instead of four (one to publish the state).
//
// Determinism.  Pixels are cut into fixed tiles of `tile` pixels; block b
// takes tiles b, b + gridDim.x, ...; each tile's partials are reduced in a
// fixed order within the block and written to its own slot, and the tile
// partials are summed serially in tile order.  So the sums do not depend
// on the grid size, no float atomics are used, and results repeat from run
// to run.  Partials cross SMs through global memory: they are read with
// ld.global.cg (L2, not the SM's non-coherent L1) from volatile asm, which
// the compiler cannot hoist across grid.sync().
//
// The Jacobian stays in the JAX package's structure-of-arrays layout
// (6, N) per term: neighbouring threads read neighbouring pixels, so every
// load is coalesced without a repack.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "smallsolve.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kK = 24;          // clusters
constexpr int kThreads = 256;   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kPI = 2;          // prologue: sum|B_c|, sum|B_d|
constexpr int kP0 = 27;         // 21 upper-triangle A^T W A + 6 A^T W b
constexpr int kP1 = kK + 1;     // 24 cluster sums + sum r^2
constexpr int kChunk = 8;       // tile partials loaded per step of a sum

// Flat output of one solve (float32); kernels/irls.py reads this layout.
constexpr int OUT_TWIST = 0;    // 6
constexpr int OUT_BSEGM = 6;    // 24
constexpr int OUT_AVER = 30;
constexpr int OUT_RESSQ = 31;
constexpr int OUT_COV = 32;     // 36, row-major 6x6
constexpr int OUT_ITERS = 68;   // iterations run
constexpr int OUT_FILT = 69;    // 6, the motion-filtered twist

__device__ __forceinline__ int tri_index(int r, int c) {
  // Row-major upper triangle of a 6x6, r <= c.
  return r * 6 - (r * (r - 1)) / 2 + (c - r);
}

// A load from L2 that the compiler keeps in place.
__device__ __forceinline__ float ld_l2(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// Column j of a (tiles, stride) array of tile partials, summed in tile
// order starting from 0.
__device__ __forceinline__ float tile_sum(const float* part, int tiles,
                                          int stride, int j) {
  float t = 0.f;
  for (int b0 = 0; b0 < tiles; b0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      v[q] = b0 + q < tiles ? ld_l2(part + (b0 + q) * stride + j) : 0.f;
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (b0 + q < tiles) t += v[q];
  }
  return t;
}

// Deterministic block reduction of NV per-thread values; thread j < NV of
// the block writes total j to dst[j].  Warp trees, then warps summed in
// order.  Ends with a barrier, so it may be called again at once.
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
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
irls_solve_kernel(const float* __restrict__ a_c,
                  const float* __restrict__ a_d,
                  const float* __restrict__ b_c,
                  const float* __restrict__ b_d,
                  const int* __restrict__ lbl, int n, int tile,
                  const float* __restrict__ b0,
                  const float* __restrict__ b_prior,
                  const float* __restrict__ lam,
                  const float* __restrict__ counts,
                  const float* __restrict__ valid_count,
                  const float* __restrict__ reg,
                  const float* __restrict__ kb_ptr, float kb_val,
                  const float* __restrict__ twist_old,
                  const float* __restrict__ acc_twist, float cf, float df,
                  int filter_on, float* scratch, float* __restrict__ out,
                  int max_iter, float kc, float lambda_prior,
                  float delta_thr) {
  cg::grid_group grid = cg::this_grid();
  // The solver state; every block keeps its own, identical copy.
  __shared__ float s_tw[6];          // current twist
  __shared__ float s_bext[kK + 1];   // b_segm, then 1 for the invalid label
  __shared__ float s_aver;           // current aver_res
  __shared__ int s_done;
  __shared__ float s_p0[kP0];
  const int lane = threadIdx.x & 31;
  const bool warp0 = threadIdx.x < 32;
  const int tiles = (n + tile - 1) / tile;
  float* part_init = scratch;
  float* part0 = part_init + tiles * kPI;
  float* part1 = part0 + tiles * kP0;

  // Prologue: initial_aver_res.
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    float acc[kPI] = {0.f, 0.f};
    const int end = min((t + 1) * tile, n);
    for (int i = t * tile + threadIdx.x; i < end; i += kThreads) {
      acc[0] += fabsf(b_c[i]);
      acc[1] += fabsf(b_d[i]);
    }
    block_reduce_store<kPI>(acc, part_init + t * kPI);
  }
  grid.sync();
  const float n2 = fmaxf(2.f * valid_count[0], 1.f);
  const float kb = kb_ptr != nullptr ? kb_ptr[0] : kb_val;
  if (warp0) {
    const float s = lane < kPI ? tile_sum(part_init, tiles, kPI, lane) : 0.f;
    const float sc = __shfl_sync(SF_FULL_MASK, s, 0);
    const float sd = __shfl_sync(SF_FULL_MASK, s, 1);
    if (lane < 6) s_tw[lane] = 0.f;
    if (lane < kK) s_bext[lane] = b0[lane];
    if (lane == kK) s_bext[kK] = 1.f;
    if (lane == 0) {
      s_aver = (sc + sd) / n2;
      s_done = 0;
    }
  }
  __syncthreads();

  float ata[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // warp 0: row `lane`
  float res_sq = 0.f;                              // warp 0
  bool pending = false;                            // warp 0
  int it = 0;
  while (it < max_iter) {
    // Pass 0: weighted normal equations from the carried twist.
    {
      float tw[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) tw[k] = s_tw[k];
      const float inv_c = 1.f / (kc * fmaxf(s_aver, 1e-20f));
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        float acc[kP0];
#pragma unroll
        for (int j = 0; j < kP0; ++j) acc[j] = 0.f;
        const int end = min((t + 1) * tile, n);
        for (int i = t * tile + threadIdx.x; i < end; i += kThreads) {
          float ac[6], ad[6];
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            ac[k] = a_c[k * n + i];
            ad[k] = a_d[k * n + i];
          }
          const float bc = b_c[i];
          const float bd = b_d[i];
          const float bw = fminf(fmaxf(s_bext[lbl[i]], 0.f), 1.f);
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
        block_reduce_store<kP0>(acc, part0 + t * kP0);
      }
    }
    grid.sync();

    // 6x6 odometry solve (ridge 1e-12) and convergence test.
    if (warp0) {
      if (lane < kP0) s_p0[lane] = tile_sum(part0, tiles, kP0, lane);
      __syncwarp();
      float a[8];
      float x[1];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        a[k] = (lane < 6 && k < 6)
                   ? s_p0[tri_index(min(lane, k), max(lane, k))] : 0.f;
      }
      if (lane < 6) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          ata[k] = a[k];
          if (k == lane) a[k] = a[k] + 1e-12f;  // ridge
        }
      }
      x[0] = lane < 6 ? s_p0[21 + lane] : 0.f;
      warp_chol_solve<8, 1>(a, x, 6, 1);
      float delta = lane < 6 ? fabsf(s_tw[lane] - x[0]) : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        delta = fmaxf(delta, __shfl_xor_sync(SF_FULL_MASK, delta, off));
      pending = delta < delta_thr;
      __syncwarp();
      if (lane < 6) s_tw[lane] = x[0];
    }
    __syncthreads();

    // Pass 1: residuals from the new twist, per-cluster sums.
    {
      float tw[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) tw[k] = s_tw[k];
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        float acc[kP1];
#pragma unroll
        for (int j = 0; j < kP1; ++j) acc[j] = 0.f;
        const int end = min((t + 1) * tile, n);
        for (int i = t * tile + threadIdx.x; i < end; i += kThreads) {
          float pc = 0.f, pd = 0.f;
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            pc += tw[k] * a_c[k * n + i];
            pd += tw[k] * a_d[k * n + i];
          }
          const float rc = pc - b_c[i];
          const float rd = pd - b_d[i];
          const float ress = fabsf(rc) + fabsf(rd);
          const int l = lbl[i];
#pragma unroll
          for (int k = 0; k < kK; ++k) acc[k] += (l == k) ? ress : 0.f;
          acc[kK] += rc * rc + rd * rd;
        }
        block_reduce_store<kP1>(acc, part1 + t * kP1);
      }
    }
    grid.sync();

    // 24x24 segmentation solve (SegmentationBackground.cpp:133-174, the
    // maths of solver/segmentation.py::solve_segm_iteration), commit.
    if (warp0) {
      const float sk = lane < kP1 ? tile_sum(part1, tiles, kP1, lane) : 0.f;
      float tot = lane < kK ? sk : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tot += __shfl_down_sync(SF_FULL_MASK, tot, off);
      tot = __shfl_sync(SF_FULL_MASK, tot, 0);
      res_sq = __shfl_sync(SF_FULL_MASK, sk, kK);
      const float new_aver = tot / n2;
      const float aver = s_aver;
      const float repr = fmaxf(0.001f, aver);
      const float mult = 1.f / (kc * fmaxf(aver, 1e-20f));
      const float tf = kb * repr * mult;
      const float fixed = log1pf(tf * tf);
      float ad = 0.f, rhs = 0.f;
      if (lane < kK) {
        const float arl = sk / (2.f * (counts[lane] + 1.f));
        const float bp = b_prior[lane];
        const float lt = lam[lane];
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
      if (lane < kK) s_bext[lane] = fminf(fmaxf(x[0], -1.f), 2.f);
      if (lane == 0) {
        s_aver = new_aver;
        s_done = pending ? 1 : 0;
      }
    }
    __syncthreads();
    ++it;
    if (s_done) break;  // the same value in every block
  }

  // Epilogue: outputs of the last executed iteration, est_cov, and the
  // motion filter of the twist.
  if (blockIdx.x == 0 && warp0) {
    float a[8];
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] = (lane < 6 && k < 6) ? ata[k] : 0.f;
      if (k == lane && lane < 6) a[k] = a[k] + 1e-12f;  // ridge
      x[k] = (lane < 6 && k == lane) ? 1.f : 0.f;
    }
    warp_chol_solve<8, 8>(a, x, 6, 6);
    const float tw = lane < 6 ? s_tw[lane] : 0.f;
    if (lane < 6) {
#pragma unroll
      for (int k = 0; k < 6; ++k) out[OUT_COV + lane * 6 + k] = x[k] * res_sq;
      out[OUT_TWIST + lane] = tw;
    }
    if (lane < kK) out[OUT_BSEGM + lane] = s_bext[lane];
    if (lane == 0) {
      out[OUT_AVER] = s_aver;
      out[OUT_RESSQ] = res_sq;
      out[OUT_ITERS] = static_cast<float>(it);
    }
    // Motion filter (FrontEnd.cpp:713-756; solver/irls.py::motion_filter):
    // with C = est_cov and k = twist_old - accumulated twist,
    // filtered = ((1 + df) I + cf C)^-1 (twist + cf C k + df k).
    float filt[1] = {tw};
    if (filter_on) {
      const float kv = lane < 6 ? twist_old[lane] - acc_twist[lane] : 0.f;
      float m[8];
      float ck = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float kk = __shfl_sync(SF_FULL_MASK, kv, k);
        const float c = (lane < 6 && k < 6) ? x[k] * res_sq : 0.f;
        m[k] = (k == lane && lane < 6 ? 1.f + df : 0.f) + cf * c;
        ck += c * kk;
      }
      filt[0] = lane < 6 ? tw + cf * ck + df * kv : 0.f;
      warp_chol_solve<8, 1>(m, filt, 6, 1);
    }
    if (lane < 6) out[OUT_FILT + lane] = filt[0];
  }
}

}  // namespace

extern "C" {

// The most blocks of the solve kernel that can be co-resident on `device`
// (the cap of a cooperative launch), 0 when the device cannot launch
// cooperatively, or -(CUDA error).
int sf_irls_max_blocks(int device) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                         device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, irls_solve_kernel, kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return coop ? per_sm * sms : 0;
}

// One IRLS solve.  a_c, a_d (6, n); b_c, b_d (n); lbl (n) int32 in
// [0, 24]; b0, b_prior, lam, counts (24); valid_count (1); reg (24, 24);
// kb from kb_ptr (1) when it is not null, else kb.  filter_on != 0 runs
// the motion filter with weights cf, df on twist_old and acc_twist (6
// each, the accumulated twist of the level); else both may be null and
// the filtered twist is the twist.  scratch holds
// tiles * (2 + 27 + 25) floats with tiles = ceil(n / tile); grid <=
// sf_irls_max_blocks() and <= tiles.  Writes out (75): twist 6, b_segm
// 24, aver_res, res_sq, est_cov 36, iterations, filtered twist 6.
// Returns the launch's error or cudaGetLastError(), 0 on success.
int sf_irls_solve(const float* a_c, const float* a_d, const float* b_c,
                  const float* b_d, const int* lbl, int n, int tile, int grid,
                  const float* b0, const float* b_prior, const float* lam,
                  const float* counts, const float* valid_count,
                  const float* reg, const float* kb_ptr, float kb,
                  const float* twist_old, const float* acc_twist, float cf,
                  float df, int filter_on, float* scratch, float* out,
                  int max_iter, float kc, float lambda_prior, float delta_thr,
                  cudaStream_t stream) {
  void* args[] = {&a_c,       &a_d,       &b_c,      &b_d,     &lbl,
                  &n,         &tile,      &b0,       &b_prior, &lam,
                  &counts,    &valid_count, &reg,    &kb_ptr,  &kb,
                  &twist_old, &acc_twist, &cf,       &df,      &filter_on,
                  &scratch,   &out,       &max_iter, &kc,      &lambda_prior,
                  &delta_thr};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(irls_solve_kernel), dim3(grid),
      dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
