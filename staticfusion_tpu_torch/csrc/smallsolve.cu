// K2: small SPD solve and inverse, (M + ridge I)^-1 B, one warp per system.
//
// Replaces staticfusion_tpu/kernels/smallsolve_pallas.py::spd_solve and
// ::spd_inverse (body `_chol_solve_body`).
//
// What bounds it on the card: nothing but latency.  A 6x6 or 24x24 system
// is a few hundred dependent flops; the call costs a launch and a serial
// chain of warp shuffles.  The design answers with the smallest unit that
// holds the whole system in registers: one warp, lane i = row i (n <= 32),
// no shared memory, no block-level synchronisation.  The same device
// function runs inside the IRLS kernel (irls.cu), where the 6x6 and 24x24
// solves, the covariance inverse and the motion filter's 6x6 solve cost
// no launch of their own, so the main path does not launch this kernel.
#include <cuda_runtime.h>

#include "smallsolve.cuh"

namespace {

__global__ void spd_solve_kernel(const float* __restrict__ M,
                                 const float* __restrict__ B,
                                 float* __restrict__ X, int n, int m,
                                 float ridge, int identity_rhs) {
  const int lane = threadIdx.x;
  float a[32];
  float x[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    a[k] = (lane < n && k < n) ? M[lane * n + k] : 0.f;
    if (identity_rhs) {
      x[k] = (lane < n && k == lane) ? 1.f : 0.f;
    } else {
      x[k] = (lane < n && k < m) ? B[lane * m + k] : 0.f;
    }
  }
  if (ridge != 0.f) {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k == lane && lane < n) a[k] = a[k] + ridge;
  }
  warp_chol_solve<32, 32>(a, x, n, m);
  if (lane < n) {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < m) X[lane * m + k] = x[k];
  }
}

}  // namespace

extern "C" {

// X (n, m) = (M + ridge I)^-1 B for M (n, n), B (n, m), n, m <= 32; all
// row-major float32 on the device.  identity_rhs != 0 ignores B and solves
// against the identity (m must equal n).  Returns cudaGetLastError().
int sf_spd_solve(const float* M, const float* B, float* X, int n, int m,
                 float ridge, int identity_rhs, cudaStream_t stream) {
  spd_solve_kernel<<<1, 32, 0, stream>>>(M, B, X, n, m, ridge, identity_rhs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
