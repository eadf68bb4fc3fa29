// Warp-level Cholesky solve for one small SPD system (n <= 32), shared by
// the standalone solve kernels (smallsolve.cu) and the IRLS kernel (irls.cu).
//
// Replaces the value-level body `_chol_solve_body` of
// staticfusion_tpu/kernels/smallsolve_pallas.py.  One warp holds the
// system: lane i keeps row i of M (and of the right-hand side) in
// registers; the pivot column travels by __shfl_sync.  The arithmetic
// follows the Pallas body: right-looking Cholesky with the
// max(A[j][j], 1e-30) pivot floor, then forward and back substitution,
// divisions where it divides.
#pragma once

#define SF_FULL_MASK 0xffffffffu

// Solve M x = b in place.  On entry a[] is the lane's row of M (ridge
// already added) and x[] the lane's row of b; on exit x[] holds the
// lane's row of the solution.  Lanes >= n must pass zero rows.  n <= NMAX,
// m <= MMAX; both are uniform across the warp.
template <int NMAX, int MMAX>
__device__ __forceinline__ void warp_chol_solve(float (&a)[NMAX],
                                                float (&x)[MMAX], int n,
                                                int m) {
  const int lane = threadIdx.x & 31;
  float l[NMAX];   // row `lane` of L
  float lc[NMAX];  // column `lane` of L
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    l[k] = 0.f;
    lc[k] = 0.f;
  }
  // Right-looking factorisation: n masked rank-1 updates.
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) {
      const float piv = __shfl_sync(SF_FULL_MASK, a[j], j);
      const float dj = sqrtf(fmaxf(piv, 1e-30f));
      const float c = (lane >= j && lane < n) ? a[j] / dj : 0.f;
      l[j] = c;
#pragma unroll
      for (int k = 0; k < NMAX; ++k) {
        const float ck = __shfl_sync(SF_FULL_MASK, c, k);
        a[k] = a[k] - c * ck;
        if (lane == j) lc[k] = ck;
      }
    }
  }
  // Forward substitution L y = b.
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    if (i < n) {
      const float dii = __shfl_sync(SF_FULL_MASK, l[i], i);
#pragma unroll
      for (int c = 0; c < MMAX; ++c) {
        if (c < m) {
          const float yi = __shfl_sync(SF_FULL_MASK, x[c], i) / dii;
          if (lane == i) x[c] = yi;
          else if (lane > i) x[c] = x[c] - l[i] * yi;
        }
      }
    }
  }
  // Back substitution L^T x = y (row i of L^T is column i of L).
#pragma unroll
  for (int i = NMAX - 1; i >= 0; --i) {
    if (i < n) {
      const float dii = __shfl_sync(SF_FULL_MASK, l[i], i);
#pragma unroll
      for (int c = 0; c < MMAX; ++c) {
        if (c < m) {
          const float xi = __shfl_sync(SF_FULL_MASK, x[c], i) / dii;
          if (lane == i) x[c] = xi;
          else if (lane < i) x[c] = x[c] - lc[i] * xi;
        }
      }
    }
  }
}
