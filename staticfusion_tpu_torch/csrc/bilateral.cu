// K1: 13x13 (R = 6) bilateral filter of a millimetre depth image.
//
// Replaces staticfusion_tpu/kernels/bilateral_pallas.py::bilateral_filter_mm
// (bodies `_kernel` and `_kernel_tiled`; the two exist only because of the
// TPU's VMEM limits, so one kernel serves QVGA and VGA here).
//
// What bounds it on the card: arithmetic, not memory.  Each output pixel
// reads 169 neighbours and evaluates 169 expf; the image itself is 0.3 MB
// (QVGA) to 1.2 MB (VGA).  The design keeps every neighbour read on chip:
// a block stages a 32x8 output tile plus its +-6 halo (44x20 floats) in
// shared memory once, then each thread walks its 169 taps from shared
// memory in the reference's tap order (dy outer, dx inner).  expf (not
// __expf) and rintf (round half to even, as jnp.round) keep the result
// within the <= 1 mm gate of the plain version; build without
// --use_fast_math.
#include <cuda_runtime.h>

namespace {

constexpr int kR = 6;
constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kTX = kBX + 2 * kR;
constexpr int kTY = kBY + 2 * kR;
constexpr float kSpace = 0.024691358f;  // sigma_space2_inv_half
constexpr float kColor = 0.000555556f;  // sigma_color2_inv_half

__global__ void bilateral_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int rows, int cols,
                                 float min_mm, float max_mm) {
  __shared__ float tile[kTY][kTX];
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  for (int i = threadIdx.y * kBX + threadIdx.x; i < kTX * kTY;
       i += kBX * kBY) {
    const int ty = i / kTX;
    const int tx = i % kTX;
    const int gy = y0 + ty - kR;
    const int gx = x0 + tx - kR;
    tile[ty][tx] = (gy >= 0 && gy < rows && gx >= 0 && gx < cols)
                       ? in[gy * cols + gx]
                       : 0.f;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= cols || y >= rows) return;
  const float d = tile[threadIdx.y + kR][threadIdx.x + kR];
  float s1 = 0.f;
  float s2 = 0.f;
  for (int dy = -kR; dy <= kR; ++dy) {
    const bool row_in = (y + dy >= 0) && (y + dy < rows);
#pragma unroll
    for (int dx = -kR; dx <= kR; ++dx) {
      // Taps outside the image carry weight 0 (the plain version's pad
      // mask); in-image zero-depth taps take part.
      if (!row_in || x + dx < 0 || x + dx >= cols) continue;
      const float nb = tile[threadIdx.y + kR + dy][threadIdx.x + kR + dx];
      const float space2 = static_cast<float>(dx * dx + dy * dy);
      const float diff = d - nb;
      const float color2 = diff * diff;
      const float w = expf(-(space2 * kSpace + color2 * kColor));
      s1 = s1 + nb * w;
      s2 = s2 + w;
    }
  }
  const float o = rintf(s1 / fmaxf(s2, 1e-20f));
  out[y * cols + x] = (d >= min_mm && d <= max_mm) ? o : 0.f;
}

}  // namespace

extern "C" {

// out (rows, cols) = bilateral(in), both row-major float32 on the device.
// Centres outside [min_mm, max_mm] output 0.  Returns cudaGetLastError().
int sf_bilateral(const float* in, float* out, int rows, int cols,
                 float min_mm, float max_mm, cudaStream_t stream) {
  dim3 block(kBX, kBY);
  dim3 grid((cols + kBX - 1) / kBX, (rows + kBY - 1) / kBY);
  bilateral_kernel<<<grid, block, 0, stream>>>(in, out, rows, cols, min_mm,
                                               max_mm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
