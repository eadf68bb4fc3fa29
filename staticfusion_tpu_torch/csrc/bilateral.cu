// K1: the depth preprocessing of one frame in one kernel: the 13x13 (R = 6)
// bilateral filter of a millimetre depth image and the metric conversion
// of both the raw and the filtered image.
//
// Replaces staticfusion_tpu/kernels/bilateral_pallas.py:117
// bilateral_filter_mm (bodies `_kernel` and `_kernel_tiled`; the two exist
// only because of the TPU's VMEM limits, so one kernel serves QVGA and VGA
// here) and the two metricise passes around it (ops/bilateral.py
// metricise_depth_mm, called from pipeline/step.py::_preprocess).  Plain
// version: bilateral_filter_mm_plain, then metricise_depth_mm of the raw
// and of the filtered image.
//
// What bounds it on the card: the exponentials.  Each output pixel
// evaluates 169 expf, and expf takes one MUFU.EX2 (16 a clock per SM) and
// about seven FP32 instructions; the image itself is 0.3 MB (QVGA) to
// 1.2 MB (VGA), read once.  So the design cuts every instruction around
// the exponential:
//   - each thread computes kP = 2 horizontally adjacent outputs from one
//     register window per stencil row (kP + 12 floats, read from shared
//     memory as float2 without bank conflicts), not 13 * kP reads;
//   - the tile is zero-padded outside the image, so no tap tests the
//     border: an out-of-image tap adds nb * w = 0 to the weighted sum and
//     at most exp(-300^2 * kColor) = exp(-50) to the weight sum of an
//     in-range centre, whose own tap adds 1, so neither sum changes;
//   - the spatial term of a row is computed once per distance |dx| (7
//     per row), not once per tap;
//   - one warp covers 64 columns and a block 64 x 2 pixels, so QVGA and
//     VGA split into whole blocks (600 and 2400) and the 132 SMs get
//     nearly equal shares.
// On an H100 80GB HBM3 (700 W) this takes about 12 us of device time at
// QVGA and 33 us at VGA, where one output per thread with a border test
// per tap took about 19 and 51 us (chip_smoke.py's profiler phase); the
// expf bound is 3 us at QVGA.
// The tap order of the sums is the reference's (dy outer, dx inner).
// expf (not __expf), rintf (round half to even, as torch.round) and IEEE
// division (d / 1000 for metres, so raw_m is bit-identical to the plain
// version) need a build without --use_fast_math.
#include <cuda_runtime.h>

namespace {

constexpr int kR = 6;
constexpr int kP = 2;                // outputs per thread, along a row
constexpr int kBX = 32;              // threads per row of the block
constexpr int kBY = 2;               // rows of the block
constexpr int kOX = kBX * kP;        // output columns per block
constexpr int kTX = kOX + 2 * kR;    // tile columns (even: float2 rows)
constexpr int kTY = kBY + 2 * kR;    // tile rows
constexpr int kWin = kP + 2 * kR;    // register window per stencil row
constexpr float kSpace = 0.024691358f;  // sigma_space2_inv_half
constexpr float kColor = 0.000555556f;  // sigma_color2_inv_half

__device__ __forceinline__ float metres(float mm, float min_mm,
                                        float max_mm) {
  return (mm >= min_mm && mm <= max_mm) ? mm / 1000.f : 0.f;
}

// filt_mm, raw_m and filt_m may each be null (not written).
__global__ void __launch_bounds__(kBX * kBY)
preprocess_kernel(const float* __restrict__ in, float* __restrict__ filt_mm,
                  float* __restrict__ raw_m, float* __restrict__ filt_m,
                  int rows, int cols, float min_mm, float max_mm) {
  __shared__ __align__(16) float tile[kTY][kTX];
  const int x0 = blockIdx.x * kOX;
  const int y0 = blockIdx.y * kBY;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < kTX * kTY; i += kBX * kBY) {
    const int ty = i / kTX;
    const int tx = i % kTX;
    const int gy = y0 + ty - kR;
    const int gx = x0 + tx - kR;
    tile[ty][tx] = (gy >= 0 && gy < rows && gx >= 0 && gx < cols)
                       ? in[gy * cols + gx]
                       : 0.f;
  }
  __syncthreads();
  const int y = y0 + threadIdx.y;
  const int cx = threadIdx.x * kP;  // first output's tile column - kR
  float d[kP], s1[kP], s2[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    d[p] = tile[threadIdx.y + kR][cx + kR + p];
    s1[p] = 0.f;
    s2[p] = 0.f;
  }
#pragma unroll 1
  for (int dy = -kR; dy <= kR; ++dy) {
    float win[kWin];
    const float2* row =
        reinterpret_cast<const float2*>(&tile[threadIdx.y + kR + dy][cx]);
#pragma unroll
    for (int j = 0; j < kWin / 2; ++j) {
      const float2 v = row[j];
      win[2 * j] = v.x;
      win[2 * j + 1] = v.y;
    }
    float sp[kR + 1];  // spatial term at |dx| = 0..kR of this row
    const float dy2 = static_cast<float>(dy * dy);
#pragma unroll
    for (int a = 0; a <= kR; ++a)
      sp[a] = (dy2 + static_cast<float>(a * a)) * kSpace;
#pragma unroll
    for (int dx = -kR; dx <= kR; ++dx) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float nb = win[p + kR + dx];
        const float diff = d[p] - nb;
        const float w =
            expf(-(sp[dx < 0 ? -dx : dx] + diff * diff * kColor));
        s1[p] = s1[p] + nb * w;
        s2[p] = s2[p] + w;
      }
    }
  }
  if (y >= rows) return;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int x = x0 + cx + p;
    if (x >= cols) continue;
    const bool centre_in = d[p] >= min_mm && d[p] <= max_mm;
    const float o = centre_in ? rintf(s1[p] / fmaxf(s2[p], 1e-20f)) : 0.f;
    const int i = y * cols + x;
    if (filt_mm != nullptr) filt_mm[i] = o;
    if (raw_m != nullptr) raw_m[i] = metres(d[p], min_mm, max_mm);
    if (filt_m != nullptr) filt_m[i] = metres(o, min_mm, max_mm);
  }
}

}  // namespace

extern "C" {

// From in (rows, cols) millimetres: filt_mm = bilateral(in) (centres outside
// [min_mm, max_mm] output 0), raw_m = metres(in), filt_m =
// metres(filt_mm), where metres(v) = v / 1000 inside [min_mm, max_mm] and 0
// outside.  All row-major float32 on the device; a null output is not
// written.  Returns cudaGetLastError().
int sf_preprocess(const float* in, float* filt_mm, float* raw_m,
                  float* filt_m, int rows, int cols, float min_mm,
                  float max_mm, cudaStream_t stream) {
  dim3 block(kBX, kBY);
  dim3 grid((cols + kOX - 1) / kOX, (rows + kBY - 1) / kBY);
  preprocess_kernel<<<grid, block, 0, stream>>>(in, filt_mm, raw_m, filt_m,
                                                rows, cols, min_mm, max_mm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
