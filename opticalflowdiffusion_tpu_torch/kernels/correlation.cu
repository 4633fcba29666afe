// PWC-Net's 9x9 local cost volume and its two cotangents (Hopper, sm_90a).
//
//   out[b, p, y, x] = sum_c a[b, c, y, x] * f[b, c, y + dy, x + dx]
//
// for the 81 displacements (dy, dx) = (i - 4, j - 4), zero outside the
// frame: the reference's spatial_correlation_sampler (kernel_size 1,
// patch_size 9).  Replaces the JAX package's
// opticalflowdiffusion_tpu/ops/correlation.py::local_correlation (:28),
// which is XLA there (an unfold of the 9x9 patches, then an einsum), not
// Pallas.  The output channel p of a displacement follows the direction
// code: 0 p = i * 9 + j (JAX's order), 1 PWCNet's "fwd" reorder
// p = (8 - j) * 9 + (8 - i) (a transpose and flip of the grid), 2 its
// "bwd" reorder p = j * 9 + i (a transpose); ops/correlation.py's
// reorder_index is the same permutation, and its tests hold the formula to
// it.
//
// Features are (B, C, H, W) contiguous, float32 or bfloat16; every sum is
// in float32 and rounded once to the features' dtype.
//
// - Forward (corr_fwd_kernel): a CTA takes a row segment of 32 pixels and
//   walks the channels 16 at a time, staging a's segment and the 9-row,
//   40-column halo of f in shared memory (25 KB).  Warp i owns the
//   displacement row dy = i - 4, lane the pixel, and keeps its 9 sums over
//   dx in registers: out reads each feature of a once and each of f 9 x
//   40 / 32 times from L2, and writes the 81 products once.
// - The cotangents are gathers with no atomics, so a repeat gives the same
//   bits:
//     grad_a[c, y, x]   = sum_p g[p, y, x] * f[c, y + dy, x + dx]
//     grad_f[c, y', x'] = sum_p g[p, y' - dy, x' - dx] * a[c, y' - dy, x' - dx]
//   corr_bwd_a_kernel stages g's 81 channels of the segment (by
//   displacement) once and f's halo per 16 channels; corr_bwd_f_kernel
//   stages, for each displacement, the 40 columns of g that reach the
//   segment (g[p(dy, dx), y' - dy, x0 - 4 .. x0 + 35]) once, and a's
//   9-row halo per 16 channels.  A warp takes channels w, w + 8 of a
//   chunk, a lane a pixel, and sums the 81 terms in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int P = 9;          // patch side
constexpr int R = P / 2;      // patch radius
constexpr int TX = 32;        // pixels of a row segment (a CTA)
constexpr int HW_ = TX + 2 * R;  // halo columns
constexpr int CC = 16;        // channels staged at a time
constexpr int FWD_THREADS = 32 * P;   // one warp a displacement row
constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// The output channel of displacement (i, j) under the direction code.
__device__ __forceinline__ int channel(int i, int j, int dir) {
  if (dir == 1) return (P - 1 - j) * P + (P - 1 - i);
  if (dir == 2) return j * P + i;
  return i * P + j;
}

// f[c0 + c, y + i - R, x0 + k - R] for c < CC, i < P, k < HW_ (zero outside
// the frame or past the last channel) into halo[c][i][k].
template <typename T>
__device__ __forceinline__ void stage_halo(float (*halo)[P][HW_], const T* f, int c0, int cc,
                                           int y, int x0, int H, int W, size_t HW, int sign) {
  for (int t = threadIdx.x; t < CC * P * HW_; t += blockDim.x) {
    const int c = t / (P * HW_), rem = t % (P * HW_), i = rem / HW_, k = rem % HW_;
    const int yy = y + sign * (i - R), xx = x0 + k - R;
    float v = 0.f;
    if (c < cc && yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = to_f(f[(size_t)(c0 + c) * HW + (size_t)yy * W + xx]);
    halo[c][i][k] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
corr_fwd_kernel(const T* __restrict__ a, const T* __restrict__ f, T* __restrict__ out, int C,
                int H, int W, int dir) {
  __shared__ float as[CC][TX];
  __shared__ float fs[CC][P][HW_];
  const int x0 = blockIdx.x * TX, y = blockIdx.y, n = blockIdx.z;
  const int lane = threadIdx.x & 31, i = threadIdx.x >> 5;
  const size_t HW = (size_t)H * W;
  const T* an = a + (size_t)n * C * HW;
  const T* fn = f + (size_t)n * C * HW;
  float acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cc = min(CC, C - c0);
    for (int t = threadIdx.x; t < CC * TX; t += blockDim.x) {
      const int c = t / TX, k = t % TX, x = x0 + k;
      as[c][k] = (c < cc && x < W) ? to_f(an[(size_t)(c0 + c) * HW + (size_t)y * W + x]) : 0.f;
    }
    stage_halo(fs, fn, c0, cc, y, x0, H, W, HW, 1);
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      const float av = as[c][lane];
#pragma unroll
      for (int j = 0; j < P; ++j) acc[j] = fmaf(av, fs[c][i][lane + j], acc[j]);
    }
    __syncthreads();
  }
  const int x = x0 + lane;
  if (x < W) {
    T* on = out + (size_t)n * P * P * HW + (size_t)y * W + x;
#pragma unroll
    for (int j = 0; j < P; ++j) on[(size_t)channel(i, j, dir) * HW] = from_f<T>(acc[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
corr_bwd_a_kernel(const T* __restrict__ f, const T* __restrict__ g, T* __restrict__ grad_a,
                  int C, int H, int W, int dir) {
  __shared__ float gs[P * P][TX];       // by displacement i * P + j
  __shared__ float fs[CC][P][HW_];
  const int x0 = blockIdx.x * TX, y = blockIdx.y, n = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t HW = (size_t)H * W;
  const T* fn = f + (size_t)n * C * HW;
  const T* gn = g + (size_t)n * P * P * HW;
  for (int t = threadIdx.x; t < P * P * TX; t += blockDim.x) {
    const int d = t / TX, k = t % TX, x = x0 + k;
    gs[d][k] = x < W ? to_f(gn[(size_t)channel(d / P, d % P, dir) * HW + (size_t)y * W + x])
                     : 0.f;
  }
  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cc = min(CC, C - c0);
    stage_halo(fs, fn, c0, cc, y, x0, H, W, HW, 1);
    __syncthreads();
    for (int c = w; c < cc; c += BWD_WARPS) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) s = fmaf(gs[i * P + j][lane], fs[c][i][lane + j], s);
      const int x = x0 + lane;
      if (x < W) grad_a[((size_t)n * C + c0 + c) * HW + (size_t)y * W + x] = from_f<T>(s);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
corr_bwd_f_kernel(const T* __restrict__ a, const T* __restrict__ g, T* __restrict__ grad_f,
                  int C, int H, int W, int dir) {
  // gs[i][j][k] = g[p(i, j), y - (i - R), x0 - R + k]; as_[c][i][k] = a[c, y - (i - R), x0 - R + k]
  __shared__ float gs[P][P][HW_];
  __shared__ float as_[CC][P][HW_];
  const int x0 = blockIdx.x * TX, y = blockIdx.y, n = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t HW = (size_t)H * W;
  const T* an = a + (size_t)n * C * HW;
  const T* gn = g + (size_t)n * P * P * HW;
  for (int t = threadIdx.x; t < P * P * HW_; t += blockDim.x) {
    const int i = t / (P * HW_), rem = t % (P * HW_), j = rem / HW_, k = rem % HW_;
    const int yy = y - (i - R), xx = x0 + k - R;
    float v = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = to_f(gn[(size_t)channel(i, j, dir) * HW + (size_t)yy * W + xx]);
    gs[i][j][k] = v;
  }
  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cc = min(CC, C - c0);
    stage_halo(as_, an, c0, cc, y, x0, H, W, HW, -1);
    __syncthreads();
    for (int c = w; c < cc; c += BWD_WARPS) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int k = lane + 2 * R - j;   // x' - dx - (x0 - R)
          s = fmaf(gs[i][j][k], as_[c][i][k], s);
        }
      const int x = x0 + lane;
      if (x < W) grad_f[((size_t)n * C + c0 + c) * HW + (size_t)y * W + x] = from_f<T>(s);
    }
    __syncthreads();
  }
}

bool bad_shape(int B, int C, int H, int W, int dir) {
  return B < 1 || C < 1 || H < 1 || W < 1 || B > 65535 || H > 65535 || dir < 0 || dir > 2;
}

template <typename T>
int launch_fwd(const void* a, const void* f, void* out, int B, int C, int H, int W, int dir,
               cudaStream_t st) {
  const dim3 grid((W + TX - 1) / TX, H, B);
  corr_fwd_kernel<T><<<grid, FWD_THREADS, 0, st>>>(static_cast<const T*>(a),
                                                   static_cast<const T*>(f),
                                                   static_cast<T*>(out), C, H, W, dir);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* a, const void* f, const void* g, void* ga, void* gf, int B, int C,
               int H, int W, int dir, cudaStream_t st) {
  const dim3 grid((W + TX - 1) / TX, H, B);
  corr_bwd_a_kernel<T><<<grid, BWD_THREADS, 0, st>>>(static_cast<const T*>(f),
                                                     static_cast<const T*>(g),
                                                     static_cast<T*>(ga), C, H, W, dir);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  corr_bwd_f_kernel<T><<<grid, BWD_THREADS, 0, st>>>(static_cast<const T*>(a),
                                                     static_cast<const T*>(g),
                                                     static_cast<T*>(gf), C, H, W, dir);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward.  a, f (B, C, H, W) contiguous (x_bf16: 1 = bfloat16, 0 =
// float32); out (B, 81, H, W) in their dtype, channels in the order of dir
// (0 JAX's, 1 fwd, 2 bwd).  One launch.  Returns a cudaError_t (0 =
// launched).
int ofd_corr_fwd(const void* a, const void* f, void* out, int x_bf16, int B, int C, int H, int W,
                 int dir, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(B, C, H, W, dir)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_fwd<bf16>(a, f, out, B, C, H, W, dir, st)
                : launch_fwd<float>(a, f, out, B, C, H, W, dir, st);
}

// Backward.  a, f as above, g (B, 81, H, W) in their dtype (the cotangent
// of ofd_corr_fwd's out under the same dir); grad_a, grad_f (B, C, H, W) in
// their dtype.  Two launches.
int ofd_corr_bwd(const void* a, const void* f, const void* g, void* grad_a, void* grad_f,
                 int x_bf16, int B, int C, int H, int W, int dir, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(B, C, H, W, dir)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_bwd<bf16>(a, f, g, grad_a, grad_f, B, C, H, W, dir, st)
                : launch_bwd<float>(a, f, g, grad_a, grad_f, B, C, H, W, dir, st);
}

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
