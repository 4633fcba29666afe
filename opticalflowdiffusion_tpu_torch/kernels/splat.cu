// Deterministic forward splat, mode linear_unn, scale 1, offset 0 (Hopper, sm_90a).
//
//   out[b, :, y', x'] = sum over sources (y, x) and their four bilinear corners
//                       (y', x') around (y + dy, x + dx) of w * [x * metric, metric]
//
// Replaces the JAX package's opticalflowdiffusion_tpu/ops/splat.py::_splat_core
// (forward _splat_fwd_impl), which is not a Pallas kernel but an XLA scatter
// (sorted segment sums or one-hot contractions) that gives the same bits on
// every run.  Corners outside the image and non-finite targets drop out.
//
// Determinism: a float atomicAdd sums in whatever order the atomics land, so
// its last bits change from run to run.  Here every finite term w * v is
// rounded once to a 64-bit fixed-point integer and added with an integer
// atomic, and integer addition is associative, so the sums are the same bits
// whatever the order.  The scale is a power of two per channel, taken from the
// channel's largest finite |v| (pass 1) so that H * W terms of that size cannot
// overflow 2^62: the resolution is max|v| * H * W * 2^-62, at least 2^40 finer
// than max|v| at 448x1024, finer than the float32 rounding of such a sum.
// Non-finite terms (an inf or NaN input) go to a float accumulator of their
// own, whose sum (inf, -inf or NaN) does not depend on the order either, and
// take the place of the finite sum.  Pass 3 converts each sum to float32 and
// casts it once to the output dtype.  Sorting by target (as the JAX package
// does) would give a float32 sum in a fixed order, at the price of a sort.
//
// Bound on the H100: bytes (x, metric and flow read once, the output written
// once) over 3.35 TB/s.  The passes also read x and metric twice, and the
// 64-bit accumulator is written by atomics and read once; the atomics on
// colliding targets are the expected cost above the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, bf16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

// channel c of [x * metric, metric] at pixel p of batch element b, rounded to
// TX as the plain version's x * metric is
template <typename TX>
__device__ __forceinline__ float value(const TX* __restrict__ x, const TX* __restrict__ metric,
                                       int b, int c, int C, long long HW, long long p) {
  const float mv = to_f(metric[b * HW + p]);
  if (c == C) return mv;
  return round_to(__fmul_rn(to_f(x[((long long)b * C + c) * HW + p]), mv), TX());
}

// fixed-point scale 2^e of channel c: e = 62 - log2hw - exponent(max|v|)
__device__ __forceinline__ int scale_exp(const unsigned* maxbits, int c, int log2hw) {
  int ex = 0;
  frexpf(__uint_as_float(maxbits[c]), &ex);
  return 62 - log2hw - ex;
}

// Pass 1.  grid (blocks, C + 1): maxbits[c] = bits of max finite |v| (as
// unsigned: the order of non-negative floats), zero on entry.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
splat_max_kernel(const TX* __restrict__ x, const TX* __restrict__ metric, int C, long long HW,
                 long long total, unsigned* __restrict__ maxbits) {
  const int c = blockIdx.y;
  float mx = 0.f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int b = (int)(i / HW);
    const float a = fabsf(value(x, metric, b, c, C, HW, i - b * HW));
    if (a <= 3.402823466e38f) mx = fmaxf(mx, a);
  }
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) atomicMax(maxbits + c, __float_as_uint(mx));
}

// Pass 2.  One thread per source pixel: its four corners, every channel.
// acc (B, C + 1, H, W) int64 and special (B, C + 1, H, W) f32, zero on entry.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
splat_scatter_kernel(const TX* __restrict__ x, const TX* __restrict__ metric,
                     const float* __restrict__ flow, int C, int H, int W, long long total,
                     const unsigned* __restrict__ maxbits, int log2hw,
                     unsigned long long* __restrict__ acc, float* __restrict__ special) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long HW = (long long)H * W;
  const int b = (int)(i / HW);
  const long long p = i - b * HW;
  const int py = (int)(p / W), px = (int)(p - (long long)py * W);
  const float* fl = flow + (long long)b * 2 * HW;
  const float fx = __fadd_rn((float)px, fl[p]);
  const float fy = __fadd_rn((float)py, fl[HW + p]);
  if (!isfinite(fx) || !isfinite(fy)) return;
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float wx1 = __fsub_rn(fx, x0), wy1 = __fsub_rn(fy, y0);
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  const float cxs[4] = {x0, __fadd_rn(x0, 1.f), x0, __fadd_rn(x0, 1.f)};
  const float cys[4] = {y0, y0, __fadd_rn(y0, 1.f), __fadd_rn(y0, 1.f)};
  const float ws[4] = {__fmul_rn(wx0, wy0), __fmul_rn(wx1, wy0), __fmul_rn(wx0, wy1),
                       __fmul_rn(wx1, wy1)};
  long long idx[4];
  bool in[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    in[k] = cxs[k] >= 0.f && cxs[k] < (float)W && cys[k] >= 0.f && cys[k] < (float)H;
    idx[k] = in[k] ? (long long)cys[k] * W + (long long)cxs[k] : 0;
  }
  const int C1 = C + 1;
  for (int c = 0; c < C1; ++c) {
    const float val = value(x, metric, b, c, C, HW, p);
    const double sc = ldexp(1.0, scale_exp(maxbits, c, log2hw));
    const long long base = ((long long)b * C1 + c) * HW;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!in[k]) continue;
      const float term = __fmul_rn(val, ws[k]);
      if (isfinite(term)) {
        const long long qv = __double2ll_rn(__dmul_rn((double)term, sc));
        atomicAdd(acc + base + idx[k], (unsigned long long)qv);
      } else {
        atomicAdd(special + base + idx[k], term);
      }
    }
  }
}

// Pass 3.  out = the non-finite sum where there is one, else acc / 2^e,
// rounded to float32 and cast once to TX.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
splat_finish_kernel(const unsigned long long* __restrict__ acc,
                    const float* __restrict__ special, const unsigned* __restrict__ maxbits,
                    int C1, long long HW, long long total, int log2hw, TX* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)((i / HW) % C1);
  const float sp = special[i];
  float r;
  if (sp != 0.f || isnan(sp)) {
    r = sp;
  } else {
    const double inv = ldexp(1.0, -scale_exp(maxbits, c, log2hw));
    r = __double2float_rn(__dmul_rn(__ll2double_rn((long long)acc[i]), inv));
  }
  put(out + i, r);
}

template <typename TX>
int launch(const void* x, const void* metric, const float* flow, unsigned* maxbits,
           unsigned long long* acc, float* special, void* out, int B, int C, int H, int W,
           int log2hw, cudaStream_t st) {
  const long long HW = (long long)H * W, total = (long long)B * HW;
  const TX* xp = static_cast<const TX*>(x);
  const TX* mp = static_cast<const TX*>(metric);
  const long long blocks = (total + THREADS - 1) / THREADS;
  const int max_blocks = (int)(blocks < 1024 ? blocks : 1024);
  splat_max_kernel<TX><<<dim3(max_blocks, C + 1), THREADS, 0, st>>>(xp, mp, C, HW, total,
                                                                    maxbits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  splat_scatter_kernel<TX><<<(unsigned)blocks, THREADS, 0, st>>>(
      xp, mp, flow, C, H, W, total, maxbits, log2hw, acc, special);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_out = total * (C + 1);
  splat_finish_kernel<TX><<<(unsigned)((n_out + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      acc, special, maxbits, C + 1, HW, n_out, log2hw, static_cast<TX*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, C, H, W) and metric (B, 1, H, W) in one dtype (x_bf16: 1 = bfloat16,
// 0 = float32), flow (B, 2, H, W) float32, all contiguous; out (B, C + 1, H, W)
// in x's dtype.  Scratch, zeroed by the caller: maxbits (C + 1) uint32, acc
// (B, C + 1, H, W) int64, special (B, C + 1, H, W) float32.  log2hw =
// ceil(log2(H * W)).  Returns a cudaError_t (0 = launched).
int ofd_splat(const void* x, const void* metric, const void* flow, int x_bf16,
              void* maxbits, void* acc, void* special, void* out, int B, int C, int H,
              int W, int log2hw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fl = static_cast<const float*>(flow);
  unsigned* mb = static_cast<unsigned*>(maxbits);
  unsigned long long* ac = static_cast<unsigned long long*>(acc);
  float* sp = static_cast<float*>(special);
  return x_bf16 ? launch<bf16>(x, metric, fl, mb, ac, sp, out, B, C, H, W, log2hw, st)
                : launch<float>(x, metric, fl, mb, ac, sp, out, B, C, H, W, log2hw, st);
}

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
