// Deterministic bilinear splat and its backward gathers (Hopper, sm_90a).
//
//   out[b, c, y', x'] = sum over sources (y, x) and the four bilinear corners
//                       (y', x') around T(x + dx, y + dy) of w * inp[b, c, y, x]
//
// on an output of (Ho, Wo) = (H / scale, W / scale), where T is the fused
// integer-scale downsample with its phase offset and edge stretch.  Replaces
// the JAX package's opticalflowdiffusion_tpu/ops/splat.py::_splat_core:
// the forward _splat_fwd_impl (:363) and its VJP _splat_bwd (:521).  Neither
// is a Pallas kernel there: the forward is an XLA scatter (or one-hot MXU
// contractions) that gives the same bits on every run, the backward two
// bilinear gathers.  Corners outside the output and non-finite targets drop
// out.
//
// Forward, three passes (splat_max, splat_scatter, splat_finish).
// Determinism: a float atomicAdd sums in whatever order the atomics land, so
// its last bits change from run to run.  Here every finite term w * v is
// rounded once to a 64-bit fixed-point integer and added with an integer
// atomic, and integer addition is associative, so the sums are the same bits
// whatever the order.  The scale is a power of two per channel, taken from
// the channel's largest finite |v| (pass 1) so that the H * W SOURCES (each
// spreads a weight of 1 over its corners) cannot overflow 2^62, whatever the
// downsample: the resolution is max|v| * H * W * 2^-62, at least 2^40 finer
// than max|v| at 448x1024.  Non-finite terms (an inf or NaN input) go to a
// float accumulator of their own, whose sum (inf, -inf or NaN) does not
// depend on the order either, and take the place of the finite sum.  Pass 3
// converts each sum to float32 and casts it once to the output dtype.
//
// Hole mask.  A caller that turns zero-weight pixels into holes asks "is the
// float sum of the last channel > 0".  A term far below the fixed-point
// resolution (a corner weight of 1e-20) rounds to 0 here though the float
// sum is positive, so the scatter also sets a byte per target where a finite
// positive term of the last channel landed (a plain store, the same whatever
// the order), and pass 3 writes mask = (sum > 0) || (sum == 0 && flag).
// The value written stays the fixed-point sum.
//
// Backward (splat_bwd): one thread per source pixel gathers the output
// cotangent g at the four corners of the reference's ingrad transform (for
// d_inp) and of its flowgrad transform (for d_flow, weighted by the
// derivative of the bilinear weight and summed over channels), with the
// reference's quirks 1-3 (ops/splat.py:29-38).  Gathers only: no atomics,
// the same bits on every run.
//
// Bound on the H100: bytes.  Forward: inp and flow read once, the output
// written once; the passes also read inp twice, and the 64-bit accumulator
// is written by atomics and read once (the atomics on colliding targets are
// the expected cost above the bound).  Backward: inp, flow and the
// cotangent read once, d_inp and d_flow written once; the cotangent is
// gathered at 8 corners per source, mostly from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

// The downsample's geometry, from the host: scale, the phase offsets and the
// edge-stretch constants (abs(offset - size % scale)) % scale.
struct Geom {
  int H, W, Ho, Wo;
  float scale, ox, oy, sx, sy;
};

// Coordinate transforms, in float32 with the reference's order of operations
// and no fused multiply-adds (ops/splat.py:_fwd_transform and friends).
__device__ __forceinline__ float edge_stretch(float f, float size, float stretch) {
  // f + (f - size + 1) * stretch
  return __fadd_rn(f, __fmul_rn(__fadd_rn(__fsub_rn(f, size), 1.f), stretch));
}

__device__ __forceinline__ float pick(float f, float size, float f_edge, float scale,
                                      float off, bool edge_ok) {
  const float shifted = __fsub_rn(f, off);
  if (edge_ok && f >= size - 1.f) return f_edge;
  if (shifted < 0.f) return shifted;
  return __fdiv_rn(shifted, scale);
}

// forward (and the ingrad y transform, which drops the scale > 1 gate)
__device__ __forceinline__ float fwd_t(float f, float size, float scale, float off,
                                       float stretch, bool gate) {
  const float f_edge = __fdiv_rn(__fsub_rn(edge_stretch(f, size, stretch), off), scale);
  return pick(f, size, f_edge, scale, off, gate ? scale > 1.f : true);
}

// ingrad x: quirk 1, an extra "* offset" stretch
__device__ __forceinline__ float ingrad_x_t(float f, float size, float scale, float off,
                                            float stretch) {
  const float f1 = edge_stretch(f, size, stretch);
  const float f2 = edge_stretch(f1, size, off);
  return pick(f, size, __fdiv_rn(__fsub_rn(f2, off), scale), scale, off, true);
}

// flowgrad y: quirk 2, "* offset" where the forward has the stretch
__device__ __forceinline__ float flowgrad_y_t(float f, float size, float scale, float off) {
  const float f_edge = __fdiv_rn(__fsub_rn(edge_stretch(f, size, off), off), scale);
  return pick(f, size, f_edge, scale, off, true);
}

// flowgrad freeze flag: d(transform)/d(flow), 1/scale in the interior branch only
__device__ __forceinline__ float freeze(float f, float size, float scale, float off) {
  return (f >= size - 1.f || __fsub_rn(f, off) < 0.f) ? 0.f : 1.f / scale;
}

// fixed-point scale 2^e of channel c: e = 62 - log2hw - exponent(max|v|)
__device__ __forceinline__ int scale_exp(const unsigned* maxbits, int c, int log2hw) {
  int ex = 0;
  frexpf(__uint_as_float(maxbits[c]), &ex);
  return 62 - log2hw - ex;
}

// Pass 1.  grid (blocks, C): maxbits[c] = bits of max finite |v| (as
// unsigned: the order of non-negative floats), zero on entry.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
splat_max_kernel(const TX* __restrict__ x, int C, long long HW, long long total,
                 unsigned* __restrict__ maxbits) {
  const int c = blockIdx.y;
  float mx = 0.f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const long long b = i / HW;
    const float a = fabsf(to_f(x[(b * C + c) * HW + (i - b * HW)]));
    if (a <= 3.402823466e38f) mx = fmaxf(mx, a);
  }
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) atomicMax(maxbits + c, __float_as_uint(mx));
}

// Pass 2.  One thread per source pixel: its four corners, every channel.
// acc (B, C, Ho, Wo) int64, special (B, C, Ho, Wo) f32 and hit (B, Ho, Wo)
// uint8, zero on entry.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
splat_scatter_kernel(const TX* __restrict__ x, const float* __restrict__ flow, int C,
                     Geom g, long long total, const unsigned* __restrict__ maxbits,
                     int log2hw, unsigned long long* __restrict__ acc,
                     float* __restrict__ special, unsigned char* __restrict__ hit) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long HW = (long long)g.H * g.W, HWo = (long long)g.Ho * g.Wo;
  const int b = (int)(i / HW);
  const long long p = i - b * HW;
  const int py = (int)(p / g.W), px = (int)(p - (long long)py * g.W);
  const float* fl = flow + (long long)b * 2 * HW;
  const float fx = __fadd_rn((float)px, fl[p]);
  const float fy = __fadd_rn((float)py, fl[HW + p]);
  if (!isfinite(fx) || !isfinite(fy)) return;
  const float tx = fwd_t(fx, (float)g.W, g.scale, g.ox, g.sx, true);
  const float ty = fwd_t(fy, (float)g.H, g.scale, g.oy, g.sy, true);
  const float x0 = floorf(tx), y0 = floorf(ty);
  const float wx1 = __fsub_rn(tx, x0), wy1 = __fsub_rn(ty, y0);
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  const float cxs[4] = {x0, __fadd_rn(x0, 1.f), x0, __fadd_rn(x0, 1.f)};
  const float cys[4] = {y0, y0, __fadd_rn(y0, 1.f), __fadd_rn(y0, 1.f)};
  const float ws[4] = {__fmul_rn(wx0, wy0), __fmul_rn(wx1, wy0), __fmul_rn(wx0, wy1),
                       __fmul_rn(wx1, wy1)};
  long long idx[4];
  bool in[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    in[k] = cxs[k] >= 0.f && cxs[k] < (float)g.Wo && cys[k] >= 0.f && cys[k] < (float)g.Ho;
    idx[k] = in[k] ? (long long)cys[k] * g.Wo + (long long)cxs[k] : 0;
  }
  for (int c = 0; c < C; ++c) {
    const float val = to_f(x[((long long)b * C + c) * HW + p]);
    const double sc = ldexp(1.0, scale_exp(maxbits, c, log2hw));
    const long long base = ((long long)b * C + c) * HWo;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!in[k]) continue;
      const float term = __fmul_rn(val, ws[k]);
      if (isfinite(term)) {
        const long long qv = __double2ll_rn(__dmul_rn((double)term, sc));
        atomicAdd(acc + base + idx[k], (unsigned long long)qv);
        if (c == C - 1 && term > 0.f) hit[(long long)b * HWo + idx[k]] = 1;
      } else {
        atomicAdd(special + base + idx[k], term);
      }
    }
  }
}

// Pass 3.  out = the non-finite sum where there is one, else acc / 2^e,
// rounded to float32 and cast once to TX; mask for the last channel.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
splat_finish_kernel(const unsigned long long* __restrict__ acc,
                    const float* __restrict__ special, const unsigned* __restrict__ maxbits,
                    const unsigned char* __restrict__ hit, int C, long long HWo,
                    long long total, int log2hw, TX* __restrict__ out,
                    unsigned char* __restrict__ mask) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long bc = i / HWo;
  const int c = (int)(bc % C);
  const float sp = special[i];
  float r;
  if (sp != 0.f || isnan(sp)) {
    r = sp;
  } else {
    const double inv = ldexp(1.0, -scale_exp(maxbits, c, log2hw));
    r = __double2float_rn(__dmul_rn(__ll2double_rn((long long)acc[i]), inv));
  }
  put(out + i, r);
  if (c == C - 1) {
    const float v = to_f(out[i]);
    const long long m = (bc / C) * HWo + (i - bc * HWo);
    mask[m] = v > 0.f || (v == 0.f && hit[m]);
  }
}

// Backward.  One thread per source pixel.  g (B, C, Ho, Wo) f32; d_inp
// (B, C, H, W) in TX; d_flow (B, 2, H, W) f32.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
splat_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ flow,
                 const float* __restrict__ gout, int C, Geom g, long long total,
                 TX* __restrict__ d_inp, float* __restrict__ d_flow) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long HW = (long long)g.H * g.W, HWo = (long long)g.Ho * g.Wo;
  const int b = (int)(i / HW);
  const long long p = i - b * HW;
  const int py = (int)(p / g.W), px = (int)(p - (long long)py * g.W);
  const float* fl = flow + (long long)b * 2 * HW;
  const float fx = __fadd_rn((float)px, fl[p]);
  const float fy = __fadd_rn((float)py, fl[HW + p]);
  float* dfl = d_flow + (long long)b * 2 * HW;
  if (!isfinite(fx) || !isfinite(fy)) {
    for (int c = 0; c < C; ++c) put(d_inp + ((long long)b * C + c) * HW + p, 0.f);
    dfl[p] = 0.f;
    dfl[HW + p] = 0.f;
    return;
  }
  const float W = (float)g.W, H = (float)g.H;
  // ingrad corners (x0, y0) .. (x0 + 1, y0 + 1) and their weights
  const float txi = ingrad_x_t(fx, W, g.scale, g.ox, g.sx);
  const float tyi = fwd_t(fy, H, g.scale, g.oy, g.sy, false);
  // flowgrad corners, and the swapped freeze flags (quirk 3)
  const float txf = fwd_t(fx, W, g.scale, g.ox, g.sx, false);
  const float tyf = flowgrad_y_t(fy, H, g.scale, g.oy);
  const float dxx = freeze(fx, W, g.scale, g.ox), dyy = freeze(fy, H, g.scale, g.oy);

  const float xi0 = floorf(txi), yi0 = floorf(tyi);
  const float axi = __fsub_rn(txi, xi0), ayi = __fsub_rn(tyi, yi0);
  const float xf0 = floorf(txf), yf0 = floorf(tyf);
  const float axf = __fsub_rn(txf, xf0), ayf = __fsub_rn(tyf, yf0);
  const float wxi[2] = {__fsub_rn(1.f, axi), axi}, wyi[2] = {__fsub_rn(1.f, ayi), ayi};
  const float wxf[2] = {__fsub_rn(1.f, axf), axf}, wyf[2] = {__fsub_rn(1.f, ayf), ayf};
  // in-range flags and clamped indices of the two columns and rows
  bool ixi[2], iyi[2], ixf[2], iyf[2];
  long long cxi[2], cyi[2], cxf[2], cyf[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float xa = __fadd_rn(xi0, (float)k), ya = __fadd_rn(yi0, (float)k);
    const float xb = __fadd_rn(xf0, (float)k), yb = __fadd_rn(yf0, (float)k);
    ixi[k] = xa >= 0.f && xa < (float)g.Wo;
    iyi[k] = ya >= 0.f && ya < (float)g.Ho;
    ixf[k] = xb >= 0.f && xb < (float)g.Wo;
    iyf[k] = yb >= 0.f && yb < (float)g.Ho;
    cxi[k] = ixi[k] ? (long long)xa : 0;
    cyi[k] = iyi[k] ? (long long)ya : 0;
    cxf[k] = ixf[k] ? (long long)xb : 0;
    cyf[k] = iyf[k] ? (long long)yb : 0;
  }
  float gx = 0.f, gy = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* gc = gout + ((long long)b * C + c) * HWo;
    auto at = [&](bool ok, long long yy, long long xx) {
      return ok ? gc[yy * g.Wo + xx] : 0.f;
    };
    // d_inp: per column the row sum, then the column sum (the order of the
    // reference's two contractions)
    float din = 0.f;
#pragma unroll
    for (int kx = 0; kx < 2; ++kx) {
      const float col = __fadd_rn(
          __fmul_rn(wyi[0], at(ixi[kx] && iyi[0], cyi[0], cxi[kx])),
          __fmul_rn(wyi[1], at(ixi[kx] && iyi[1], cyi[1], cxi[kx])));
      din = __fadd_rn(din, __fmul_rn(wxi[kx], col));
    }
    put(d_inp + ((long long)b * C + c) * HW + p, din);
    // d_flow: the bilinear weight's derivative in x (and in y)
    float tfx[2], tfy[2];
#pragma unroll
    for (int kx = 0; kx < 2; ++kx) {
      const float g0 = at(ixf[kx] && iyf[0], cyf[0], cxf[kx]);
      const float g1 = at(ixf[kx] && iyf[1], cyf[1], cxf[kx]);
      tfx[kx] = __fadd_rn(__fmul_rn(wyf[0], g0), __fmul_rn(wyf[1], g1));
      tfy[kx] = __fsub_rn(g1, g0);
    }
    const float v = to_f(x[((long long)b * C + c) * HW + p]);
    gx = __fadd_rn(gx, __fmul_rn(__fsub_rn(tfx[1], tfx[0]), v));
    gy = __fadd_rn(gy, __fmul_rn(__fadd_rn(__fmul_rn(wxf[0], tfy[0]),
                                           __fmul_rn(wxf[1], tfy[1])), v));
  }
  dfl[p] = __fmul_rn(gx, dyy);
  dfl[HW + p] = __fmul_rn(gy, dxx);
}

template <typename TX>
int launch_fwd(const void* x, const float* flow, unsigned* maxbits, unsigned long long* acc,
               float* special, unsigned char* hit, void* out, unsigned char* mask, int B,
               int C, Geom g, int log2hw, cudaStream_t st) {
  const long long HW = (long long)g.H * g.W, total = (long long)B * HW;
  const TX* xp = static_cast<const TX*>(x);
  const long long blocks = (total + THREADS - 1) / THREADS;
  const int max_blocks = (int)(blocks < 1024 ? blocks : 1024);
  splat_max_kernel<TX><<<dim3(max_blocks, C), THREADS, 0, st>>>(xp, C, HW, total, maxbits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  splat_scatter_kernel<TX><<<(unsigned)blocks, THREADS, 0, st>>>(
      xp, flow, C, g, total, maxbits, log2hw, acc, special, hit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long HWo = (long long)g.Ho * g.Wo, n_out = (long long)B * C * HWo;
  splat_finish_kernel<TX><<<(unsigned)((n_out + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      acc, special, maxbits, hit, C, HWo, n_out, log2hw, static_cast<TX*>(out), mask);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_bwd(const void* x, const float* flow, const float* gout, void* d_inp,
               float* d_flow, int B, int C, Geom g, cudaStream_t st) {
  const long long total = (long long)B * g.H * g.W;
  splat_bwd_kernel<TX><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const TX*>(x), flow, gout, C, g, total, static_cast<TX*>(d_inp), d_flow);
  return (int)cudaGetLastError();
}

Geom make_geom(int H, int W, int scale, int ox, int oy) {
  Geom g;
  g.H = H;
  g.W = W;
  g.Ho = H / scale;
  g.Wo = W / scale;
  g.scale = (float)scale;
  g.ox = (float)ox;
  g.oy = (float)oy;
  g.sx = (float)(abs(ox - W % scale) % scale);
  g.sy = (float)(abs(oy - H % scale) % scale);
  return g;
}

}  // namespace

extern "C" {

// Forward.  x (B, C, H, W) (x_bf16: 1 = bfloat16, 0 = float32) and flow
// (B, 2, H, W) float32, contiguous; out (B, C, H/scale, W/scale) in x's
// dtype, mask (B, H/scale, W/scale) uint8 for the last channel.  Scratch,
// zeroed by the caller: maxbits (C) uint32, acc (B, C, Ho, Wo) int64,
// special (B, C, Ho, Wo) float32, hit (B, Ho, Wo) uint8.  log2hw =
// ceil(log2(H * W)) counts the sources.  0 <= ox, oy < scale.  Returns a
// cudaError_t (0 = launched).
int ofd_splat(const void* x, const void* flow, int x_bf16, void* maxbits, void* acc,
              void* special, void* hit, void* out, void* mask, int B, int C, int H, int W,
              int scale, int ox, int oy, int log2hw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g = make_geom(H, W, scale, ox, oy);
  const float* fl = static_cast<const float*>(flow);
  unsigned* mb = static_cast<unsigned*>(maxbits);
  unsigned long long* ac = static_cast<unsigned long long*>(acc);
  float* sp = static_cast<float*>(special);
  unsigned char* ht = static_cast<unsigned char*>(hit);
  unsigned char* mk = static_cast<unsigned char*>(mask);
  return x_bf16 ? launch_fwd<bf16>(x, fl, mb, ac, sp, ht, out, mk, B, C, g, log2hw, st)
                : launch_fwd<float>(x, fl, mb, ac, sp, ht, out, mk, B, C, g, log2hw, st);
}

// Backward.  x and flow as above, g (B, C, H/scale, W/scale) float32;
// d_inp (B, C, H, W) in x's dtype, d_flow (B, 2, H, W) float32.
int ofd_splat_bwd(const void* x, const void* flow, const void* gout, int x_bf16,
                  void* d_inp, void* d_flow, int B, int C, int H, int W, int scale, int ox,
                  int oy, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g = make_geom(H, W, scale, ox, oy);
  const float* fl = static_cast<const float*>(flow);
  const float* go = static_cast<const float*>(gout);
  float* df = static_cast<float*>(d_flow);
  return x_bf16 ? launch_bwd<bf16>(x, fl, go, d_inp, df, B, C, g, st)
                : launch_bwd<float>(x, fl, go, d_inp, df, B, C, g, st);
}

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
