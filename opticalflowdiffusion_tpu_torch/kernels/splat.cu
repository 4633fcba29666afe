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
// Forward, three launches and no memset (splat_max, splat_scatter,
// splat_finish).  Determinism: a float atomicAdd sums in
// whatever order the atomics land, so its last bits change from run to run.
// Here every finite term w * v is rounded once to a 64-bit fixed-point
// integer and summed as an integer, and integer addition is associative, so
// the sums are the same bits whatever the order and whatever the grouping.
// The scale is a power of two per channel, taken from the channel's largest
// finite |v| (pass 1) so that the H * W SOURCES (each spreads a weight of 1
// over its corners) cannot overflow 2^62, whatever the downsample: the
// resolution is max|v| * H * W * 2^-62, at least 2^40 finer than max|v| at
// 448x1024.
//
// - Pass 1 (splat_max) writes one partial max per block and channel (no
//   atomics) and zeroes the escapes' accumulator.
// - Pass 2 (splat_scatter) gives a CTA a tile of 32 x 32 sources and keeps
//   the integer sums of an output window in shared memory: the tile's
//   image, ceil(32 / scale) + 1 cells a side, with a halo of ceil(4 /
//   scale) + 1 cells (43 x 43 at scale 1: 1849 x (4 x 8 + 4) B = 67 KB for
//   4 channels).  A thread takes 4 consecutive sources of a row and sums,
//   in registers, the terms of consecutive sources with the same corners
//   (at scale s, s x s sources share a target), then adds them to the
//   window with shared atomics.  A corner outside the window (a flow beyond
//   the halo) goes to the escapes' accumulator, one global integer atomic
//   per channel.  The CTA then stores its whole window with plain stores.
// - Pass 3 (splat_finish) sums, for each output cell, the windows that
//   cover it (1 to 4 at scale 1) and the escapes, converts the sum to
//   float32 and casts it once to the output dtype.
// - Non-finite terms (an inf or NaN input) do not enter the sums: their sum
//   at a target (+inf, -inf or NaN) depends only on which of them landed
//   there, so they set flag bits (3 bits per channel in a 32-bit word per
//   cell and 4 channels), which take the place of the finite sum.
//
// What bounds it: not its bytes.  Pass 2 is latency-bound: its hot loop
// (the unrolled terms, the shared 64-bit atomics, which are compare-and-swap
// loops, and the double-precision rounding) runs at 2 CTAs an SM, and a
// flow beyond the halo (the random-weight UNet's reach ~220 px) sends most
// corners to global atomics; pass 3 gathers up to 4 windows a cell.
// PERF.md keeps the split by pass.
//
// Hole mask.  A caller that turns zero-weight pixels into holes asks "is the
// float sum of the last channel > 0".  A term far below the fixed-point
// resolution (a corner weight of 1e-20) rounds to 0 here though the float
// sum is positive, so the scatter also sets a flag bit per target where a
// finite positive term of the last channel landed, and pass 3 writes mask =
// (sum > 0) || (sum == 0 && flag).  The value written stays the fixed-point
// sum.  The arithmetic of every term, sum and flag is that of
// ops/splat.py::splat_fixed_plain, which the kernel equals bit for bit.
//
// Backward (splat_bwd): one thread per source pixel gathers the output
// cotangent g at the four corners of the reference's ingrad transform (for
// d_inp) and of its flowgrad transform (for d_flow, weighted by the
// derivative of the bilinear weight and summed over channels), with the
// reference's quirks 1-3 (ops/splat.py:29-38).  Gathers only: no atomics,
// the same bits on every run.
//
// Bound on the H100: bytes.  Forward: inp and flow read once, the output
// written once (~0.006 ms at 448x1024 b2 with 4 channels); the passes also
// read inp twice, write and read the windows' 64-bit sums once (1.8 x the
// output's cells at scale 1: ~60 MB at that shape) and zero and read the
// escapes' (29 MB).  Backward: inp, flow and the cotangent read once, d_inp
// and d_flow written once; the cotangent is gathered at 8 corners per
// source, mostly from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include <atomic>

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

// ---------------------------------------------------------------- forward
//
// The plan (fwd_plan, owned here: the wrapper allocates the scratch that
// ofd_splat_scratch_bytes states).  A CTA takes a tile of
// TILE x TILE sources and keeps the 64-bit sums of an output window in
// shared memory: the tile's image under the interior transform,
// ceil(TILE / scale) + 1 cells a side, widened by halo = ceil(4 / scale) + 1
// cells on every side; its window's origin is floor((TILE j - offset) /
// scale) - halo.  The windows of neighbouring tiles overlap, and together
// they cover the output.  Channels go through the window CHUNK at a time.
constexpr int TILE = 32;
constexpr int CHUNK = 4;
constexpr int SPT = TILE * TILE / THREADS;     // sources per thread, in a row
static_assert(TILE % SPT == 0 && THREADS % (TILE / SPT) == 0, "tile rows split evenly");
constexpr unsigned HIT = 1u << 31;              // a finite positive last-channel term
// flag bits of channel j of a chunk: 1 << 3j +inf, 2 << 3j -inf, 4 << 3j NaN
static_assert(3 * CHUNK <= 31, "the flag bits fit beside HIT");
// the largest window (scale 1) and its shared memory, set once per body
constexpr int WIN_MAX = TILE + 1 + 2 * (4 + 1);
constexpr int SMEM_MAX = WIN_MAX * WIN_MAX * (8 * CHUNK + 4);
static_assert(SMEM_MAX <= 227 * 1024, "the largest window fits a CTA's shared memory");

__host__ __device__ inline int floordiv(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }
__host__ __device__ inline long long align16(long long n) { return (n + 15) / 16 * 16; }

struct FwdPlan {
  int halo, win, tiles_x, tiles_y, chunk, chunks, groups, smem;
  // scratch: window sums (int64, [tile][C][cell]) | window flags (uint32,
  // [tile][chunk][cell]) | the escapes' sums (int64, B x C x Ho x Wo) and
  // flags (uint32, B x chunks x Ho x Wo), zeroed by pass 1 | pass-1
  // partials (C x groups) | 2^-e (double, C)
  long long wsum, wflag, acc, eflag, zero_end, part, inv, scratch_bytes;
};

FwdPlan fwd_plan(int B, int C, int H, int W, int scale) {
  FwdPlan p;
  p.halo = (4 + scale - 1) / scale + 1;
  p.win = (TILE + scale - 1) / scale + 1 + 2 * p.halo;
  p.tiles_x = (W + TILE - 1) / TILE;
  p.tiles_y = (H + TILE - 1) / TILE;
  p.chunk = C < CHUNK ? C : CHUNK;
  p.chunks = (C + CHUNK - 1) / CHUNK;
  const long long per_group = 16LL * THREADS, total = (long long)B * H * W;
  long long g = (total + per_group - 1) / per_group, cap = 1024 / C;
  if (cap < 1) cap = 1;
  p.groups = (int)(g < cap ? g : cap);
  p.smem = p.win * p.win * (8 * p.chunk + 4);
  const long long tiles = (long long)B * p.tiles_x * p.tiles_y, WA = (long long)p.win * p.win;
  const long long HWo = (long long)(H / scale) * (W / scale);
  p.wsum = 0;
  p.wflag = p.wsum + align16(tiles * C * WA * 8);
  p.acc = p.wflag + align16(tiles * p.chunks * WA * 4);
  p.eflag = p.acc + (long long)B * C * HWo * 8;
  p.zero_end = align16(p.eflag + (long long)B * p.chunks * HWo * 4);
  p.part = p.zero_end;
  p.inv = p.part + align16(4LL * C * p.groups);
  p.scratch_bytes = p.inv + align16(8LL * C);
  return p;
}

// Pass 1, the per-channel max and the zeroing.  grid (groups, C): block
// (g, c) writes the largest finite |v| of its share of channel c, as bits
// (the order of non-negative floats as unsigned), to part[c * groups + g]
// (no atomics, so nothing needs zeroing first); all blocks together zero
// the escapes' sums and flags (zero, n16 16-byte words) for pass 2.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
splat_max_kernel(const TX* __restrict__ x, int B, int C, long long HW,
                 unsigned* __restrict__ part, uint4* __restrict__ zero, long long n16) {
  __shared__ float red[THREADS / 32];
  const int c = blockIdx.y, G = gridDim.x;
  float mx = 0.f;
  for (int b = 0; b < B; ++b) {
    const TX* xc = x + ((long long)b * C + c) * HW;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < HW;
         i += (long long)G * THREADS) {
      const float a = fabsf(to_f(xc[i]));
      if (a <= 3.402823466e38f) mx = fmaxf(mx, a);
    }
  }
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  const long long stride = (long long)G * gridDim.y * THREADS;
  for (long long k = ((long long)c * G + blockIdx.x) * THREADS + threadIdx.x; k < n16;
       k += stride)
    zero[k] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
    part[c * G + blockIdx.x] = __float_as_uint(mx);
  }
}

// The window's geometry along one axis: origin of tile t's window, and the
// last tile whose window starts at or before cell v (the windows that cover
// v are that one and the ones just before it).
struct Axis {
  int scale, off, halo, tiles;
  __host__ __device__ __forceinline__ int origin(int t) const {
    return floordiv(TILE * t - off, scale) - halo;
  }
  __device__ __forceinline__ int last(int v) const {
    return min(tiles - 1, floordiv(scale * (v + halo + 1) - 1 + off, TILE));
  }
};

// The pending sums of one thread: the four corners of one (x0, y0), every
// channel of the chunk, over the consecutive sources of its row that share
// it (s x s sources share a target at scale s), and where they go.
struct Pending {
  long long q[4][CHUNK];
  unsigned f[4];
  int cx, cy, m;   // corners (cx, cy) .. (cx + 1, cy + 1); m as inmask, 0: none
};

// One corner outside its CTA's window (a flow beyond the halo): its sums go
// straight to the global accumulator of the escapes, one integer atomic per
// channel, and its flags to theirs.
__device__ __forceinline__ void escape(long long gi, int cc, long long q0, long long q1,
                                    long long q2, long long q3, unsigned f,
                                    unsigned long long* acc, long long HWo, unsigned* eflag) {
  static_assert(CHUNK == 4, "a corner holds CHUNK sums");
  const long long q[CHUNK] = {q0, q1, q2, q3};
#pragma unroll
  for (int j = 0; j < CHUNK; ++j)
    if (j < cc && q[j]) atomicAdd(acc + j * HWo + gi, (unsigned long long)q[j]);
  if (f) atomicOr(eflag + gi, f);
}

// Pass 2's flush of one pending group: each corner's sums and flags into the
// window (shared atomics), or, outside it, to the escapes' accumulator
// (acc and eflag point at the chunk's first channel and its flag plane).
__device__ __forceinline__ void flush(const Pending& pd, int wx0, int wy0, int win, int cc,
                                      int Wo, unsigned long long* sum, unsigned* fl,
                                      unsigned long long* acc, long long HWo, unsigned* eflag) {
  const int WA = win * win, lbase = (pd.cy - wy0) * win + (pd.cx - wx0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!(pd.m & (1 << k))) continue;
    const int dx = k & 1, dy = k >> 1;
    if (pd.m & (16 << k)) {
      const int e = lbase + dx + dy * win;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        if (j < cc && pd.q[k][j]) atomicAdd(sum + j * WA + e, (unsigned long long)pd.q[k][j]);
      if (pd.f[k] && (fl[e] & pd.f[k]) != pd.f[k]) atomicOr(fl + e, pd.f[k]);
    } else {
      escape((long long)(pd.cy + dy) * Wo + pd.cx + dx, cc, pd.q[k][0], pd.q[k][1], pd.q[k][2],
             pd.q[k][3], pd.f[k], acc, HWo, eflag);
    }
  }
}

// Pass 2.  grid (tiles_x, tiles_y, B).  Thread t takes SPT consecutive
// sources of row t / (TILE / SPT) of the tile.  Each finite term w * v is
// rounded once to the fixed point of its channel and summed as an integer:
// first in registers, over consecutive sources of the thread with the same
// corners, then with shared atomics into the window.  A corner outside the
// window (a flow beyond the halo) goes to the escapes' accumulator with
// global atomics.  Non-finite terms set flag bits instead; a finite
// positive term of the last channel sets HIT.  At the end of each chunk the
// CTA stores its whole window, sums and flags, with plain stores.  CTA 0
// also writes each channel's 2^-e for pass 3.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
splat_scatter_kernel(const TX* __restrict__ x, const float* __restrict__ flow, int C, Geom g,
                     Axis ax, Axis ay, const unsigned* __restrict__ part, int groups,
                     int log2hw, int chunks, int win, unsigned long long* __restrict__ wsum,
                     unsigned* __restrict__ wflag, unsigned long long* __restrict__ acc,
                     unsigned* __restrict__ eflag, double* __restrict__ inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int WA = win * win, cmax = min(C, CHUNK);
  unsigned long long* sum = reinterpret_cast<unsigned long long*>(smem);   // [cmax][WA]
  unsigned* fl = reinterpret_cast<unsigned*>(sum + (size_t)cmax * WA);    // [WA]
  __shared__ double scl[CHUNK];
  __shared__ unsigned mbits[CHUNK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int wx0 = ax.origin(blockIdx.x), wy0 = ay.origin(blockIdx.y);
  const long long HW = (long long)g.H * g.W;
  const int py = blockIdx.y * TILE + tid / (TILE / SPT);
  const int px0 = blockIdx.x * TILE + (tid % (TILE / SPT)) * SPT;
  const unsigned tile = ((unsigned)b * ay.tiles + blockIdx.y) * ax.tiles + blockIdx.x;
  const bool first_cta = tile == 0;

  // the SPT sources: corners (x0, y0) .. (x0 + 1, y0 + 1), their weights,
  // which corners are in the output (bits 0-3) and in the window (bits 4-7)
  int cx[SPT], cy[SPT], inmask[SPT];
  float ws[SPT][4];
  const float* fp = flow + (long long)b * 2 * HW;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    inmask[i] = 0;
    cx[i] = cy[i] = 0;
    ws[i][0] = ws[i][1] = ws[i][2] = ws[i][3] = 0.f;
    const int px = px0 + i;
    if (py >= g.H || px >= g.W) continue;
    const long long p = (long long)py * g.W + px;
    const float fx = __fadd_rn((float)px, fp[p]);
    const float fy = __fadd_rn((float)py, fp[HW + p]);
    if (!isfinite(fx) || !isfinite(fy)) continue;
    const float tx = fwd_t(fx, (float)g.W, g.scale, g.ox, g.sx, true);
    const float ty = fwd_t(fy, (float)g.H, g.scale, g.oy, g.sy, true);
    const float x0 = floorf(tx), y0 = floorf(ty);
    const float ax1 = __fsub_rn(tx, x0), ay1 = __fsub_rn(ty, y0);
    const float ax0 = __fsub_rn(1.f, ax1), ay0 = __fsub_rn(1.f, ay1);
    ws[i][0] = __fmul_rn(ax0, ay0);
    ws[i][1] = __fmul_rn(ax1, ay0);
    ws[i][2] = __fmul_rn(ax0, ay1);
    ws[i][3] = __fmul_rn(ax1, ay1);
    int m = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xk = (k & 1) ? __fadd_rn(x0, 1.f) : x0;
      const float yk = (k & 2) ? __fadd_rn(y0, 1.f) : y0;
      if (xk >= 0.f && xk < (float)g.Wo && yk >= 0.f && yk < (float)g.Ho) {
        m |= 1 << k;
        const int lx = (int)xk - wx0, ly = (int)yk - wy0;
        if (lx >= 0 && lx < win && ly >= 0 && ly < win) m |= 16 << k;
      }
    }
    if (m) {   // then -1 <= x0 < Wo and -1 <= y0 < Ho
      cx[i] = (int)x0;
      cy[i] = (int)y0;
    }
    inmask[i] = m;
  }

  const long long HWo = (long long)g.Ho * g.Wo;
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * CHUNK, cc = min(CHUNK, C - c0);
    for (int e = tid; e < cc * WA; e += THREADS) sum[e] = 0ull;
    for (int e = tid; e < WA; e += THREADS) fl[e] = 0u;
    if (warp < cc) {   // the channel's max from pass 1's partials
      unsigned m = 0u;
      for (int i = lane; i < groups; i += 32) m = max(m, part[(c0 + warp) * groups + i]);
      for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) {
        mbits[warp] = m;
        const int ex = scale_exp(mbits, warp, log2hw);
        scl[warp] = ldexp(1.0, ex);
        if (first_cta) inv[c0 + warp] = ldexp(1.0, -ex);
      }
    }
    __syncthreads();

    const TX* xr = x + ((long long)b * C + c0) * HW + (long long)py * g.W;
    float vals[SPT][CHUNK];
#pragma unroll
    for (int i = 0; i < SPT; ++i)
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        vals[i][j] = inmask[i] && j < cc ? to_f(xr[(long long)j * HW + px0 + i]) : 0.f;
    unsigned long long* accc = acc + ((long long)b * C + c0) * HWo;
    unsigned* eflc = eflag + ((long long)b * chunks + ch) * HWo;
    Pending pd;
    pd.m = 0;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      if (!inmask[i]) continue;
      // the same (x0, y0) has the same corners in the output and the window
      if (pd.m && (cx[i] != pd.cx || cy[i] != pd.cy)) {
        flush(pd, wx0, wy0, win, cc, g.Wo, sum, fl, accc, HWo, eflc);
        pd.m = 0;
      }
      if (!pd.m) {
        pd.cx = cx[i];
        pd.cy = cy[i];
        pd.m = inmask[i];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          pd.f[k] = 0u;
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) pd.q[k][j] = 0;
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        if (j >= cc) continue;
        const double sc = scl[j];
        const bool last = c0 + j == C - 1;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!(inmask[i] & (1 << k))) continue;
          const float term = __fmul_rn(vals[i][j], ws[i][k]);
          if (isfinite(term)) {
            pd.q[k][j] += __double2ll_rn(__dmul_rn((double)term, sc));
            if (last && term > 0.f) pd.f[k] |= HIT;
          } else {
            pd.f[k] |= (isnan(term) ? 4u : term > 0.f ? 1u : 2u) << (3 * j);
          }
        }
      }
    }
    if (pd.m)
      flush(pd, wx0, wy0, win, cc, g.Wo, sum, fl, accc, HWo, eflc);
    __syncthreads();

    // the whole window, sums and flags, to this tile's slot
    unsigned long long* ws_out = wsum + ((size_t)tile * C + c0) * WA;
    unsigned* wf_out = wflag + ((size_t)tile * chunks + ch) * WA;
    for (int e = tid; e < WA; e += THREADS) {
      for (int j = 0; j < cc; ++j)
        ws_out[(size_t)j * WA + e] = sum[j * WA + e];
      wf_out[e] = fl[e];
    }
    __syncthreads();
  }
}

// Pass 3.  One thread per (b, target), every channel: the sums and flags of
// every window that covers the target (up to 2 x 2 at scale 1) and of the
// escapes, then out =
// the non-finite sum where the flags say one landed (NaN for a NaN term or
// both infinities, else that infinity), else sum / 2^e, rounded to float32
// and cast once to TX; mask = (v > 0) || (v == 0 && HIT) on the last
// channel's v as written.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
splat_finish_kernel(const unsigned long long* __restrict__ wsum,
                    const unsigned* __restrict__ wflag, const unsigned long long* __restrict__ acc,
                    const unsigned* __restrict__ eflag, const double* __restrict__ inv,
                    int C, int chunks, int Ho, int Wo, Axis ax, Axis ay, int win,
                    long long total, TX* __restrict__ out, unsigned char* __restrict__ mask) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long HWo = (long long)Ho * Wo;
  const int b = (int)(i / HWo);
  const int t = (int)(i - (long long)b * HWo), y = t / Wo, x = t - y * Wo;
  const int WA = win * win, ih = ay.last(y), jh = ax.last(x);
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * CHUNK, cc = min(CHUNK, C - c0);
    unsigned long long sum[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      sum[j] = j < cc ? acc[((long long)b * C + c0 + j) * HWo + t] : 0ull;
    unsigned f = eflag[((long long)b * chunks + ch) * HWo + t];
    for (int it = ih; it >= 0; --it) {
      const int ly = y - ay.origin(it);
      if (ly >= win) break;
      for (int jt = jh; jt >= 0; --jt) {
        const int lx = x - ax.origin(jt);
        if (lx >= win) break;
        const size_t tile = ((size_t)b * ay.tiles + it) * ax.tiles + jt, e = ly * win + lx;
        f |= wflag[(tile * chunks + ch) * WA + e];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j)
          if (j < cc) sum[j] += wsum[(tile * C + c0 + j) * WA + e];
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (j >= cc) continue;
      const int c = c0 + j;
      const unsigned nf = (f >> (3 * j)) & 7u;
      const long long o = ((long long)b * C + c) * HWo + t;
      float r;
      if (nf) {
        r = ((nf & 4u) || nf == 3u) ? __int_as_float(0x7fffffff)
                                    : (nf == 1u ? __int_as_float(0x7f800000)
                                                : __int_as_float(0xff800000));
      } else {
        r = __double2float_rn(__dmul_rn(__ll2double_rn((long long)sum[j]), inv[c]));
      }
      put(out + o, r);
      if (c == C - 1) {
        const float v = to_f(out[o]);
        mask[i] = v > 0.f || (v == 0.f && (f & HIT));
      }
    }
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

// The scatter body's shared-memory limit, raised to SMEM_MAX once per body
// and device (the CUDA call would otherwise cost every launch).
template <typename TX>
int scatter_smem_once(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit && (done.load() & bit)) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      splat_scatter_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess) done.fetch_or(bit);
  return (int)err;
}

template <typename TX>
int launch_fwd(const void* x, const float* flow, unsigned char* scratch, void* out,
               unsigned char* mask, int B, int C, Geom g, int scale, int ox, int oy,
               const FwdPlan& p, int log2hw, int device, cudaStream_t st) {
  const long long HW = (long long)g.H * g.W;
  const TX* xp = static_cast<const TX*>(x);
  unsigned long long* wsum = reinterpret_cast<unsigned long long*>(scratch + p.wsum);
  unsigned* wflag = reinterpret_cast<unsigned*>(scratch + p.wflag);
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(scratch + p.acc);
  unsigned* eflag = reinterpret_cast<unsigned*>(scratch + p.eflag);
  unsigned* part = reinterpret_cast<unsigned*>(scratch + p.part);
  double* inv = reinterpret_cast<double*>(scratch + p.inv);
  const Axis ax{scale, ox, p.halo, p.tiles_x}, ay{scale, oy, p.halo, p.tiles_y};
  splat_max_kernel<TX><<<dim3(p.groups, C), THREADS, 0, st>>>(
      xp, B, C, HW, part, reinterpret_cast<uint4*>(scratch + p.acc), (p.zero_end - p.acc) / 16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = (cudaError_t)scatter_smem_once<TX>(device);
  if (err != cudaSuccess) return (int)err;
  splat_scatter_kernel<TX><<<dim3(p.tiles_x, p.tiles_y, B), THREADS, p.smem, st>>>(
      xp, flow, C, g, ax, ay, part, p.groups, log2hw, p.chunks, p.win, wsum, wflag, acc, eflag,
      inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * g.Ho * g.Wo;
  splat_finish_kernel<TX><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      wsum, wflag, acc, eflag, inv, C, p.chunks, g.Ho, g.Wo, ax, ay, p.win, n,
      static_cast<TX*>(out), mask);
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

// The forward's scratch in bytes for (B, C, H, W, scale), from its plan:
// the wrapper allocates it (uninitialised) and passes it to ofd_splat.  -1
// for a shape the forward refuses.
long long ofd_splat_scratch_bytes(int B, int C, int H, int W, int scale) {
  if (B < 1 || C < 1 || scale < 1 || H < scale || W < scale || B > 65535) return -1;
  return fwd_plan(B, C, H, W, scale).scratch_bytes;
}

// The forward's windows: for each source column x < W the origin, in output
// cells, of its tile's window along x (wx0[x]), the same along y for each
// row (wy0[y]); returns the window's side in cells (-1 for a refused
// shape).  A corner of a source lands in its window when 0 <= cell - origin
// < side on both axes; the others take the escapes' atomics.
int ofd_splat_windows(int H, int W, int scale, int ox, int oy, int* wx0, int* wy0) {
  if (scale < 1 || H < scale || W < scale || ox < 0 || ox >= scale || oy < 0 || oy >= scale)
    return -1;
  const FwdPlan p = fwd_plan(1, 1, H, W, scale);
  const Axis ax{scale, ox, p.halo, p.tiles_x}, ay{scale, oy, p.halo, p.tiles_y};
  for (int x = 0; x < W; ++x) wx0[x] = ax.origin(x / TILE);
  for (int y = 0; y < H; ++y) wy0[y] = ay.origin(y / TILE);
  return p.win;
}

// Forward.  x (B, C, H, W) (x_bf16: 1 = bfloat16, 0 = float32) and flow
// (B, 2, H, W) float32, contiguous; out (B, C, H/scale, W/scale) in x's
// dtype, mask (B, H/scale, W/scale) uint8 for the last channel.  scratch:
// scratch_bytes (= ofd_splat_scratch_bytes) of device memory,
// uninitialised (the passes zero what they read).  0 <= ox, oy < scale.
// Three launches.  Returns a cudaError_t (0 = launched).
int ofd_splat(const void* x, const void* flow, int x_bf16, void* scratch, long long scratch_bytes,
              void* out, void* mask, int B, int C, int H, int W, int scale, int ox, int oy,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || C < 1 || scale < 1 || H < scale || W < scale || ox < 0 || ox >= scale ||
      oy < 0 || oy >= scale || B > 65535)
    return (int)cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(B, C, H, W, scale);
  if (scratch_bytes != p.scratch_bytes || p.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // log2hw = ceil(log2(H * W)) counts the sources (the fixed point's headroom)
  int log2hw = 0;
  while ((1LL << log2hw) < (long long)H * W) ++log2hw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g = make_geom(H, W, scale, ox, oy);
  const float* fl = static_cast<const float*>(flow);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  unsigned char* mk = static_cast<unsigned char*>(mask);
  return x_bf16
             ? launch_fwd<bf16>(x, fl, sc, out, mk, B, C, g, scale, ox, oy, p, log2hw, device, st)
             : launch_fwd<float>(x, fl, sc, out, mk, B, C, g, scale, ox, oy, p, log2hw, device,
                                 st);
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
