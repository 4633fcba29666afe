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
// Backward (splat_bwd): for each source pixel, the output cotangent g
// gathered at the four corners of the reference's ingrad transform (for
// d_inp) and of its flowgrad transform (for d_flow, weighted by the
// derivative of the bilinear weight and summed over channels), with the
// reference's quirks 1-3 (ops/splat.py:29-38).  Gathers only: no atomics,
// the same bits on every run, and the bits of ops/splat.py::splat_bwd_raw.
// Two launches: the cotangent laid out channels-last, then the gathers, a
// few sources of a row a thread with vector accesses, every load issued
// before the arithmetic, each corner cell read once for both gradients
// (below, "Backward").
//
// Bound on the H100: bytes.  Forward: inp and flow read once, the output
// written once (~0.006 ms at 448x1024 b2 with 4 channels); the passes also
// read inp twice, write and read the windows' 64-bit sums once (1.8 x the
// output's cells at scale 1: ~60 MB at that shape) and zero and read the
// escapes' (29 MB).  Backward: inp, flow and the cotangent read once, d_inp
// and d_flow written once (0.013 ms a call at 448x1024 b2, 4 channels); the
// cotangent's 4 corners of a source come from L1/L2, scattered where the
// flow is large (the random-weight UNet's reach ~220 px, farther than a
// shared-memory window of a tile's targets could hold, so none is staged).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include <algorithm>
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

// forward
__device__ __forceinline__ float fwd_t(float f, float size, float scale, float off,
                                       float stretch, bool gate) {
  const float f_edge = __fdiv_rn(__fsub_rn(edge_stretch(f, size, stretch), off), scale);
  return pick(f, size, f_edge, scale, off, gate ? scale > 1.f : true);
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

// Backward, two launches.  splat_bwd_layout_kernel lays the cotangent out
// channels-last (gt): with the model's large flows a source's corners land
// anywhere in g, and a corner's 4 channels are then one 16-byte load from one
// L2 sector instead of 4 loads from 4 planes.  splat_bwd_kernel: a CTA of 32
// x BWD_ROWS threads covers 32 BWD_SPT columns and walks `steps` groups of
// BWD_ROWS rows down them, grid (ceil(W / (32 BWD_SPT)), ceil(H / (BWD_ROWS
// steps)), B), so every index is 32-bit and found without a divide (steps
// from bwd_steps: the CTAs fill every SM's BWD_MIN_CTAS slots once).  A
// thread takes BWD_SPT consecutive sources of a row: vector accesses of
// flow, x, d_inp and d_flow where W and the pointers allow it (vec), and its
// next row group's flow and first channels of x copied ahead into its own
// slots of a two-stage ring in shared memory (cp.async), so that the loads
// stay in flight without holding registers.  Per chunk of 4 channels it
// works out every source's corners, then issues every gather, then does the
// arithmetic.  The flowgrad corners are the ingrad ones wherever the two
// transforms floor to the same cell, which they do away from the edge
// branches (quirks 1 and 2 change the edge branch only), so a cell is read
// once for both gradients; an edge source's d_flow is redone after the chunk
// loop at its own corners (edge_flow).  At a power-of-two scale (the model's
// 1-16) the transforms multiply by the exact reciprocal (DivPow2) instead of
// dividing: the same values.  NC = 4, the model's channel count, unrolls the
// chunk loop.  Every rounded operation is the first body's (one thread per
// source), in the same order: the outputs are splat_bwd_raw's bits.  g (B,
// C, Ho, Wo) f32; d_inp (B, C, H, W) in TX; d_flow (B, 2, H, W) f32.
constexpr int BWD_SPT = 2;        // sources a thread, consecutive along W
constexpr int BWD_ROWS = 16;      // rows of sources a CTA (threadIdx.y)
constexpr int BWD_MIN_CTAS = 1;   // CTAs an SM the registers must allow (128 a thread)
constexpr int BWD_MAX_STEPS = 8;  // row groups a CTA walks, at most

// A thread's BWD_SPT consecutive values of a row: one vector access where vec
// says that W and the pointers allow it, else one access per value (n of
// them in the row).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};
__device__ __forceinline__ void load_row(const float* p, int n, bool vec, float (&v)[BWD_SPT]) {
  if (vec) {
    const Vec<float, BWD_SPT> u = *reinterpret_cast<const Vec<float, BWD_SPT>*>(p);
#pragma unroll
    for (int s = 0; s < BWD_SPT; ++s) v[s] = u.v[s];
  } else {
#pragma unroll
    for (int s = 0; s < BWD_SPT; ++s) v[s] = s < n ? p[s] : 0.f;
  }
}
__device__ __forceinline__ void load_row(const bf16* p, int n, bool vec, float (&v)[BWD_SPT]) {
  if (vec) {
    const Vec<bf16, BWD_SPT> u = *reinterpret_cast<const Vec<bf16, BWD_SPT>*>(p);
#pragma unroll
    for (int s = 0; s < BWD_SPT; ++s) v[s] = __bfloat162float(u.v[s]);
  } else {
#pragma unroll
    for (int s = 0; s < BWD_SPT; ++s) v[s] = s < n ? __bfloat162float(p[s]) : 0.f;
  }
}
template <typename T>
__device__ __forceinline__ void store_row(T* p, int n, bool vec, const float (&v)[BWD_SPT]) {
  if (vec) {
    Vec<T, BWD_SPT> u;
#pragma unroll
    for (int s = 0; s < BWD_SPT; ++s) put(u.v + s, v[s]);
    *reinterpret_cast<Vec<T, BWD_SPT>*>(p) = u;
  } else {
#pragma unroll
    for (int s = 0; s < BWD_SPT; ++s)
      if (s < n) put(p + s, v[s]);
  }
}

// The 4 cells around (x0, y0) (x0 + kx, y0 + ky at k = 2 ky + kx) as offsets
// into a (Ho, Wo) plane, -1 where the cell lies outside it.
__device__ __forceinline__ void corner_cells(float x0, float y0, const Geom& g, int (&cell)[4]) {
#pragma unroll
  for (int ky = 0; ky < 2; ++ky) {
    const float ya = __fadd_rn(y0, (float)ky);
    const bool iy = ya >= 0.f && ya < (float)g.Ho;
#pragma unroll
    for (int kx = 0; kx < 2; ++kx) {
      const float xa = __fadd_rn(x0, (float)kx);
      const bool ix = xa >= 0.f && xa < (float)g.Wo;
      cell[2 * ky + kx] = ix && iy ? (int)ya * g.Wo + (int)xa : -1;
    }
  }
}

// One source's ingrad and flowgrad corners and weights; ok: in the row and
// a finite target.
struct BwdSrc {
  bool ok, same;             // same: the flowgrad corner cell is the ingrad one
  float axi, ayi, axf, ayf;  // the bilinear fractions (weights 1 - a, a)
  float xf0, yf0;            // the flowgrad corner
  int cell[4];               // the ingrad corners' offsets, -1 outside
};

// x / scale, correctly rounded: a division, or for a power-of-two scale the
// product with its exact reciprocal, which is the same value (the model's
// scales 1-16)
struct DivRN {
  __device__ float operator()(float x, float scale) const { return __fdiv_rn(x, scale); }
};
struct DivPow2 {
  float inv;
  __device__ float operator()(float x, float) const { return __fmul_rn(x, inv); }
};

// The reference's backward transforms (ops/splat.py:_transform with the
// gate dropped, _ingrad_x, _flowgrad_y): the ingrad and flowgrad targets
// share the interior and left branches, and differ on the edge branch only
// (quirk 1: ingrad x stretches twice; quirk 2: flowgrad y stretches by the
// offset), which is worked out only where a source takes it.
template <typename D>
__device__ __forceinline__ BwdSrc bwd_src(float fx, float fy, bool valid, const Geom& g, D div) {
  BwdSrc r;
  const float W = (float)g.W, H = (float)g.H;
  r.ok = valid && isfinite(fx) && isfinite(fy);
  const float shx = __fsub_rn(fx, g.ox), shy = __fsub_rn(fy, g.oy);
  float txi = shx < 0.f ? shx : div(shx, g.scale), tyi = shy < 0.f ? shy : div(shy, g.scale);
  float txf = txi, tyf = tyi;
  if (fx >= W - 1.f) {
    const float f1 = edge_stretch(fx, W, g.sx);
    txi = div(__fsub_rn(edge_stretch(f1, W, g.ox), g.ox), g.scale);
    txf = div(__fsub_rn(f1, g.ox), g.scale);
  }
  if (fy >= H - 1.f) {
    tyi = div(__fsub_rn(edge_stretch(fy, H, g.sy), g.oy), g.scale);
    tyf = div(__fsub_rn(edge_stretch(fy, H, g.oy), g.oy), g.scale);
  }
  const float xi0 = floorf(txi), yi0 = floorf(tyi);
  r.xf0 = floorf(txf), r.yf0 = floorf(tyf);
  r.axi = __fsub_rn(txi, xi0), r.ayi = __fsub_rn(tyi, yi0);
  r.axf = __fsub_rn(txf, r.xf0), r.ayf = __fsub_rn(tyf, r.yf0);
  r.same = xi0 == r.xf0 && yi0 == r.yf0;
  corner_cells(xi0, yi0, g, r.cell);
  if (!r.ok)
#pragma unroll
    for (int k = 0; k < 4; ++k) r.cell[k] = -1;
  return r;
}

// The cotangent channels-last for the gathers: gt (B, Ho, Wo, Cp), Cp = C
// rounded up to CHUNK (the padding zero), from g (B, C, Ho, Wo); grid
// (ceil(Ho Wo / THREADS), B).  A corner's CHUNK channels are then one
// 16-byte load instead of CHUNK loads from CHUNK planes, which with the
// model's large flows are CHUNK scattered L2 sectors.
__global__ void __launch_bounds__(THREADS)
splat_bwd_layout_kernel(const float* __restrict__ g, int C, int Cp, int HWo,
                        float4* __restrict__ gt) {
  const int t = blockIdx.x * THREADS + threadIdx.x, b = blockIdx.y;
  if (t >= HWo) return;
  const float* gc = g + (size_t)b * C * HWo + t;
  float4* o = gt + ((size_t)b * HWo + t) * (Cp / CHUNK);
  for (int c0 = 0; c0 < Cp; c0 += CHUNK) {
    float v[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) v[j] = c0 + j < C ? gc[(size_t)(c0 + j) * HWo] : 0.f;
    o[c0 / CHUNK] = make_float4(v[0], v[1], v[2], v[3]);
  }
}
static_assert(CHUNK == 4, "a float4 holds a chunk of channels");

__device__ __forceinline__ float chan(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One channel's d_flow terms (the reference's order), added to gx and gy:
// g00 .. g11 the cotangent at the flowgrad corners (x0 + kx, y0 + ky).
__device__ __forceinline__ void flow_terms(const float (&wxf)[2], const float (&wyf)[2], float g00,
                                           float g10, float g01, float g11, float v, float& gx,
                                           float& gy) {
  const float tfx0 = __fadd_rn(__fmul_rn(wyf[0], g00), __fmul_rn(wyf[1], g01));
  const float tfx1 = __fadd_rn(__fmul_rn(wyf[0], g10), __fmul_rn(wyf[1], g11));
  const float tfy0 = __fsub_rn(g01, g00), tfy1 = __fsub_rn(g11, g10);
  gx = __fadd_rn(gx, __fmul_rn(__fsub_rn(tfx1, tfx0), v));
  gy = __fadd_rn(gy, __fmul_rn(__fadd_rn(__fmul_rn(wxf[0], tfy0), __fmul_rn(wxf[1], tfy1)), v));
}

// (gx, gy) of a source on an edge branch, whose flowgrad corners differ from
// its ingrad ones: every channel again, in order, at its own corners.  xs:
// x at the source (plane stride HW); gtb: the batch element's channels-last
// cotangent.  Out of the hot loop, so that a rare branch does not order the
// other sources' loads behind it.
template <typename TX, typename D>
__device__ __noinline__ void edge_flow(const TX* xs, int HW, const float4* gtb, int q, int C,
                                       const Geom& g, D div, float fx, float fy, float& gx,
                                       float& gy) {
  const BwdSrc r = bwd_src(fx, fy, true, g, div);
  const float wxf[2] = {__fsub_rn(1.f, r.axf), r.axf}, wyf[2] = {__fsub_rn(1.f, r.ayf), r.ayf};
  int cf[4];
  corner_cells(r.xf0, r.yf0, g, cf);
  gx = 0.f, gy = 0.f;
  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    float4 F[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      F[k] = cf[k] >= 0 ? gtb[(size_t)cf[k] * q + c0 / CHUNK] : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < CHUNK && c0 + j < C; ++j)
      flow_terms(wxf, wyf, chan(F[0], j), chan(F[1], j), chan(F[2], j), chan(F[3], j),
                 to_f(xs[(size_t)(c0 + j) * HW]), gx, gy);
  }
}

// The BWD_SPT sources (py, px ..) of batch element b (n of them in the row),
// given their flow (flx, fly) and the first chunk of their x (x0).  NC: the
// channel count where it is known when compiling (CHUNK, the model's), so
// that the chunk loop and its channel tests unroll away; 0 for any C.
template <typename TX, typename D, int NC>
__device__ __forceinline__ void bwd_sources(const TX* __restrict__ x, const float4* __restrict__ gt,
                                            int C, const Geom& g, D div, bool vec, int b, int py,
                                            int px, int n, const float (&flx)[BWD_SPT],
                                            const float (&fly)[BWD_SPT],
                                            const float (&x0)[CHUNK][BWD_SPT],
                                            TX* __restrict__ d_inp, float* __restrict__ d_flow) {
  if (NC) C = NC;
  const int q = (C + CHUNK - 1) / CHUNK;
  const int HW = g.H * g.W, HWo = g.Ho * g.Wo, p = py * g.W + px;
  float fx[BWD_SPT], fy[BWD_SPT];
#pragma unroll
  for (int s = 0; s < BWD_SPT; ++s) {
    fx[s] = __fadd_rn((float)(px + s), flx[s]);
    fy[s] = __fadd_rn((float)py, fly[s]);
  }

  const TX* xb = x + (size_t)b * C * HW + p;
  TX* db = d_inp + (size_t)b * C * HW + p;
  float gx[BWD_SPT], gy[BWD_SPT];
#pragma unroll
  for (int s = 0; s < BWD_SPT; ++s) gx[s] = 0.f, gy[s] = 0.f;
  int edges = 0;  // sources whose flowgrad corners are not their ingrad ones
  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    const int cc = min(CHUNK, C - c0);
    const float4* gq = gt + (size_t)b * HWo * q + c0 / CHUNK;
    float v[CHUNK][BWD_SPT], din[CHUNK][BWD_SPT];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (c0 == 0) {
#pragma unroll
        for (int s = 0; s < BWD_SPT; ++s) v[j][s] = x0[j][s];
      } else if (j < cc) {
        load_row(xb + (size_t)(c0 + j) * HW, n, vec, v[j]);
      }
    }
    // every source's corners, then every gather (the chunk's channels at the
    // ingrad corners), then the arithmetic
    BwdSrc rs[BWD_SPT];
    float4 Gs[BWD_SPT][4];
#pragma unroll
    for (int s = 0; s < BWD_SPT; ++s) rs[s] = bwd_src(fx[s], fy[s], s < n, g, div);
#pragma unroll
    for (int s = 0; s < BWD_SPT; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        Gs[s][k] = rs[s].cell[k] >= 0 ? __ldg(gq + (size_t)rs[s].cell[k] * q)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < BWD_SPT; ++s) {
      const BwdSrc& r = rs[s];
      const float4 (&G)[4] = Gs[s];
      const float wxi[2] = {__fsub_rn(1.f, r.axi), r.axi}, wyi[2] = {__fsub_rn(1.f, r.ayi), r.ayi};
      const float wxf[2] = {__fsub_rn(1.f, r.axf), r.axf}, wyf[2] = {__fsub_rn(1.f, r.ayf), r.ayf};
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        if (j >= cc) break;
        // d_inp: per column the row sum, then the column sum (the order of
        // the reference's two contractions)
        float d = 0.f;
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
          const float col = __fadd_rn(__fmul_rn(wyi[0], chan(G[kx], j)),
                                      __fmul_rn(wyi[1], chan(G[2 + kx], j)));
          d = __fadd_rn(d, __fmul_rn(wxi[kx], col));
        }
        din[j][s] = r.ok ? d : 0.f;
        // d_flow: the bilinear weight's derivative in x (and in y), at the
        // flowgrad corners, here the ingrad ones (an edge source's is redone
        // below)
        flow_terms(wxf, wyf, chan(G[0], j), chan(G[1], j), chan(G[2], j), chan(G[3], j),
                   v[j][s], gx[s], gy[s]);
      }
      edges |= (r.ok && !r.same) << s;
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      if (j < cc) store_row(db + (size_t)(c0 + j) * HW, n, vec, din[j]);
  }
  if (edges)
#pragma unroll
    for (int s = 0; s < BWD_SPT; ++s)
      if (edges >> s & 1)
        edge_flow(xb + s, HW, gt + (size_t)b * HWo * q, q, C, g, div, fx[s], fy[s], gx[s], gy[s]);
  // the swapped freeze flags (quirk 3)
  float ox[BWD_SPT], oy[BWD_SPT];
#pragma unroll
  for (int s = 0; s < BWD_SPT; ++s) {
    const bool ok = s < n && isfinite(fx[s]) && isfinite(fy[s]);
    ox[s] = ok ? __fmul_rn(gx[s], freeze(fy[s], (float)g.H, g.scale, g.oy)) : 0.f;
    oy[s] = ok ? __fmul_rn(gy[s], freeze(fx[s], (float)g.W, g.scale, g.ox)) : 0.f;
  }
  float* dfl = d_flow + (size_t)b * 2 * HW + p;
  store_row(dfl, n, vec, ox);
  store_row(dfl + HW, n, vec, oy);
}

// cp.async of BYTES (8 or 16) from global to shared memory, per thread
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ring's slots are plane-major (flow x, flow y, then x channel by
// channel), so a warp's vector reads of them are conflict-free; no thread
// reads another's slots, so there is no barrier.
template <typename TX, typename D, int NC>
__global__ void __launch_bounds__(32 * BWD_ROWS, BWD_MIN_CTAS)
splat_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ flow,
                 const float4* __restrict__ gt, int C, Geom g, D div, int vec, int steps,
                 TX* __restrict__ d_inp, float* __restrict__ d_flow) {
  constexpr int T = 32 * BWD_ROWS, FB = BWD_SPT * sizeof(float), XB = BWD_SPT * sizeof(TX);
  constexpr int STAGE = T * (2 * FB + CHUNK * XB);
  __shared__ __align__(16) unsigned char ring[2 * STAGE];
  if (NC) C = NC;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int px = (blockIdx.x * 32 + threadIdx.x) * BWD_SPT;
  if (px >= g.W) return;
  const int b = blockIdx.z, n = min(BWD_SPT, g.W - px), HW = g.H * g.W, cc0 = min(C, CHUNK);
  const float* fb = flow + (size_t)b * 2 * HW + px;
  const TX* xb = x + (size_t)b * C * HW + px;
  auto row = [&](int k) { return (blockIdx.y * steps + k) * BWD_ROWS + threadIdx.y; };
  // plane i of stage st: flow x, flow y, then x channels 0 .. CHUNK-1
  auto slot = [&](int st, int i) {
    return ring + st * STAGE + (i < 2 ? i * T * FB + tid * FB : 2 * T * FB + (i - 2) * T * XB + tid * XB);
  };
  auto fetch = [&](int k) {
    const int py = row(k), st = k & 1;
    if (py < g.H) {
      cp_async<FB>(slot(st, 0), fb + py * g.W);
      cp_async<FB>(slot(st, 1), fb + HW + py * g.W);
      for (int j = 0; j < cc0; ++j) cp_async<XB>(slot(st, 2 + j), xb + (size_t)j * HW + py * g.W);
    }
    cp_async_commit();
  };
  if (vec) fetch(0);
  for (int k = 0; k < steps; ++k) {
    const int py = row(k);
    if (py >= g.H) break;
    float flx[BWD_SPT], fly[BWD_SPT], x0[CHUNK][BWD_SPT] = {};
    if (vec) {
      if (k + 1 < steps) {
        fetch(k + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      load_row(reinterpret_cast<const float*>(slot(k & 1, 0)), n, true, flx);
      load_row(reinterpret_cast<const float*>(slot(k & 1, 1)), n, true, fly);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        if (j < cc0) load_row(reinterpret_cast<const TX*>(slot(k & 1, 2 + j)), n, true, x0[j]);
    } else {
      load_row(fb + py * g.W, n, false, flx);
      load_row(fb + HW + py * g.W, n, false, fly);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        if (j < cc0) load_row(xb + (size_t)j * HW + py * g.W, n, false, x0[j]);
    }
    bwd_sources<TX, D, NC>(x, gt, C, g, div, vec, b, py, px, n, flx, fly, x0, d_inp, d_flow);
  }
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

// The backward's scratch: the channels-last cotangent (B, Ho, Wo, Cp).
long long bwd_scratch_bytes(int B, int C, int Ho, int Wo) {
  return (long long)B * Ho * Wo * ((C + CHUNK - 1) / CHUNK) * CHUNK * sizeof(float);
}

// The SMs of a device into *sms: asked once per device (devices 0-63 keep
// the count, others ask every time); a failed query returns its error.
int sm_count(int device, int* sms) {
  static std::atomic<int> known[64];
  const bool keep = device >= 0 && device < 64;
  int v = keep ? known[device].load() : 0;
  if (v < 1) {
    const cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (v < 1) return (int)cudaErrorInvalidDevice;
    if (keep) known[device].store(v);
  }
  *sms = v;
  return 0;
}

// Row groups a CTA of the backward walks: enough CTAs to fill every SM's
// BWD_MIN_CTAS slots once, each walking as many groups as that leaves, at
// most BWD_MAX_STEPS (2 at 128x128 b16, 7 at 448x1024 b2 on 132 SMs).
int bwd_steps(int B, int H, int W, int sms) {
  const long long groups = (long long)((W + 32 * BWD_SPT - 1) / (32 * BWD_SPT)) *
                           ((H + BWD_ROWS - 1) / BWD_ROWS) * B;
  const long long slots = (long long)BWD_MIN_CTAS * sms;
  return (int)std::min<long long>(BWD_MAX_STEPS, std::max<long long>(1, (groups + slots - 1) / slots));
}

template <typename TX>
int launch_bwd(const void* x, const float* flow, const float* gout, float4* gt, void* d_inp,
               float* d_flow, int B, int C, Geom g, int device, cudaStream_t st) {
  const int HWo = g.Ho * g.Wo, Cp = (C + CHUNK - 1) / CHUNK * CHUNK;
  int sms = 0;
  const int qerr = sm_count(device, &sms);
  if (qerr) return qerr;
  splat_bwd_layout_kernel<<<dim3((HWo + THREADS - 1) / THREADS, B), THREADS, 0, st>>>(
      gout, C, Cp, HWo, gt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // vector accesses of BWD_SPT sources need W % BWD_SPT == 0 and aligned bases
  const uintptr_t xa = sizeof(TX) * BWD_SPT - 1, fa = sizeof(float) * BWD_SPT - 1;
  const int vec = g.W % BWD_SPT == 0 && !(reinterpret_cast<uintptr_t>(x) & xa) &&
                  !(reinterpret_cast<uintptr_t>(d_inp) & xa) &&
                  !(reinterpret_cast<uintptr_t>(flow) & fa) &&
                  !(reinterpret_cast<uintptr_t>(d_flow) & fa);
  const int steps = bwd_steps(B, g.H, g.W, sms);
  const dim3 grid((g.W + 32 * BWD_SPT - 1) / (32 * BWD_SPT),
                  (g.H + BWD_ROWS * steps - 1) / (BWD_ROWS * steps), B);
  const int scale = (int)g.scale;
  const TX* xp = static_cast<const TX*>(x);
  TX* dp = static_cast<TX*>(d_inp);
  const dim3 block(32, BWD_ROWS);
  if (scale & (scale - 1)) {
    if (C == CHUNK)
      splat_bwd_kernel<TX, DivRN, CHUNK><<<grid, block, 0, st>>>(xp, flow, gt, C, g, DivRN(), vec,
                                                                steps, dp, d_flow);
    else
      splat_bwd_kernel<TX, DivRN, 0><<<grid, block, 0, st>>>(xp, flow, gt, C, g, DivRN(), vec,
                                                            steps, dp, d_flow);
  } else {
    const DivPow2 div{1.f / g.scale};
    if (C == CHUNK)
      splat_bwd_kernel<TX, DivPow2, CHUNK><<<grid, block, 0, st>>>(xp, flow, gt, C, g, div, vec,
                                                                  steps, dp, d_flow);
    else
      splat_bwd_kernel<TX, DivPow2, 0><<<grid, block, 0, st>>>(xp, flow, gt, C, g, div, vec,
                                                              steps, dp, d_flow);
  }
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

// The backward's scratch in bytes for (B, C, H, W, scale): the wrapper
// allocates it (uninitialised) and passes it to ofd_splat_bwd.
long long ofd_splat_bwd_scratch_bytes(int B, int C, int H, int W, int scale) {
  if (B < 1 || C < 1 || scale < 1 || H < scale || W < scale) return -1;
  return bwd_scratch_bytes(B, C, H / scale, W / scale);
}

// Backward.  x and flow as above, g (B, C, H/scale, W/scale) float32;
// d_inp (B, C, H, W) in x's dtype, d_flow (B, 2, H, W) float32; scratch:
// ofd_splat_bwd_scratch_bytes of 16-byte aligned device memory.  Two
// launches (the channels-last cotangent, then the gathers).
int ofd_splat_bwd(const void* x, const void* flow, const void* gout, int x_bf16, void* scratch,
                  long long scratch_bytes, void* d_inp, void* d_flow, int B, int C, int H, int W,
                  int scale, int ox, int oy, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || C < 1 || scale < 1 || H < scale || W < scale || ox < 0 || ox >= scale ||
      oy < 0 || oy >= scale || B > 65535 || (long long)H * W > INT_MAX / 2 ||
      (H + BWD_ROWS - 1) / BWD_ROWS > 65535 ||
      scratch_bytes != bwd_scratch_bytes(B, C, H / scale, W / scale) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g = make_geom(H, W, scale, ox, oy);
  const float* fl = static_cast<const float*>(flow);
  const float* go = static_cast<const float*>(gout);
  float4* gt = static_cast<float4*>(scratch);
  float* df = static_cast<float*>(d_flow);
  return x_bf16 ? launch_bwd<bf16>(x, fl, go, gt, d_inp, df, B, C, g, device, st)
                : launch_bwd<float>(x, fl, go, gt, d_inp, df, B, C, g, device, st);
}

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
