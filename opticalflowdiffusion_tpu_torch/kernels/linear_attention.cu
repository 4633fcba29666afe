// Fused pre-LN linear-attention block, forward and backward, for Hopper (sm_90a).
//
//   y = x + postLN(W_out @ middle(W_qkv @ preLN(x)) + b_out)
//
// on x of shape (B, C, N) (a flattened NCHW map), heads * dim_head = 4 * 32.
// Replaces the two forward Pallas TPU kernels of the JAX package's
// ops/attention_fused.py::_fused_block_pallas (the three backward ones:
// "backward" below; the two of ops/attention_pallas.py, the unfused
// LinearAttention's middle: "unfused middle" below):
//
//   la_ctx_kernel  <- _ctx_kernel (pass A): preLN -> k, v -> k-softmax over N
//                     with an online max -> ctx = softmax_N(k)^T v per head,
//                     plus the final max m and denominator s.
//   la_out_kernel  <- _out_kernel (pass B): preLN -> q -> per-head softmax
//                     over d -> q' ctx / N -> W_out + b -> postLN -> + x.
//
// Numerics follow the TPU kernels: matmul operands are bf16 with f32
// accumulation (also when x is f32); LayerNorm statistics, softmaxes and the
// context sums are f32.  The context is kept per head, (4, 32, 32), instead
// of the TPU's block-diagonal (128, 128).
//
// Design (a first, simple version): one CTA of 256 threads per tile of
// T = 32 positions.  The x tile is read straight from global memory (the
// (C, N) layout makes a warp's 32 lanes read 32 neighbouring positions), the
// normalised tile is kept in shared memory as bf16, and the projections run
// on tensor cores through WMMA 16x16x16 fragments whose B operand (the
// weights) is loaded from global memory (L1/L2 resident: at most 384 KB).
// Pass A spreads the N tiles of one batch element over P CTAs; each CTA
// keeps its running max, sum and context in registers and writes them as a
// partial; the last CTA of the batch element (atomic ticket) combines the P
// partials.
//
// Bound on the H100: both passes move little (x read once, y written once,
// weights tiny).  Pass B does ~2 * 256 * C bf16 tensor FLOPs per position and
// is bound by its bytes.  Pass A's least time is set by its f32 context sums
// (2 * 4096 FLOPs per position on CUDA cores, 67 TFLOP/s), not by its bf16
// projection or its bytes.  Nothing here uses TMA or wgmma yet; that is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HD = 128;                      // heads * dim_head
constexpr int DH = 32;                       // dim_head
constexpr int NH = HD / DH;                  // heads
constexpr int T = 32;                        // positions per tile (= warp size)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LDT = T + 8;                   // [C][T] tiles (bf16 and f32)
constexpr int LDK = 2 * HD + 8;              // [T][2HD] k|v tile (f32)
constexpr int LDQ = HD + 8;                  // [T][HD] q tiles (f32 and bf16)
constexpr int PART = 2 * HD + NH * DH * DH;  // one partial: m, s, ctx
constexpr float EPS = 1e-5f;
constexpr float Q_SCALE = 0.17677669529663687f;  // dim_head ** -0.5

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, bf16) {
  return __bfloat162float(__float2bfloat16(v));
}

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

// x[c, n0 + t] of one batch element
template <typename TX>
struct XSrc {
  const TX* col;  // &x[b, 0, n0]
  int N;
  __device__ float operator()(int c, int t) const {
    return to_f(col[(size_t)c * N + t]);
  }
};

// o[c][t] + bias[c] from a column-major f32 tile in shared memory
struct OSrc {
  const float* o;
  const float* bias;
  __device__ float operator()(int c, int t) const { return o[c * LDT + t] + bias[c]; }
};

// Per-position LayerNorm statistics over C channels: lane = position t,
// warp = channel group.  Two passes (mean, then mean of squared deviations)
// as jnp.var computes it.  Leaves mean in stat[t], rstd in stat[T + t].
template <typename Src>
__device__ void ln_stats(const Src& src, int C, int nvalid, float* red, float* stat) {
  const int t = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool ok = t < nvalid;
  float acc = 0.f;
  if (ok)
    for (int c = warp; c < C; c += WARPS) acc += src(c, t);
  red[warp * T + t] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * T + t];
    stat[t] = s / C;
  }
  __syncthreads();
  const float mean = stat[t];
  acc = 0.f;
  if (ok)
    for (int c = warp; c < C; c += WARPS) {
      const float d = src(c, t) - mean;
      acc += d * d;
    }
  red[warp * T + t] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * T + t];
    stat[T + t] = rsqrtf(s / C + EPS);
  }
  __syncthreads();
}

// lnS[c][t] = bf16(preLN(x)[c, t] * g[c]); zero for t >= nvalid.
template <typename TX>
__device__ void pre_ln(const XSrc<TX>& src, const float* __restrict__ g, int C,
                       int nvalid, bf16* lnS, float* red, float* stat) {
  ln_stats(src, C, nvalid, red, stat);
  const int t = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool ok = t < nvalid;
  const float mean = stat[t], rstd = stat[T + t];
  for (int c = warp; c < C; c += WARPS) {
    const float v = ok ? (src(c, t) - mean) * rstd * g[c] : 0.f;
    lnS[c * LDT + t] = __float2bfloat16(v);
  }
  __syncthreads();
}

// out[t][j] = sum_c lnS[c][t] * W[j][c] for j < ncols, with W (ncols, C)
// row-major bf16 in global memory; out row-major f32 with leading dim ldo.
__device__ void project(const bf16* lnS, const bf16* __restrict__ W, int C,
                        int ncols, float* out, int ldo) {
  const int warp = threadIdx.x >> 5;
  for (int jt = warp; jt < ncols / 16; jt += WARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T / 16];
    for (int i = 0; i < T / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, W + (size_t)jt * 16 * C + k, C);
      for (int i = 0; i < T / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, lnS + k * LDT + i * 16, LDT);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
    for (int i = 0; i < T / 16; ++i)
      wmma::store_matrix_sync(out + i * 16 * ldo + jt * 16, acc[i], ldo,
                              wmma::mem_row_major);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t ctx_smem(int C) {
  return align128((size_t)C * LDT * sizeof(bf16)) + (size_t)T * LDK * sizeof(float) +
         (size_t)(WARPS * T + 2 * T + HD) * sizeof(float);
}

// One tile of a context pass.  kvS [T][LDK] holds k (columns 0 .. HD-1) and
// v (HD .. 2HD-1) of nvalid positions, f32; it is rewritten with exp(k - m).
// Thread tid < HD keeps channel tid's running max m_run and sum s_run of
// exp(k - m_run); every thread keeps its 16 context sums acc (head h,
// k-channel d, v columns e0 .. e0 + 15), rescaled as m_run grows.  A tile's
// terms are summed on their own before they join acc (a two-level sum, so a
// CTA's long run of tiles does not grow the rounding error of its sums).
// chS: HD floats of scratch.
__device__ __forceinline__ void ctx_tile(float* kvS, int nvalid, float* chS, float& m_run,
                                         float& s_run, float (&acc)[16]) {
  const int tid = threadIdx.x;
  const int h = tid / 64, d = (tid % 64) / 2, e0 = (tid % 2) * 16;
  const int kj = h * DH + d;
  if (tid < HD) {
    float mt = -INFINITY;
    for (int t = 0; t < nvalid; ++t) mt = fmaxf(mt, kvS[t * LDK + tid]);
    const float m_new = fmaxf(m_run, mt);
    const float alpha = expf(m_run - m_new);
    float ssum = 0.f;
    for (int t = 0; t < nvalid; ++t) {
      const float e = expf(kvS[t * LDK + tid] - m_new);
      kvS[t * LDK + tid] = e;
      ssum += e;
    }
    s_run = s_run * alpha + ssum;
    m_run = m_new;
    chS[tid] = alpha;
  }
  __syncthreads();
  const float alpha = chS[kj];
  float tsum[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) tsum[i] = 0.f;
  for (int t = 0; t < nvalid; ++t) {
    const float ek = kvS[t * LDK + kj];
    const float* vrow = kvS + t * LDK + HD + h * DH + e0;
#pragma unroll
    for (int i = 0; i < 16; ++i) tsum[i] += ek * vrow[i];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = acc[i] * alpha + tsum[i];
  __syncthreads();
}

// The end of a context pass over grid (P, B): this CTA writes its partial
// (m, s, context sums) of batch element b to part (B, P, PART); the last CTA
// of b to finish (an atomic ticket on counter[b], which it leaves zero)
// combines the P partials in the order p = 0 .. P-1 into ctx_out (B, NH, DH,
// DH) = sums / s and, where given, m_out and s_out (B, HD).  The same bits
// on every run: no float atomics.  scratch: 2 HD floats.
__device__ __forceinline__ void ctx_finish(float* __restrict__ part, int* __restrict__ counter,
                                           float m_run, float s_run, const float (&acc)[16],
                                           float* scratch, float* __restrict__ ctx_out,
                                           float* __restrict__ m_out,
                                           float* __restrict__ s_out, int b, int p, int P) {
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int kj = (tid / 64) * DH + (tid % 64) / 2, e0 = (tid % 2) * 16;
  float* pb = part + ((size_t)b * P + p) * PART;
  if (tid < HD) {
    pb[tid] = m_run;
    pb[HD + tid] = s_run;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) pb[2 * HD + kj * DH + e0 + i] = acc[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter + b, 1) == P - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  const float* base = part + (size_t)b * P * PART;
  if (tid < HD) {
    float m = -INFINITY;
    for (int q = 0; q < P; ++q) m = fmaxf(m, __ldcg(base + q * PART + tid));
    float s = 0.f;
    for (int q = 0; q < P; ++q)
      s += __ldcg(base + q * PART + HD + tid) * expf(__ldcg(base + q * PART + tid) - m);
    if (m_out != nullptr) {
      m_out[b * HD + tid] = m;
      s_out[b * HD + tid] = s;
    }
    scratch[tid] = m;
    scratch[HD + tid] = s;
  }
  __syncthreads();
  const float m = scratch[kj], s = scratch[HD + kj];
  float out[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = 0.f;
  for (int q = 0; q < P; ++q) {
    const float w = expf(__ldcg(base + q * PART + kj) - m);
    const float* pc = base + q * PART + 2 * HD + kj * DH + e0;
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] += w * __ldcg(pc + i);
  }
  float* co = ctx_out + (size_t)b * NH * DH * DH + kj * DH + e0;
#pragma unroll
  for (int i = 0; i < 16; ++i) co[i] = out[i] / s;
  if (tid == 0) counter[b] = 0;
}

// Pass A.  grid (P, B).  part: (B, P, PART) f32 scratch; counter: (B,) int32,
// zero on entry and left zero.  Outputs ctx (B, NH, DH, DH), m and s (B, HD).
template <typename TX>
__global__ void __launch_bounds__(THREADS)
la_ctx_kernel(const TX* __restrict__ x, const float* __restrict__ g_pre,
              const bf16* __restrict__ w_kv, float* __restrict__ part,
              int* __restrict__ counter, float* __restrict__ ctx_out,
              float* __restrict__ m_out, float* __restrict__ s_out, int C, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* lnS = reinterpret_cast<bf16*>(smem);
  float* kvS = reinterpret_cast<float*>(smem + align128((size_t)C * LDT * sizeof(bf16)));
  float* red = kvS + T * LDK;
  float* stat = red + WARPS * T;
  float* chS = stat + 2 * T;

  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int ntiles = (N + T - 1) / T;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, s_run = 0.f;  // channel tid, for tid < HD

  for (int tile = p; tile < ntiles; tile += P) {
    const int n0 = tile * T;
    const int nvalid = min(T, N - n0);
    XSrc<TX> src{x + (size_t)b * C * N + n0, N};
    pre_ln(src, g_pre, C, nvalid, lnS, red, stat);
    project(lnS, w_kv, C, 2 * HD, kvS, LDK);
    __syncthreads();
    ctx_tile(kvS, nvalid, chS, m_run, s_run, acc);
  }
  static_assert(WARPS * T >= 2 * HD, "red holds the combine's 2 HD floats");
  // red is free for the combine
  ctx_finish(part, counter, m_run, s_run, acc, red, ctx_out, m_out, s_out, b, p, P);
}

size_t out_smem(int C) {
  return align128((size_t)C * LDT * sizeof(bf16)) +   // lnS
         align128((size_t)T * LDQ * sizeof(float)) +  // qS (q, then attn f32)
         align128((size_t)T * LDQ * sizeof(bf16)) +   // qpS (q', then attn bf16)
         align128((size_t)NH * DH * DH * sizeof(bf16)) +  // ctxS
         align128((size_t)C * LDT * sizeof(float)) +  // oS
         (size_t)(WARPS * T + 2 * T) * sizeof(float);
}

// Pass B.  grid (ceil(N / T), B).  ctx (B, NH, DH, DH) from pass A.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
la_out_kernel(const TX* __restrict__ x, const float* __restrict__ g_pre,
              const bf16* __restrict__ w_q, const float* __restrict__ ctx,
              const bf16* __restrict__ w_out, const float* __restrict__ b_out,
              const float* __restrict__ g_post, TX* __restrict__ y, int C, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  bf16* lnS = reinterpret_cast<bf16*>(smem + off);
  off += align128((size_t)C * LDT * sizeof(bf16));
  float* qS = reinterpret_cast<float*>(smem + off);
  off += align128((size_t)T * LDQ * sizeof(float));
  bf16* qpS = reinterpret_cast<bf16*>(smem + off);
  off += align128((size_t)T * LDQ * sizeof(bf16));
  bf16* ctxS = reinterpret_cast<bf16*>(smem + off);
  off += align128((size_t)NH * DH * DH * sizeof(bf16));
  float* oS = reinterpret_cast<float*>(smem + off);
  off += align128((size_t)C * LDT * sizeof(float));
  float* red = reinterpret_cast<float*>(smem + off);
  float* stat = red + WARPS * T;

  const int b = blockIdx.y, n0 = blockIdx.x * T;
  const int nvalid = min(T, N - n0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float inv_n = 1.f / (float)N;

  for (int i = tid; i < NH * DH * DH; i += THREADS)
    ctxS[i] = __float2bfloat16(ctx[(size_t)b * NH * DH * DH + i] * inv_n);

  XSrc<TX> src{x + (size_t)b * C * N + n0, N};
  pre_ln(src, g_pre, C, nvalid, lnS, red, stat);
  project(lnS, w_q, C, HD, qS, LDQ);
  __syncthreads();

  // per-head softmax over the 32 channels of a head: one warp per (t, head)
  for (int r = warp; r < T * NH; r += WARPS) {
    const int t = r / NH, hh = r % NH;
    const float v = qS[t * LDQ + hh * DH + lane];
    const float e = expf(v - warp_max(v));
    const float sq = e / warp_sum(e);
    qpS[t * LDQ + hh * DH + lane] = __float2bfloat16(sq * Q_SCALE);
  }
  __syncthreads();

  // attn[t][h*DH + e] = sum_d q'[t][h*DH + d] * ctx[h][d][e] / N  -> qS (f32)
  constexpr int TILES_PER_HEAD = (T / 16) * (DH / 16);
  for (int tile = warp; tile < NH * TILES_PER_HEAD; tile += WARPS) {
    const int hh = tile / TILES_PER_HEAD, rem = tile % TILES_PER_HEAD;
    const int i = rem / (DH / 16), j = rem % (DH / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
    wmma::fill_fragment(fc, 0.f);
    for (int k = 0; k < DH; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, qpS + i * 16 * LDQ + hh * DH + k, LDQ);
      wmma::load_matrix_sync(fb, ctxS + hh * DH * DH + k * DH + j * 16, DH);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(qS + i * 16 * LDQ + hh * DH + j * 16, fc, LDQ,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < T * HD; i += THREADS) {
    const int t = i / HD, j = i % HD;
    qpS[t * LDQ + j] = __float2bfloat16(qS[t * LDQ + j]);
  }
  __syncthreads();

  // o[c][t] = sum_j attn[t][j] * W_out[c][j]  (oS column-major)
  for (int jt = warp; jt < C / 16; jt += WARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T / 16];
    for (int i = 0; i < T / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k = 0; k < HD; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, w_out + (size_t)jt * 16 * HD + k, HD);
      for (int i = 0; i < T / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, qpS + i * 16 * LDQ + k, LDQ);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
    for (int i = 0; i < T / 16; ++i)
      wmma::store_matrix_sync(oS + jt * 16 * LDT + i * 16, acc[i], LDT,
                              wmma::mem_col_major);
  }
  __syncthreads();

  // postLN(o + b_out) * g_post + x
  OSrc osrc{oS, b_out};
  ln_stats(osrc, C, nvalid, red, stat);
  const int t = lane;
  if (t < nvalid) {
    const float mean = stat[t], rstd = stat[T + t];
    TX* yb = y + (size_t)b * C * N + n0 + t;
    for (int c = warp; c < C; c += WARPS) {
      const float o = (osrc(c, t) - mean) * rstd * g_post[c];
      put(yb + (size_t)c * N, src(c, t) + o);
    }
  }
}

// ------------------------------------------------------------ unfused middle
//
// The linear-attention middle of the unfused LinearAttention module, on
// packed qkv (B, 3 HD, N) laid out as its 1x1 conv to_qkv gives it (channel
// s * HD + h * DH + d, N fastest; the batch stride may be larger).  Replaces
// the two Pallas TPU kernels of the JAX package's ops/attention_pallas.py:
//
//   la_mid_ctx_kernel <- _ctx_kernel (pass A): per (h, d) channel an online
//                        max and sum over N of exp(k), and the per-head
//                        context ctx[h][d][e] = sum_n softmax_N(k)[n, h, d]
//                        v[n, h, e], f32 (B, NH, DH, DH).
//   la_mid_out_kernel <- _out_kernel (pass B): per position and head q' =
//                        softmax_d(q) * DH^-0.5 and out[h, e] = sum_d q'[d]
//                        ctx[h][d][e] / N, rounded once to qkv's dtype and
//                        written (B, HD, N).
//
// Numerics are the TPU kernels': f32 exponentials, sums and products on the
// values of qkv (bf16 or f32), the context kept per head (the TPU's
// block-diagonal (128, 128) without its zeros), ctx / N folded into pass B.
// N takes any value: a ragged last tile leaves its tail out of every sum
// (the TPU pads N with k = -1e30).  Pass A runs la_ctx_kernel's tile update
// and its ordered last-CTA combine on k and v read straight from qkv.  The
// TPU's roll-max cascade and selector matmuls exist for its 128-lane tiles
// and have no counterpart here.
//
// Bound on the H100: pass A reads k and v, pass B reads q and writes out:
// 2 HD values per position each, ~470 MB at B 2, N 458752 in bf16 (0.14
// ms).  Their f32 arithmetic (2 * 4096 FLOP per position on CUDA cores) is
// the next bound.  A first, simple version: one CTA of 256 threads per tile
// of 32 positions, the tile staged in shared memory as f32.
constexpr int LDM = T + 1;  // [HD][T] f32 q tile of pass B

// Pass A.  grid (P, B).  part (B, P, PART) f32 scratch; counter (B,) int32,
// zero on entry and left zero; ctx (B, NH, DH, DH) f32.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
la_mid_ctx_kernel(const TX* __restrict__ qkv, long long batch_stride, float* __restrict__ part,
                  int* __restrict__ counter, float* __restrict__ ctx_out, int N) {
  __shared__ __align__(16) float kvS[T * LDK];
  __shared__ float scratch[2 * HD];
  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int tid = threadIdx.x;
  const int ntiles = (N + T - 1) / T;
  const TX* kv = qkv + (size_t)b * batch_stride + (size_t)HD * N;  // k, then v
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, s_run = 0.f;

  for (int tile = p; tile < ntiles; tile += P) {
    const int n0 = tile * T;
    const int nvalid = min(T, N - n0);
    for (int i = tid; i < 2 * HD * T; i += THREADS) {
      const int j = i / T, t = i % T;
      kvS[t * LDK + j] = t < nvalid ? to_f(kv[(size_t)j * N + n0 + t]) : 0.f;
    }
    __syncthreads();
    ctx_tile(kvS, nvalid, scratch, m_run, s_run, acc);
  }
  ctx_finish(part, counter, m_run, s_run, acc, scratch, ctx_out, nullptr, nullptr, b, p, P);
}

// Pass B.  grid (ceil(N / T), B).  ctx (B, NH, DH, DH) f32 from pass A; out
// (B, HD, N) in TX.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
la_mid_out_kernel(const TX* __restrict__ qkv, long long batch_stride,
                  const float* __restrict__ ctx, TX* __restrict__ out, int N) {
  __shared__ float qS[HD * LDM];       // q[j][t], then q'
  __shared__ float ctxS[NH * DH * DH];  // ctx / N
  const int b = blockIdx.y, n0 = blockIdx.x * T;
  const int nvalid = min(T, N - n0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TX* q = qkv + (size_t)b * batch_stride + n0;
  for (int i = tid; i < NH * DH * DH; i += THREADS)
    ctxS[i] = ctx[(size_t)b * NH * DH * DH + i] / (float)N;
  for (int i = tid; i < HD * T; i += THREADS) {
    const int j = i / T, t = i % T;
    qS[j * LDM + t] = t < nvalid ? to_f(q[(size_t)j * N + t]) : 0.f;
  }
  __syncthreads();
  // softmax over d: thread (head tid / T, position tid % T)
  if (tid < NH * T) {
    float* qh = qS + (tid / T) * DH * LDM + tid % T;
    float m = -INFINITY;
    for (int d = 0; d < DH; ++d) m = fmaxf(m, qh[d * LDM]);
    float sum = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float e = expf(qh[d * LDM] - m);
      qh[d * LDM] = e;
      sum += e;
    }
    for (int d = 0; d < DH; ++d) qh[d * LDM] = qh[d * LDM] / sum * Q_SCALE;
  }
  __syncthreads();
  // out[h * DH + e][t] for e = e0 .. e0 + 15: warp -> (h, e0), lane -> t
  const int h = warp / 2, e0 = (warp % 2) * 16;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int d = 0; d < DH; ++d) {
    const float qd = qS[(h * DH + d) * LDM + lane];
    const float* crow = ctxS + h * DH * DH + d * DH + e0;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = fmaf(qd, crow[i], acc[i]);
  }
  if (lane < nvalid) {
    TX* o = out + (size_t)b * HD * N + (size_t)(h * DH + e0) * N + n0 + lane;
#pragma unroll
    for (int i = 0; i < 16; ++i) put(o + (size_t)i * N, acc[i]);
  }
}

static_assert(NH * T <= THREADS && WARPS * 16 == HD, "la_mid_out_kernel's thread layout");

// ------------------------------------------------------------------ backward
//
// The block's backward, recompute-based like the TPU's (nothing but ctx, m
// and s is saved from the forward):
//
//   la_bwd_q_kernel    <- _bwd_q_kernel (pass B'): recompute preLN -> q ->
//                         softmax -> attn -> W_out -> postLN, run the chain
//                         backward: dx_q (with the residual dy), dW_out,
//                         db_out, dW_q, the gain gradients and dctx.
//   la_bwd_kv1_kernel  <- _bwd_kv1_kernel (pass A'1): recompute k' = exp(k -
//                         m) / s and sum the k-softmax coupling sdot = sum_n
//                         k' * dk', dk' = (v / N) headmask(dctx)^T.
//   la_bwd_kv2_kernel  <- _bwd_kv2_kernel (pass A'2): dk = k' (dk' - sdot),
//                         dv = k' headmask(dctx) / N, dW_kv, the pre-LN gain
//                         gradient and dx = dx_q + dx_kv.
//
// Numerics follow the TPU kernels: the products that they take on operands
// cast to the compute dtype (the projections, attn, o, dattn and dln) are
// bf16 WMMA with f32 accumulation; those they take on f32 operands (dctx,
// dq', dk', dv and the weight gradients) are f32 on CUDA cores; the
// LayerNorm and softmax backwards are f32.
//
// Sequential grid -> parallel grid.  The TPU carries dW, the gain gradients,
// dctx and sdot across its sequential grid.  Here a CTA of grid (P, B) walks
// the tiles p, p + P, ... of batch element b and keeps its partial sums:
// dctx in registers, the gain gradients in shared memory, the weight
// gradients in shared memory where they fit (C = 64) and otherwise in the
// CTA's own slot of the global scratch (L2-resident).  It ends by writing one
// record; la_reduce_kernel then sums the records in a fixed order, so the
// results are the same bits on every run (no float atomics).  sdot must be
// complete for a batch element before pass A'2 forms any dk, which is why the
// passes are separate launches.
//
// Bound on the H100: pass B' does 2 * (2 * 128 * C + 128 * 32 * 2) bf16 and
// ~2 * (2 * 128 * C + 2 * 4096) f32 operations per position, pass A'2
// 2 * 2 * 256 * C bf16 and ~2 * (256 * C + 2 * 4096) f32, pass A'1 2 * 256 * C
// bf16 and 2 * 4096 f32; at these widths the f32 work (CUDA cores, 67
// TFLOP/s) is the bound, above the bytes (x, dy read once, dx written once).
// The weight-gradient update reads its operands from shared memory and
// adds into the partial once per tile of 32 positions; nothing uses TMA or
// wgmma yet.
//
// Width.  The passes take C <= 512, the widest block of the flagship.  What
// set the limit is shared memory: the [C][T] tiles grow with C, and at C =
// 512 pass B' (with a bf16 copy of do beside its f32 one) and pass A'2 (with
// dln in a region of its own) needed 244 and 242 KB, past the 227 KB a CTA
// may have.  Pass B' converts do to bf16 in chunks of DO_CHUNK channels
// into a tile that is free at that point, and pass A'2 lays dln over lnS,
// kvS and dkvS, which are dead once the tile's weight-gradient update is
// done: 204 and 162 KB at C = 512.  The arithmetic and its order are those
// of the separate tiles.

constexpr int LDK2 = 2 * HD + 8;  // [T][2HD] f32/bf16 rows
constexpr int DO_CHUNK = 64;       // channels of do in bf16 at a time (pass B')
static_assert(DO_CHUNK * LDT <= T * LDQ, "a chunk of do fits in qpB");
static_assert(HD / 16 == WARPS, "pass B' gives each warp one column tile of dattn");

// Sum over the WARPS channel groups of per-lane (position) partials a, b:
// out_a[t] = sum / C, out_b[t] = sum / C.
__device__ void mean_over_warps(float a, float b, int C, float* red, float* out_a,
                                float* out_b) {
  const int t = threadIdx.x & 31, warp = threadIdx.x >> 5;
  red[warp * T + t] = a;
  red[(WARPS + warp) * T + t] = b;
  __syncthreads();
  if (warp == 0) {
    float sa = 0.f, sb = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      sa += red[w * T + t];
      sb += red[(WARPS + w) * T + t];
    }
    out_a[t] = sa / C;
    out_b[t] = sb / C;
  }
  __syncthreads();
}

// acc[r * S + s] += sum_t A(t, r) * B(t, s) over the T positions of a tile,
// f32.  The 256 threads form 16 x 16 and each takes a 4 x 4 micro-tile of
// every 64 x 64 block of the R x S output.
template <typename FA, typename FB>
__device__ void wgrad_update(float* acc, int R, int S, const FA& A, const FB& B) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int rb = 0; rb < R; rb += 64)
    for (int sb = 0; sb < S; sb += 64) {
      float sum[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) sum[i][k] = 0.f;
      for (int t = 0; t < T; ++t) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rb + ty + 16 * i;
          a[i] = r < R ? A(t, r) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int s = sb + tx + 16 * k;
          bv[k] = s < S ? B(t, s) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) sum[i][k] = fmaf(a[i], bv[k], sum[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = rb + ty + 16 * i, s = sb + tx + 16 * k;
          if (r < R && s < S) acc[(size_t)r * S + s] += sum[i][k];
        }
    }
}

// out (T x ncols) f32 row-major = A (T x K) @ W (K x ncols), A bf16 row-major
// in shared memory (leading dim lda), W bf16 row-major in global memory
// (leading dim ncols); stored column-major [col][t] with leading dim LDT.
__device__ void mm_rows_to_cols(const bf16* A, int lda, const bf16* __restrict__ W, int K,
                                int ncols, float* out) {
  const int warp = threadIdx.x >> 5;
  for (int ct = warp; ct < ncols / 16; ct += WARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T / 16];
    for (int i = 0; i < T / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, W + (size_t)k * ncols + ct * 16, ncols);
      for (int i = 0; i < T / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, A + i * 16 * lda + k, lda);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
    for (int i = 0; i < T / 16; ++i)
      wmma::store_matrix_sync(out + ct * 16 * LDT + i * 16, acc[i], LDT, wmma::mem_col_major);
  }
}

// LayerNorm backward into x and the gain gradient, given dln[c][t] (f32,
// [C][LDT]) and the statistics of x in stat (mean, rstd): dg_acc[c] +=
// sum_t dln * xhat, dx = rstd (dln g - mean(dln g) - xhat mean(dln g xhat)),
// written as put(dx, extra(c, t) + dx) for the valid positions.
template <typename TX, typename Extra>
__device__ void ln_backward(const XSrc<TX>& src, const float* dln, const float* __restrict__ g,
                            int C, int nvalid, const float* stat, float* red, float* m12,
                            float* dg_acc, TX* dx, int N, const Extra& extra) {
  const int t = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool ok = t < nvalid;
  const float mean = stat[t], rstd = stat[T + t];
  float s1 = 0.f, s2 = 0.f;
  for (int c = warp; c < C; c += WARPS) {
    const float xh = ok ? (src(c, t) - mean) * rstd : 0.f;
    const float d = ok ? dln[c * LDT + t] : 0.f;
    const float gsum = warp_sum(d * xh);
    if (t == 0) dg_acc[c] += gsum;
    const float dg = d * g[c];
    s1 += dg;
    s2 += dg * xh;
  }
  mean_over_warps(s1, s2, C, red, m12, m12 + T);
  if (ok) {
    const float m1 = m12[t], m2 = m12[T + t];
    for (int c = warp; c < C; c += WARPS) {
      const float xh = (src(c, t) - mean) * rstd;
      const float dg = dln[c * LDT + t] * g[c];
      put(dx + (size_t)c * N + t, extra(c, t, (dg - m1 - xh * m2) * rstd));
    }
  }
}

// Per-CTA record of pass B': dW_out (C, HD) | dW_q (HD, C) | db_out | dg_pre |
// dg_post (C each) | dctx (NH, DH, DH).
__host__ __device__ inline size_t bwdq_record(int C) {
  return (size_t)2 * C * HD + 3 * C + NH * DH * DH;
}

__host__ __device__ inline size_t bwdq_smem(int C, bool acc_smem) {
  return align128((size_t)C * LDT * sizeof(bf16)) +        // lnS
         align128((size_t)T * LDQ * sizeof(float)) +       // qS: q, sq, dq
         align128((size_t)T * LDQ * sizeof(bf16)) +        // qpB: q', then dq
         align128((size_t)NH * DH * DH * sizeof(bf16)) +   // ctxB = bf16(ctx / N)
         align128((size_t)NH * DH * DH * sizeof(float)) +  // ctxT = ctx / N, [h][e][d]
         align128((size_t)T * LDQ * sizeof(float)) +       // attnS: attn, dattn
         align128((size_t)T * LDQ * sizeof(bf16)) +        // attnB
         align128((size_t)C * LDT * sizeof(float)) +       // oS: o, do, dln
         align128((size_t)(2 * WARPS * T + 6 * T + 3 * C) * sizeof(float)) +
         (acc_smem ? (size_t)2 * C * HD * sizeof(float) : 0);
}

// Pass B'.  grid (P, B).  x, dy (B, C, N) in TX; ctx (B, NH, DH, DH) from
// pass A; dxq (B, C, N) in TX; part (B * P, bwdq_record(C)) f32 scratch.
template <typename TX>
__global__ void __launch_bounds__(THREADS, 1)
la_bwd_q_kernel(const TX* __restrict__ x, const TX* __restrict__ dy,
                const float* __restrict__ g_pre, const bf16* __restrict__ w_q,
                const float* __restrict__ ctx, const bf16* __restrict__ w_out,
                const float* __restrict__ b_out, const float* __restrict__ g_post,
                TX* __restrict__ dxq, float* __restrict__ part, int acc_smem, int C,
                int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  auto carve = [&](size_t bytes) {
    unsigned char* p = smem + off;
    off += align128(bytes);
    return p;
  };
  bf16* lnS = reinterpret_cast<bf16*>(carve((size_t)C * LDT * sizeof(bf16)));
  float* qS = reinterpret_cast<float*>(carve((size_t)T * LDQ * sizeof(float)));
  bf16* qpB = reinterpret_cast<bf16*>(carve((size_t)T * LDQ * sizeof(bf16)));
  bf16* ctxB = reinterpret_cast<bf16*>(carve((size_t)NH * DH * DH * sizeof(bf16)));
  float* ctxT = reinterpret_cast<float*>(carve((size_t)NH * DH * DH * sizeof(float)));
  float* attnS = reinterpret_cast<float*>(carve((size_t)T * LDQ * sizeof(float)));
  bf16* attnB = reinterpret_cast<bf16*>(carve((size_t)T * LDQ * sizeof(bf16)));
  float* oS = reinterpret_cast<float*>(carve((size_t)C * LDT * sizeof(float)));
  float* red = reinterpret_cast<float*>(
      carve((size_t)(2 * WARPS * T + 6 * T + 3 * C) * sizeof(float)));
  float* stat = red + 2 * WARPS * T;  // mean_x, rstd_x | mean_o, rstd_o | m1, m2
  float* dbout = stat + 6 * T;
  float* dgpre = dbout + C;
  float* dgpost = dgpre + C;

  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (N + T - 1) / T;
  float* rec = part + ((size_t)b * P + p) * bwdq_record(C);
  float* dW_out = acc_smem ? reinterpret_cast<float*>(smem + off) : rec;  // (C, HD)
  float* dW_q = dW_out + (size_t)C * HD;                                  // (HD, C)

  for (int i = tid; i < 2 * C * HD; i += THREADS) dW_out[i] = 0.f;
  for (int i = tid; i < 3 * C; i += THREADS) dbout[i] = 0.f;
  for (int i = tid; i < NH * DH * DH; i += THREADS) {
    const float cn = __fdiv_rn(ctx[(size_t)b * NH * DH * DH + i], (float)N);
    ctxB[i] = __float2bfloat16(cn);
    const int h = i / (DH * DH), d = (i / DH) % DH, e = i % DH;
    ctxT[h * DH * DH + e * DH + d] = cn;
  }
  // dctx entries of this thread: head h, row d, columns e0 .. e0 + 15
  const int h_ = tid / 64, d_ = (tid % 64) / 2, e0 = (tid % 2) * 16;
  float dctx[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dctx[i] = 0.f;
  __syncthreads();

  for (int tile = p; tile < ntiles; tile += P) {
    const int n0 = tile * T;
    const int nvalid = min(T, N - n0);
    const bool ok = lane < nvalid;
    XSrc<TX> src{x + (size_t)b * C * N + n0, N};
    XSrc<TX> dsrc{dy + (size_t)b * C * N + n0, N};

    // ---- recompute the q path (as la_out_kernel)
    pre_ln(src, g_pre, C, nvalid, lnS, red, stat);
    project(lnS, w_q, C, HD, qS, LDQ);
    __syncthreads();
    for (int r = warp; r < T * NH; r += WARPS) {
      const int t = r / NH, hh = r % NH;
      const float v = qS[t * LDQ + hh * DH + lane];
      const float e = expf(v - warp_max(v));
      const float sq = e / warp_sum(e);
      qS[t * LDQ + hh * DH + lane] = sq;
      qpB[t * LDQ + hh * DH + lane] = __float2bfloat16(sq * Q_SCALE);
    }
    __syncthreads();
    constexpr int TILES_PER_HEAD = (T / 16) * (DH / 16);
    for (int tl = warp; tl < NH * TILES_PER_HEAD; tl += WARPS) {
      const int hh = tl / TILES_PER_HEAD, rem = tl % TILES_PER_HEAD;
      const int i = rem / (DH / 16), j = rem % (DH / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
      wmma::fill_fragment(fc, 0.f);
      for (int k = 0; k < DH; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, qpB + i * 16 * LDQ + hh * DH + k, LDQ);
        wmma::load_matrix_sync(fb, ctxB + hh * DH * DH + k * DH + j * 16, DH);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(attnS + i * 16 * LDQ + hh * DH + j * 16, fc, LDQ,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < T * HD; i += THREADS) {
      const int t = i / HD, j = i % HD;
      attnB[t * LDQ + j] = __float2bfloat16(attnS[t * LDQ + j]);
    }
    __syncthreads();
    // o[c][t] = attn @ W_out^T (oS column-major, as la_out_kernel)
    for (int jt = warp; jt < C / 16; jt += WARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T / 16];
      for (int i = 0; i < T / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
      for (int k = 0; k < HD; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, w_out + (size_t)jt * 16 * HD + k, HD);
        for (int i = 0; i < T / 16; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, attnB + i * 16 * LDQ + k, LDQ);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
      for (int i = 0; i < T / 16; ++i)
        wmma::store_matrix_sync(oS + jt * 16 * LDT + i * 16, acc[i], LDT,
                                wmma::mem_col_major);
    }
    __syncthreads();
    OSrc osrc{oS, b_out};
    ln_stats(osrc, C, nvalid, red, stat + 2 * T);

    // ---- postLN backward: dg_post, do = LN_bwd(dy * g_post), db_out
    {
      const float mo = stat[2 * T + lane], ro = stat[3 * T + lane];
      float s1 = 0.f, s2 = 0.f;
      for (int c = warp; c < C; c += WARPS) {
        const float d = ok ? dsrc(c, lane) : 0.f;
        const float oh = (osrc(c, lane) - mo) * ro;
        const float gsum = warp_sum(d * oh);
        if (lane == 0) dgpost[c] += gsum;
        const float dg = d * g_post[c];
        s1 += dg;
        s2 += dg * oh;
      }
      mean_over_warps(s1, s2, C, red, stat + 4 * T, stat + 5 * T);
      const float m1 = stat[4 * T + lane], m2 = stat[5 * T + lane];
      for (int c = warp; c < C; c += WARPS) {
        const float d = ok ? dsrc(c, lane) : 0.f;
        const float oh = (osrc(c, lane) - mo) * ro;
        const float dov = ok ? (d * g_post[c] - m1 - oh * m2) * ro : 0.f;
        oS[c * LDT + lane] = dov;
        const float dsum = warp_sum(dov);
        if (lane == 0) dbout[c] += dsum;
      }
    }
    __syncthreads();
    // dW_out[c][j] += sum_t do[c][t] attn[t][j]
    wgrad_update(dW_out, C, HD, [&](int t, int c) { return oS[c * LDT + t]; },
                 [&](int t, int j) { return attnS[t * LDQ + j]; });
    __syncthreads();
    // dattn[t][j] = sum_c do[c][t] W_out[c][j]  -> attnS.  Warp w takes the
    // column tile j = 16 w .. 16 w + 15; do goes to bf16 DO_CHUNK channels
    // at a time, into qpB (free between the attn product and dq).
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T / 16];
      for (int i = 0; i < T / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
      bf16* doB = qpB;  // [DO_CHUNK][LDT]
      for (int c0 = 0; c0 < C; c0 += DO_CHUNK) {
        const int nc = min(DO_CHUNK, C - c0);
        for (int i = tid; i < nc * T; i += THREADS) {
          const int c = i / T, t = i % T;
          doB[c * LDT + t] = __float2bfloat16(oS[(c0 + c) * LDT + t]);
        }
        __syncthreads();
        for (int k = 0; k < nc; k += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, w_out + (size_t)(c0 + k) * HD + warp * 16, HD);
          for (int i = 0; i < T / 16; ++i) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
            wmma::load_matrix_sync(fa, doB + k * LDT + i * 16, LDT);
            wmma::mma_sync(acc[i], fa, fb, acc[i]);
          }
        }
        __syncthreads();
      }
      for (int i = 0; i < T / 16; ++i)
        wmma::store_matrix_sync(attnS + i * 16 * LDQ + warp * 16, acc[i], LDQ,
                                wmma::mem_row_major);
    }
    __syncthreads();
    // dctx[h][d][e] += sum_t q'[t][h, d] dattn[t][h, e]   (q' = sq * scale, f32)
    for (int t = 0; t < T; ++t) {
      const float qp = qS[t * LDQ + h_ * DH + d_] * Q_SCALE;
      const float* da = attnS + t * LDQ + h_ * DH + e0;
#pragma unroll
      for (int i = 0; i < 16; ++i) dctx[i] = fmaf(qp, da[i], dctx[i]);
    }
    __syncthreads();
    // q-softmax backward: dq' = dattn ctxn^T; dq = sq (dq' s - sum_d sq dq' s)
    for (int r = warp; r < T * NH; r += WARPS) {
      const int t = r / NH, hh = r % NH;
      const float* da = attnS + t * LDQ + hh * DH;
      const float* ct = ctxT + hh * DH * DH + lane;
      float dqp = 0.f;
      for (int e = 0; e < DH; ++e) dqp = fmaf(da[e], ct[e * DH], dqp);
      const float tt = dqp * Q_SCALE;
      const float sq = qS[t * LDQ + hh * DH + lane];
      const float rd = warp_sum(sq * tt);
      const float dq = sq * (tt - rd);
      qS[t * LDQ + hh * DH + lane] = dq;
      qpB[t * LDQ + hh * DH + lane] = __float2bfloat16(dq);
    }
    __syncthreads();
    // dW_q[j][c] += sum_t dq[t][j] ln[c][t]
    wgrad_update(dW_q, HD, C, [&](int t, int j) { return qS[t * LDQ + j]; },
                 [&](int t, int c) { return __bfloat162float(lnS[c * LDT + t]); });
    // dln[c][t] = sum_j dq[t][j] W_q[j][c]  -> oS
    mm_rows_to_cols(qpB, LDQ, w_q, HD, C, oS);
    __syncthreads();
    ln_backward(src, oS, g_pre, C, nvalid, stat, red, stat + 4 * T, dgpre,
                dxq + (size_t)b * C * N + n0, N,
                [&](int c, int t, float v) { return dsrc(c, t) + v; });
    __syncthreads();
  }

  // ---- this CTA's record
  if (acc_smem)
    for (int i = tid; i < 2 * C * HD; i += THREADS) rec[i] = dW_out[i];
  for (int i = tid; i < 3 * C; i += THREADS) rec[2 * C * HD + i] = dbout[i];
  float* rc = rec + 2 * C * HD + 3 * C + h_ * DH * DH + d_ * DH + e0;
#pragma unroll
  for (int i = 0; i < 16; ++i) rc[i] = dctx[i];
}

__host__ __device__ inline size_t kv_common_smem(int C) {
  return align128((size_t)C * LDT * sizeof(bf16)) +        // lnS
         align128((size_t)T * LDK2 * sizeof(float)) +      // kvS: k -> k', v
         align128((size_t)NH * DH * DH * sizeof(float)) +  // dctxT [h][e][d]
         align128((size_t)(2 * WARPS * T + 6 * T + 4 * HD) * sizeof(float));
}

// The A' passes' recompute of one tile: preLN, then [k | v] into kvS.
template <typename TX>
__device__ void kv_recompute(const XSrc<TX>& src, const float* __restrict__ g_pre,
                             const bf16* __restrict__ w_kv, int C, int nvalid, bf16* lnS,
                             float* kvS, float* red, float* stat) {
  pre_ln(src, g_pre, C, nvalid, lnS, red, stat);
  project(lnS, w_kv, C, 2 * HD, kvS, LDK2);
  __syncthreads();
}

// For row (t, h) and lane d: k' and dk' = sum_e (v[t][h, e] / N) dctx[h][d][e].
__device__ __forceinline__ void kprime_dkprime(const float* kvS, const float* dctxT,
                                               const float* ms, int t, int hh, bool valid,
                                               float n_f, float& kp, float& dkp) {
  const int lane = threadIdx.x & 31, c = hh * DH + lane;
  kp = valid ? __fdiv_rn(expf(kvS[t * LDK2 + c] - ms[c]), ms[HD + c]) : 0.f;
  const float* vrow = kvS + t * LDK2 + HD + hh * DH;
  const float* ct = dctxT + hh * DH * DH + lane;
  float acc = 0.f;
  if (valid)
    for (int e = 0; e < DH; ++e) acc = fmaf(__fdiv_rn(vrow[e], n_f), ct[e * DH], acc);
  dkp = acc;
}

// Pass A'1.  grid (P, B).  m, s (B, HD) from pass A, dctx (B, NH, DH, DH)
// from pass B'; part (B * P, HD) f32: this CTA's sum of k' dk' per channel.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
la_bwd_kv1_kernel(const TX* __restrict__ x, const float* __restrict__ g_pre,
                  const bf16* __restrict__ w_kv, const float* __restrict__ m,
                  const float* __restrict__ s, const float* __restrict__ dctx,
                  float* __restrict__ part, int C, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  auto carve = [&](size_t bytes) {
    unsigned char* p = smem + off;
    off += align128(bytes);
    return p;
  };
  bf16* lnS = reinterpret_cast<bf16*>(carve((size_t)C * LDT * sizeof(bf16)));
  float* kvS = reinterpret_cast<float*>(carve((size_t)T * LDK2 * sizeof(float)));
  float* dctxT = reinterpret_cast<float*>(carve((size_t)NH * DH * DH * sizeof(float)));
  float* red = reinterpret_cast<float*>(
      carve((size_t)(2 * WARPS * T + 6 * T + 4 * HD) * sizeof(float)));
  float* stat = red + 2 * WARPS * T;
  float* ms = stat + 6 * T;  // m | s
  float* sd = ms + 2 * HD;   // per-warp partials of sdot

  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (N + T - 1) / T;
  for (int i = tid; i < NH * DH * DH; i += THREADS) {
    const int h = i / (DH * DH), d = (i / DH) % DH, e = i % DH;
    dctxT[h * DH * DH + e * DH + d] = dctx[(size_t)b * NH * DH * DH + i];
  }
  for (int i = tid; i < HD; i += THREADS) {
    ms[i] = m[(size_t)b * HD + i];
    ms[HD + i] = s[(size_t)b * HD + i];
  }
  __syncthreads();
  // warp w handles the rows (t, h) with h = w % NH: one channel per lane
  const int hh = warp % NH;
  float sdot = 0.f;
  for (int tile = p; tile < ntiles; tile += P) {
    const int n0 = tile * T;
    const int nvalid = min(T, N - n0);
    XSrc<TX> src{x + (size_t)b * C * N + n0, N};
    kv_recompute(src, g_pre, w_kv, C, nvalid, lnS, kvS, red, stat);
    for (int t = warp / NH; t < T; t += WARPS / NH) {
      float kp, dkp;
      kprime_dkprime(kvS, dctxT, ms, t, hh, t < nvalid, (float)N, kp, dkp);
      sdot = fmaf(kp, dkp, sdot);
    }
    __syncthreads();
  }
  sd[warp * DH + lane] = sdot;
  __syncthreads();
  if (tid < HD) {
    const int h = tid / DH, d = tid % DH;
    float v = 0.f;
    for (int w = h; w < WARPS; w += NH) v += sd[w * DH + d];
    part[((size_t)b * P + p) * HD + tid] = v;
  }
}

// Per-CTA record of pass A'2: dW_kv (2HD, C) | dg_pre (C).
__host__ __device__ inline size_t kv2_record(int C) { return (size_t)2 * HD * C + C; }

// Pass A'2's first region: lnS | kvS | dkvS, overlaid by dlnS (f32 [C][LDT]).
__host__ __device__ inline size_t kv2_front(int C) {
  const size_t tiles = align128((size_t)C * LDT * sizeof(bf16)) +
                       2 * align128((size_t)T * LDK2 * sizeof(float));
  const size_t dln = align128((size_t)C * LDT * sizeof(float));
  return tiles > dln ? tiles : dln;
}

__host__ __device__ inline size_t kv2_smem(int C, bool acc_smem) {
  return kv2_front(C) +
         align128((size_t)NH * DH * DH * sizeof(float)) +  // dctxT [h][e][d]
         align128((size_t)(2 * WARPS * T + 6 * T + 4 * HD) * sizeof(float)) +
         align128((size_t)T * LDK2 * sizeof(bf16)) +       // dkvB
         align128((size_t)NH * DH * DH * sizeof(float)) +  // dctxF [h][d][e]
         align128((size_t)(HD + C) * sizeof(float)) +      // sdot | dg_pre
         (acc_smem ? (size_t)2 * HD * C * sizeof(float) : 0);
}

// Pass A'2.  grid (P, B).  sdot (B, HD) complete; dxq (B, C, N) from pass
// B'; writes dx = dxq + dx_kv (B, C, N) in TX; part (B * P, kv2_record(C)).
template <typename TX>
__global__ void __launch_bounds__(THREADS, 1)
la_bwd_kv2_kernel(const TX* __restrict__ x, const float* __restrict__ g_pre,
                  const bf16* __restrict__ w_kv, const float* __restrict__ m,
                  const float* __restrict__ s, const float* __restrict__ dctx,
                  const float* __restrict__ sdot, const TX* __restrict__ dxq,
                  TX* __restrict__ dx, float* __restrict__ part, int acc_smem, int C, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  auto carve = [&](size_t bytes) {
    unsigned char* p = smem + off;
    off += align128(bytes);
    return p;
  };
  // dlnS overlays lnS, kvS and dkvS (kv2_front)
  float* dlnS = reinterpret_cast<float*>(smem);
  bf16* lnS = reinterpret_cast<bf16*>(carve((size_t)C * LDT * sizeof(bf16)));
  float* kvS = reinterpret_cast<float*>(carve((size_t)T * LDK2 * sizeof(float)));
  float* dkvS = reinterpret_cast<float*>(carve((size_t)T * LDK2 * sizeof(float)));
  off = kv2_front(C);
  float* dctxT = reinterpret_cast<float*>(carve((size_t)NH * DH * DH * sizeof(float)));
  float* red = reinterpret_cast<float*>(
      carve((size_t)(2 * WARPS * T + 6 * T + 4 * HD) * sizeof(float)));
  bf16* dkvB = reinterpret_cast<bf16*>(carve((size_t)T * LDK2 * sizeof(bf16)));
  float* dctxF = reinterpret_cast<float*>(carve((size_t)NH * DH * DH * sizeof(float)));
  float* sdS = reinterpret_cast<float*>(carve((size_t)(HD + C) * sizeof(float)));
  float* dgpre = sdS + HD;
  float* stat = red + 2 * WARPS * T;
  float* ms = stat + 6 * T;

  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (N + T - 1) / T;
  const float n_f = (float)N;
  float* rec = part + ((size_t)b * P + p) * kv2_record(C);
  float* dW_kv = acc_smem ? reinterpret_cast<float*>(smem + off) : rec;  // (2HD, C)

  for (int i = tid; i < 2 * HD * C; i += THREADS) dW_kv[i] = 0.f;
  for (int i = tid; i < C; i += THREADS) dgpre[i] = 0.f;
  for (int i = tid; i < NH * DH * DH; i += THREADS) {
    const int h = i / (DH * DH), d = (i / DH) % DH, e = i % DH;
    const float v = dctx[(size_t)b * NH * DH * DH + i];
    dctxT[h * DH * DH + e * DH + d] = v;
    dctxF[i] = v;
  }
  for (int i = tid; i < HD; i += THREADS) {
    ms[i] = m[(size_t)b * HD + i];
    ms[HD + i] = s[(size_t)b * HD + i];
    sdS[i] = sdot[(size_t)b * HD + i];
  }
  __syncthreads();

  for (int tile = p; tile < ntiles; tile += P) {
    const int n0 = tile * T;
    const int nvalid = min(T, N - n0);
    XSrc<TX> src{x + (size_t)b * C * N + n0, N};
    XSrc<TX> qsrc{dxq + (size_t)b * C * N + n0, N};
    kv_recompute(src, g_pre, w_kv, C, nvalid, lnS, kvS, red, stat);
    for (int r = warp; r < T * NH; r += WARPS) {
      const int t = r / NH, hh = r % NH, c = hh * DH + lane;
      float kp, dkp;
      kprime_dkprime(kvS, dctxT, ms, t, hh, t < nvalid, n_f, kp, dkp);
      dkvS[t * LDK2 + c] = kp * (dkp - sdS[c]);
      __syncwarp();
      kvS[t * LDK2 + c] = kp;  // the row's k' for dv (this warp's own row)
      __syncwarp();
      const float* kprow = kvS + t * LDK2 + hh * DH;
      const float* cf = dctxF + hh * DH * DH + lane;
      float dv = 0.f;
      for (int d = 0; d < DH; ++d) dv = fmaf(kprow[d], cf[d * DH], dv);
      dkvS[t * LDK2 + HD + c] = __fdiv_rn(dv, n_f);
    }
    __syncthreads();
    for (int i = tid; i < T * 2 * HD; i += THREADS) {
      const int t = i / (2 * HD), j = i % (2 * HD);
      dkvB[t * LDK2 + j] = __float2bfloat16(dkvS[t * LDK2 + j]);
    }
    __syncthreads();
    // dW_kv[j][c] += sum_t dkv[t][j] ln[c][t]
    wgrad_update(dW_kv, 2 * HD, C, [&](int t, int j) { return dkvS[t * LDK2 + j]; },
                 [&](int t, int c) { return __bfloat162float(lnS[c * LDT + t]); });
    __syncthreads();  // lnS, kvS and dkvS are dead: dlnS overlays them
    // dln[c][t] = sum_j dkv[t][j] W_kv[j][c]
    mm_rows_to_cols(dkvB, LDK2, w_kv, 2 * HD, C, dlnS);
    __syncthreads();
    ln_backward(src, dlnS, g_pre, C, nvalid, stat, red, stat + 4 * T, dgpre,
                dx + (size_t)b * C * N + n0, N, [&](int c, int t, float v) {
                  return qsrc(c, t) + round_to(v, TX());
                });
    __syncthreads();
  }

  if (acc_smem)
    for (int i = tid; i < 2 * HD * C; i += THREADS) rec[i] = dW_kv[i];
  for (int i = tid; i < C; i += THREADS) rec[2 * HD * C + i] = dgpre[i];
}

// out[s * M + i] = sum_{p < P} part[(s * P + p) * rec + off + i], in order of p.
// grid (ceil(M / THREADS), S).
__global__ void __launch_bounds__(THREADS)
la_reduce_kernel(const float* __restrict__ part, size_t rec, size_t off, int P, int M,
                 float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= M) return;
  const int sg = blockIdx.y;
  const float* src = part + (size_t)sg * P * rec + off + i;
  float v = 0.f;
  for (int q = 0; q < P; ++q) v += src[(size_t)q * rec];
  out[(size_t)sg * M + i] = v;
}

template <typename TX>
int launch_ctx(const void* x, const float* g_pre, const bf16* w_kv, float* part,
               int* counter, float* ctx, float* m, float* s, int B, int C, int N,
               int P, cudaStream_t stream) {
  const size_t smem = ctx_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      la_ctx_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  la_ctx_kernel<TX><<<dim3(P, B), THREADS, smem, stream>>>(
      static_cast<const TX*>(x), g_pre, w_kv, part, counter, ctx, m, s, C, N);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_out(const void* x, const float* g_pre, const bf16* w_q, const float* ctx,
               const bf16* w_out, const float* b_out, const float* g_post, void* y,
               int B, int C, int N, cudaStream_t stream) {
  const size_t smem = out_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      la_out_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  la_out_kernel<TX><<<dim3((N + T - 1) / T, B), THREADS, smem, stream>>>(
      static_cast<const TX*>(x), g_pre, w_q, ctx, w_out, b_out, g_post,
      static_cast<TX*>(y), C, N);
  return (int)cudaGetLastError();
}


// the largest dynamic shared memory a block may opt in to on this device
int max_smem(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return v;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

int reduce_records(const float* part, size_t rec, size_t off, int P, int M, int S, float* out,
           cudaStream_t st) {
  la_reduce_kernel<<<dim3((M + THREADS - 1) / THREADS, S), THREADS, 0, st>>>(part, rec, off, P,
                                                                           M, out);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_bwd_q(const void* x, const void* dy, const float* g_pre, const bf16* w_q,
                 const float* ctx, const bf16* w_out, const float* b_out,
                 const float* g_post, void* dxq, float* part, float* out_w, float* dctx,
                 int B, int C, int N, int P, int device, cudaStream_t st) {
  const int acc_smem = bwdq_smem(C, true) <= (size_t)max_smem(device);
  const size_t smem = bwdq_smem(C, acc_smem);
  int err = set_smem(la_bwd_q_kernel<TX>, smem);
  if (err) return err;
  la_bwd_q_kernel<TX><<<dim3(P, B), THREADS, smem, st>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(dy), g_pre, w_q, ctx, w_out, b_out,
      g_post, static_cast<TX*>(dxq), part, acc_smem, C, N);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t rec = bwdq_record(C), mw = (size_t)2 * C * HD + 3 * C;
  err = reduce_records(part, rec, 0, B * P, (int)mw, 1, out_w, st);
  if (err) return err;
  return reduce_records(part, rec, mw, P, NH * DH * DH, B, dctx, st);
}

template <typename TX>
int launch_bwd_kv1(const void* x, const float* g_pre, const bf16* w_kv, const float* m,
                   const float* s, const float* dctx, float* part, float* sdot, int B, int C,
                   int N, int P, cudaStream_t st) {
  const size_t smem = kv_common_smem(C);
  int err = set_smem(la_bwd_kv1_kernel<TX>, smem);
  if (err) return err;
  la_bwd_kv1_kernel<TX><<<dim3(P, B), THREADS, smem, st>>>(
      static_cast<const TX*>(x), g_pre, w_kv, m, s, dctx, part, C, N);
  err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_records(part, HD, 0, P, HD, B, sdot, st);
}

template <typename TX>
int launch_bwd_kv2(const void* x, const float* g_pre, const bf16* w_kv, const float* m,
                   const float* s, const float* dctx, const float* sdot, const void* dxq,
                   void* dx, float* part, float* out_w, int B, int C, int N, int P, int device,
                   cudaStream_t st) {
  const int acc_smem = kv2_smem(C, true) <= (size_t)max_smem(device);
  const size_t smem = kv2_smem(C, acc_smem);
  int err = set_smem(la_bwd_kv2_kernel<TX>, smem);
  if (err) return err;
  la_bwd_kv2_kernel<TX><<<dim3(P, B), THREADS, smem, st>>>(
      static_cast<const TX*>(x), g_pre, w_kv, m, s, dctx, sdot, static_cast<const TX*>(dxq),
      static_cast<TX*>(dx), part, acc_smem, C, N);
  err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_records(part, kv2_record(C), 0, B * P, (int)kv2_record(C), 1, out_w, st);
}

template <typename TX>
int launch_mid_ctx(const void* qkv, long long batch_stride, float* part, int* counter,
                   float* ctx, int B, int N, int P, cudaStream_t st) {
  la_mid_ctx_kernel<TX><<<dim3(P, B), THREADS, 0, st>>>(static_cast<const TX*>(qkv),
                                                        batch_stride, part, counter, ctx, N);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_mid_out(const void* qkv, long long batch_stride, const float* ctx, void* out, int B,
                   int N, cudaStream_t st) {
  la_mid_out_kernel<TX><<<dim3((N + T - 1) / T, B), THREADS, 0, st>>>(
      static_cast<const TX*>(qkv), batch_stride, ctx, static_cast<TX*>(out), N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launchers return a cudaError_t (0 = launched).  x_bf16 selects the
// dtype of x (and y): 1 = bfloat16, 0 = float32.  Weights are bf16, row-major
// in the torch layout: w_kv = W_qkv[HD:3HD] (2HD, C), w_q = W_qkv[:HD]
// (HD, C), w_out (C, HD).  Gains and bias are f32 (C,).
int ofd_la_ctx(const void* x, int x_bf16, const float* g_pre, const void* w_kv,
               float* part, int* counter, float* ctx, float* m, float* s, int B,
               int C, int N, int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16* w = static_cast<const bf16*>(w_kv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_ctx<bf16>(x, g_pre, w, part, counter, ctx, m, s, B, C, N, P, st)
                : launch_ctx<float>(x, g_pre, w, part, counter, ctx, m, s, B, C, N, P, st);
}

int ofd_la_out(const void* x, int x_bf16, const float* g_pre, const void* w_q,
               const float* ctx, const void* w_out, const float* b_out,
               const float* g_post, void* y, int B, int C, int N, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16* wq = static_cast<const bf16*>(w_q);
  const bf16* wo = static_cast<const bf16*>(w_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_out<bf16>(x, g_pre, wq, ctx, wo, b_out, g_post, y, B, C, N, st)
                : launch_out<float>(x, g_pre, wq, ctx, wo, b_out, g_post, y, B, C, N, st);
}

// The backward launchers.  Each runs its pass over grid (P, B) and then sums
// the per-CTA records in a fixed order.  Scratch part: (B * P, record) f32
// with record = ofd_la_bwd_record(pass, C) (pass 0: B', 1: A'1, 2: A'2).
// Outputs are f32 unless they are dx: out_w of B' is dW_out (C, HD) | dW_q
// (HD, C) | db_out | dg_pre | dg_post, with dctx (B, NH, DH, DH); A'1 gives
// sdot (B, HD); out_w of A'2 is dW_kv (2HD, C) | dg_pre.  dxq (B' output,
// with the residual dy) and dx = dxq + dx_kv (A'2 output) are in x's dtype.
long long ofd_la_bwd_record(int pass, int C) {
  return pass == 0 ? (long long)bwdq_record(C) : pass == 1 ? HD : (long long)kv2_record(C);
}

int ofd_la_bwd_q(const void* x, const void* dy, int x_bf16, const float* g_pre,
                 const void* w_q, const float* ctx, const void* w_out, const float* b_out,
                 const float* g_post, void* dxq, float* part, float* out_w, float* dctx, int B,
                 int C, int N, int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16* wq = static_cast<const bf16*>(w_q);
  const bf16* wo = static_cast<const bf16*>(w_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_bwd_q<bf16>(x, dy, g_pre, wq, ctx, wo, b_out, g_post, dxq, part,
                                     out_w, dctx, B, C, N, P, device, st)
                : launch_bwd_q<float>(x, dy, g_pre, wq, ctx, wo, b_out, g_post, dxq, part,
                                      out_w, dctx, B, C, N, P, device, st);
}

int ofd_la_bwd_kv1(const void* x, int x_bf16, const float* g_pre, const void* w_kv,
                   const float* m, const float* s, const float* dctx, float* part,
                   float* sdot, int B, int C, int N, int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16* w = static_cast<const bf16*>(w_kv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_bwd_kv1<bf16>(x, g_pre, w, m, s, dctx, part, sdot, B, C, N, P, st)
                : launch_bwd_kv1<float>(x, g_pre, w, m, s, dctx, part, sdot, B, C, N, P, st);
}

int ofd_la_bwd_kv2(const void* x, int x_bf16, const float* g_pre, const void* w_kv,
                   const float* m, const float* s, const float* dctx, const float* sdot,
                   const void* dxq, void* dx, float* part, float* out_w, int B, int C, int N,
                   int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16* w = static_cast<const bf16*>(w_kv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_bwd_kv2<bf16>(x, g_pre, w, m, s, dctx, sdot, dxq, dx, part, out_w,
                                       B, C, N, P, device, st)
                : launch_bwd_kv2<float>(x, g_pre, w, m, s, dctx, sdot, dxq, dx, part, out_w,
                                        B, C, N, P, device, st);
}

// The unfused middle's launchers.  qkv (B, 3 HD, N) with batch stride
// batch_stride (elements), bf16 (qkv_bf16 = 1) or f32.  Pass A: part (B, P,
// PART) f32 scratch and counter (B,) int32 zeros; ctx (B, NH, DH, DH) f32.
// Pass B: out (B, HD, N) in qkv's dtype.
int ofd_la_mid_ctx(const void* qkv, int qkv_bf16, long long batch_stride, float* part,
                   int* counter, float* ctx, int B, int N, int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return qkv_bf16 ? launch_mid_ctx<bf16>(qkv, batch_stride, part, counter, ctx, B, N, P, st)
                  : launch_mid_ctx<float>(qkv, batch_stride, part, counter, ctx, B, N, P, st);
}

int ofd_la_mid_out(const void* qkv, int qkv_bf16, long long batch_stride, const float* ctx,
                   void* out, int B, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return qkv_bf16 ? launch_mid_out<bf16>(qkv, batch_stride, ctx, out, B, N, st)
                  : launch_mid_out<float>(qkv, batch_stride, ctx, out, B, N, st);
}

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
