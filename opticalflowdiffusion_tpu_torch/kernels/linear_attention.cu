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
//                     plus the final max m and denominator s (with
//                     la_ctx_combine_kernel, which folds the CTAs' partials).
//   la_out_kernel  <- _out_kernel (pass B): preLN -> q -> per-head softmax
//                     over d -> q' ctx / N -> W_out + b -> postLN -> + x.
//
// Numerics follow the TPU kernels: matmul operands are bf16 with f32
// accumulation (also when x is f32); LayerNorm statistics, softmaxes and the
// context sums are f32.  The context is kept per head, (4, 32, 32), instead
// of the TPU's block-diagonal (128, 128).
//
// bf16 x (the flagship) runs the Hopper bodies of la_ctx_kernel and
// la_out_kernel (and of backward passes B' and A'2, "backward" below)
// ("Hopper bodies of rows 1-2" below: persistent CTAs, a TMA
// ring of x tiles, weights and ctx in shared memory, wgmma projections, the
// context sums in 3xTF32 on the tensor cores, and la_ctx_combine_kernel
// folding the per-CTA partials in parallel).  f32 x keeps the first bodies,
// la_ctx_f32_kernel and la_out_f32_kernel: one CTA of 256 threads per tile
// of T = 32 positions, the x tile read straight from global memory, the
// normalised tile in shared memory as bf16, WMMA 16x16x16 projections whose
// B operand (the weights) is read from global memory (L1/L2 resident), pass
// A spread over P CTAs a batch element, each writing one partial.
//
// Bound on the H100: both passes move little (x read once, y written once,
// weights tiny).  Pass B does ~2 * 256 * C bf16 tensor FLOPs per position and
// is bound by its bytes.  Pass A's least time is set by its f32 context sums
// (2 * 4096 FLOPs per position: three TF32 products each on the tensor
// cores, 495 TFLOP/s; 67 TFLOP/s on CUDA cores), not by its bf16 projection
// or its bytes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>

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

// This CTA's partial (m, s, context sums) of batch element b -> part (B, P, PART).
__device__ __forceinline__ void ctx_partial(float* __restrict__ part, float m_run, float s_run,
                                            const float (&acc)[16], int b, int p, int P) {
  const int tid = threadIdx.x;
  const int kj = (tid / 64) * DH + (tid % 64) / 2, e0 = (tid % 2) * 16;
  float* pb = part + ((size_t)b * P + p) * PART;
  if (tid < HD) {
    pb[tid] = m_run;
    pb[HD + tid] = s_run;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) pb[2 * HD + kj * DH + e0 + i] = acc[i];
}

// Pass A, f32 x.  grid (P, B).  Writes this CTA's partial to part (B, P,
// PART); la_ctx_combine_kernel folds them.
__global__ void __launch_bounds__(THREADS)
la_ctx_f32_kernel(const float* __restrict__ x, const float* __restrict__ g_pre,
                  const bf16* __restrict__ w_kv, float* __restrict__ part, int C, int N) {
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
    XSrc<float> src{x + (size_t)b * C * N + n0, N};
    pre_ln(src, g_pre, C, nvalid, lnS, red, stat);
    project(lnS, w_kv, C, 2 * HD, kvS, LDK);
    __syncthreads();
    ctx_tile(kvS, nvalid, chS, m_run, s_run, acc);
  }
  ctx_partial(part, m_run, s_run, acc, b, p, P);
}

size_t out_smem(int C) {
  return align128((size_t)C * LDT * sizeof(bf16)) +   // lnS
         align128((size_t)T * LDQ * sizeof(float)) +  // qS (q, then attn f32)
         align128((size_t)T * LDQ * sizeof(bf16)) +   // qpS (q', then attn bf16)
         align128((size_t)NH * DH * DH * sizeof(bf16)) +  // ctxS
         align128((size_t)C * LDT * sizeof(float)) +  // oS
         (size_t)(WARPS * T + 2 * T) * sizeof(float);
}

// Pass B, f32 x.  grid (ceil(N / T), B).  ctx (B, NH, DH, DH) from pass A.
__global__ void __launch_bounds__(THREADS)
la_out_f32_kernel(const float* __restrict__ x, const float* __restrict__ g_pre,
                  const bf16* __restrict__ w_q, const float* __restrict__ ctx,
                  const bf16* __restrict__ w_out, const float* __restrict__ b_out,
                  const float* __restrict__ g_post, float* __restrict__ y, int C, int N) {
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

  XSrc<float> src{x + (size_t)b * C * N + n0, N};
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
    float* yb = y + (size_t)b * C * N + n0 + t;
    for (int c = warp; c < C; c += WARPS) {
      const float o = (osrc(c, t) - mean) * rstd * g_post[c];
      put(yb + (size_t)c * N, src(c, t) + o);
    }
  }
}

// ------------------------------------------------- Hopper bodies of rows 1-2
//
// The bf16-x forward passes, redesigned for Hopper (sm_90a).  The f32-x
// instantiations keep the first bodies above (la_ctx_f32_kernel,
// la_out_f32_kernel); both dtypes share the combine of pass A.
//
// - Persistent CTAs, grid (P, B): CTA p walks the tiles p, p + P, ... of
//   batch element b (P from the wrapper's la_plan: one CTA per SM, split
//   over the batch), so the weights and the context are loaded into shared
//   memory once per CTA, not once per tile.
// - A tile is TN = 64 positions.  One producer thread issues TMA loads
//   (cp.async.bulk.tensor, a 3-d map over x as (ld, C, B), [64][<= 256]
//   boxes, 128-byte swizzle) into a ring of S stages under mbarriers; ld is
//   a multiple of 8 (the wrapper pads a ragged N once).  The x tile is read
//   from shared memory only: LN statistics (two passes, f32), the
//   normalised tile, and in pass B the residual.
// - Projections on wgmma: the normalised tile, bf16, [C][64] with the same
//   swizzle as x (pass A writes it over x in place), is the MN-major A of
//   the products; the weights are K-major B operands ([rows][64 columns],
//   128-byte swizzle), put there by one or two 2-d TMA boxes per chunk
//   straight from the torch layout (zero past C).  Chunks of 64 input
//   channels (w_kv: 32 KB, w_q: 16 KB) or 64 output channels (w_out, 16
//   KB) are resident (loaded once) where they fit beside the x ring, else
//   streamed per tile through a ring of chunk slots in the order the
//   consumers use them (la_plan says which).
// - LN statistics: a warp takes 8 positions (a 16-byte chunk of every
//   channel row, one vector load each) and sums over the channels with a
//   transposing shuffle butterfly, two passes (mean, then squared
//   deviations).
// - Pass A: warp group w projects k and v of heads 2 w, 2 w + 1.  The
//   per-channel online max and sum run on k's accumulators (a thread's two
//   rows, a transposing shuffle butterfly over the 8 row groups of a warp, a
//   4-way combine across warps in shared memory), exp(k - m) (ex2.approx)
//   and v go to shared memory as f32, and each warp group sums its heads'
//   context ctx[h][d][e] += exp(k - m)[t][hd] v[t][he] over the tile on the
//   tensor cores in 3xTF32 (each f32 operand split into two TF32 parts, the
//   three largest of the four products summed in f32: f32's accuracy,
//   mma.sync m16n8k8, conflict-free loads from the tiles' 136-float rows),
//   with the same rescaling and two-level sum as the first body.  Each CTA
//   writes one partial (m, s, sums); la_ctx_combine_kernel then folds the P
//   partials of a batch element in the order p = 0 .. P-1, one thread per
//   context entry: no CTA folds all partials alone, and no float atomics
//   (the same bits on every run).
// - Pass B: q = LN(x) W_q^T (m64n128k16), the head softmax on the
//   accumulators (a quad of lanes holds a row's 32 channels of a head),
//   q' packed to bf16 in registers as the A operand of attn = q' (ctx / N)
//   (m64n32k16 per head, ctx / N bf16 in shared memory), attn packed again
//   as the A of o = attn W_out^T (m64n64k16 per 64 output channels).  The
//   post-LN statistics are taken on the accumulators (a quad shuffle per
//   row), y = x + postLN(o + b) is written over the x stage and stored by
//   TMA.  The o accumulators of up to 4 chunks of 64 channels stay in
//   registers; above 256 channels the chunks are recomputed for the mean,
//   the variance and the output (the products are cheap, registers are
//   not).  At C <= 128 two consumer warp groups take alternate tiles.
// - Every mbarrier wait traps after ~10 s instead of hanging the card.
constexpr int TN = 64;                  // positions per tile
constexpr int XROW = TN * 2;            // bytes of one channel row of a bf16 x tile
constexpr int CHUNK = 16384;            // bytes of a w_q or w_out chunk (w_kv: 2 CHUNK)
constexpr int EP = HD + 8;              // f32 row pitch of pass A's exp(k - m) and v tiles
constexpr int A_THREADS = 288;          // 2 consumer warp groups + 1 producer warp
constexpr int SMEM_LIMIT = 232448;      // 227 KB: the most a CTA may have
constexpr unsigned FULL_MASK = 0xffffffffu;

// Shared memory of the bf16 passes (la_plan in ops/attention_fused.py
// computes the same): 1 KB of alignment slack, the x ring, the weight
// chunk slots, then per pass:
__host__ __device__ inline size_t ctx_bf16_smem(int C, int S, int slots) {
  return 1024 + (size_t)S * C * XROW + (size_t)slots * 2 * CHUNK +
         2 * (size_t)TN * EP * 4 +                      // exp(k - m), v
         (size_t)(2 * 4 * HD + 2 * HD + C) * 4 +        // max and sum partials, m, alpha, g
         (size_t)(2 * S + 2 * slots) * 8;               // mbarriers
}
__host__ __device__ inline size_t out_bf16_smem(int C, int S, int slots, int nw) {
  return 1024 + (size_t)(S + nw) * C * XROW + (size_t)slots * CHUNK +
         (size_t)NH * DH * DH * 2 +                     // ctx / N, bf16 planes
         (size_t)3 * C * 4 +                            // g_pre, b_out, g_post
         (size_t)(2 * S + 2 * slots) * 8;
}

struct CtxPlan {
  int C, N, S, slots, resident;
};
struct OutPlan {
  int C, N, S, slots, resident, nw;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits for the completion of the barrier's phase of the given parity; a
// wait longer than ~10 s traps, so that a pipeline fault fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  if (done) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (!done && t - t0 > 10000000000ull) __trap();
  } while (!done);
}
// by every lane of a warp, which leaves the warp converged for the
// .sync.aligned instructions after it
__device__ __forceinline__ void mbar_wait_warp(uint32_t bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// wgmma shared-memory descriptors: K-major planes without swizzle (LBO the
// plane stride, SBO 128 bytes), and the 128-byte swizzle of the x tile
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return desc_plain(addr, lbo, sbo) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of r across a wgmma wait
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128) += A (64 x 16, MN-major, 128-byte swizzle) B (16 x 128, K-major planes)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64) += A (64 x 16, MN-major, 128-byte swizzle) B (16 x 64, K-major planes)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// D (64 x 64) += A (64 x 16, registers) B (16 x 64, K-major planes)
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 32) += A (64 x 16, registers) B (16 x 32, K-major planes)
__device__ __forceinline__ void wgmma_n32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                       uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// The dynamic shared memory from its first 1024-byte boundary (the 128-byte
// swizzle's alignment), by pointer arithmetic on the array itself so that
// the compiler keeps shared-memory loads and stores (a cast through an
// integer would leave generic ones).
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// bf16 at byte offset a of the dynamic shared memory (plain loads and
// stores, which the compiler may batch and reorder)
__device__ __forceinline__ float lds_bf16(const unsigned char* sm, uint32_t a) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(sm + a));
}
__device__ __forceinline__ void sts_bf16(unsigned char* sm, uint32_t a, float v) {
  *reinterpret_cast<bf16*>(sm + a) = __float2bfloat16(v);
}

// The sum over the 32 lanes of a warp of each lane's v[0 .. 7]: a
// transposing butterfly (4 + 2 + 1 shuffles that halve the values, then 2
// that add), after which the 4 lanes of quad k hold the sum of v[k].  The
// same order on every run.
__device__ __forceinline__ float warp_sum8(const float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  float a[4], b[2];
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    a[k] = (h4 ? v[k + 4] : v[k]) + __shfl_xor_sync(FULL_MASK, h4 ? v[k] : v[k + 4], 16);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    b[k] = (h3 ? a[k + 2] : a[k]) + __shfl_xor_sync(FULL_MASK, h3 ? a[k] : a[k + 2], 8);
  float r = (h2 ? b[1] : b[0]) + __shfl_xor_sync(FULL_MASK, h2 ? b[0] : b[1], 4);
  r += __shfl_xor_sync(FULL_MASK, r, 2);
  return r + __shfl_xor_sync(FULL_MASK, r, 1);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Pre-LN of the positions 8 j .. 8 j + 7 of a [C][64] bf16 tile (its
// 16-byte chunk j of every channel row) for the NC chunks j = j0, j0 + 4,
// .., by one warp (interleaved, for the loads' sake): lane l takes the
// channels l, l + 32, ...  Mean, then the mean of squared deviations (as
// jnp.var), over C in f32; writes bf16((x - mean) rstd g) over the same
// chunks of the tile at la (which may be xs).  Byte offsets into sm.
template <int NC>
__device__ __forceinline__ void chunk_ln(unsigned char* sm, uint32_t xs, uint32_t la, int C, int j0,
                                         const float* g) {
  const int lane = threadIdx.x & 31;
  float v[8], acc[NC][8], mean[NC][8], rstd[NC][8];
  auto at = [&](int c, int n) { return c * XROW + (((j0 + 4 * n) ^ (c & 7)) << 4); };
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[n][k] = 0.f;
  for (int c = lane; c < C; c += 32)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      unpack8(*reinterpret_cast<const uint4*>(sm + xs + at(c, n)), v);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[n][k] += v[k];
    }
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const float m = warp_sum8(acc[n]) / C;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      mean[n][k] = __shfl_sync(FULL_MASK, m, 4 * k);
      acc[n][k] = 0.f;
    }
  }
  for (int c = lane; c < C; c += 32)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      unpack8(*reinterpret_cast<const uint4*>(sm + xs + at(c, n)), v);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[n][k] += (v[k] - mean[n][k]) * (v[k] - mean[n][k]);
    }
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const float r = rsqrtf(warp_sum8(acc[n]) / C + EPS);
#pragma unroll
    for (int k = 0; k < 8; ++k) rstd[n][k] = __shfl_sync(FULL_MASK, r, 4 * k);
  }
  for (int c = lane; c < C; c += 32) {
    const float gc = g[c];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const uint32_t o = at(c, n);
      unpack8(*reinterpret_cast<const uint4*>(sm + xs + o), v);
      float y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) y[k] = (v[k] - mean[n][k]) * rstd[n][k] * gc;
      *reinterpret_cast<uint4*>(sm + la + o) = make_uint4(
          pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
    }
  }
  fence_async_smem();
}

// The max (or sum) over a warp's 8 row groups (lane bits 2-4) of each of
// this lane's 16 accumulator columns, v[2 j + e] for column 8 j + 2 cq + e:
// a transposing butterfly of 8 + 4 + 2 shuffles, after which lane (g, cq)
// holds r[k] for column 8 g + 2 cq + k, k < 2.
template <bool MAX>
__device__ __forceinline__ void warp_cols16(const float (&v)[16], float (&r)[2]) {
  const int lane = threadIdx.x & 31;
  auto op = [](float a, float b) { return MAX ? fmaxf(a, b) : a + b; };
  float a[8], b[4];
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    a[k] = op(h4 ? v[k + 8] : v[k], __shfl_xor_sync(FULL_MASK, h4 ? v[k] : v[k + 8], 16));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = op(h3 ? a[k + 4] : a[k], __shfl_xor_sync(FULL_MASK, h3 ? a[k] : a[k + 4], 8));
#pragma unroll
  for (int k = 0; k < 2; ++k)
    r[k] = op(h2 ? b[k + 2] : b[k], __shfl_xor_sync(FULL_MASK, h2 ? b[k] : b[k + 2], 4));
}

// x = hi + lo in TF32 (hi: x rounded to TF32's 10 mantissa bits, lo: the
// rest rounded again): a product of two such splits, hi hi + hi lo + lo hi,
// keeps f32's accuracy on the tensor cores (3xTF32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// D (16 x 8) += A (16 x 8, row) B (8 x 8, col), TF32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float L2E = 1.4426950408889634f;  // log2(e): exp(x) = ex2(x log2 e)

// Pass A, bf16 x.  grid (P, B), A_THREADS threads, ctx_bf16_smem bytes;
// tx maps x as (ld, C, B) with [64][C / nbox] boxes, tw maps w_kv (256, C)
// with [256][8] boxes.  Writes this CTA's partial to part (B, P, PART).
__global__ void __launch_bounds__(A_THREADS, 1)
la_ctx_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
              const float* __restrict__ g_pre, float* __restrict__ part, CtxPlan pl) {
  extern __shared__ unsigned char la_smem_raw[];
  unsigned char* sm = align1024(la_smem_raw);
  const int C = pl.C, N = pl.N, S = pl.S, slots = pl.slots;
  const bool resident = pl.resident != 0;
  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int ntiles = (N + TN - 1) / TN;
  const int my = (ntiles - 1 - p) / P + 1;  // tiles p, p + P, ... (p < ntiles)
  const int nch = (C + 63) / 64;            // weight chunks of 64 channels (32 KB)
  const int nbox = C > 256 ? 2 : 1, cb = C / nbox;
  const uint32_t xsz = (uint32_t)C * XROW;

  const uint32_t base = smem_u32(sm);
  const uint32_t x_off = base, w_off = x_off + S * xsz;
  float* E = reinterpret_cast<float*>(sm + S * xsz + (size_t)slots * 2 * CHUNK);
  float* V = E + TN * EP;
  float* redm = V + TN * EP;      // 4 x HD
  float* reds = redm + 4 * HD;    // 4 x HD
  float* mS = reds + 4 * HD;      // HD
  float* alphaS = mS + HD;        // HD
  float* gS = alphaS + HD;        // C
  const uint32_t xfull = smem_u32(gS + C), xempty = xfull + 8 * S;
  const uint32_t wfull = xempty + 8 * S, wempty = wfull + 8 * slots;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(xfull + 8 * s, 1);
      mbar_init(xempty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < slots; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) gS[c] = g_pre[c];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 8) {
    // ---- producer: x tiles, and the weight chunks (once, or per tile)
    if (lane == 0) {
      auto load_chunk = [&](int ch, int slot) {  // one [256][64] box
        mbar_expect_tx(wfull + 8 * slot, 2 * CHUNK);
        tma_load_2d(w_off + slot * 2 * CHUNK, &tw, wfull + 8 * slot, 64 * ch, 0);
      };
      if (resident)
        for (int ch = 0; ch < nch; ++ch) load_chunk(ch, ch);
      int wit = 0;
      for (int i = 0; i < my; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(xempty + 8 * s, (i / S - 1) & 1);
        mbar_expect_tx(xfull + 8 * s, xsz);
        for (int bx = 0; bx < nbox; ++bx)
          tma_load_3d(x_off + s * xsz + bx * cb * XROW, &tx, xfull + 8 * s, (p + i * P) * TN,
                      bx * cb, b);
        if (!resident)
          for (int ch = 0; ch < nch; ++ch, ++wit) {
            const int slot = wit % slots;
            if (wit >= slots) mbar_wait(wempty + 8 * slot, (wit / slots - 1) & 1);
            load_chunk(ch, slot);
          }
      }
    }
    return;
  }

  // ---- consumers: warp group 0 projects k, warp group 1 v
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127, wwarp = wtid >> 5;
  const int g8 = lane >> 2, cq = lane & 3;
  const int r0 = wwarp * 16 + g8, r1 = r0 + 8;  // this thread's accumulator rows
  // context sums of this warp: head hd, d = 16 mh + g8 (+ 8), e = 8 nt + 2 cq (+ 1)
  const int hd = 2 * wg + (wwarp >> 1), mh = wwarp & 1;
  float cacc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) cacc[nt][k] = 0.f;
  float m_run = -INFINITY, s_run = 0.f;  // channel 64 wg + wtid (wtid < 64)
  const int ksteps = C / 16;

  for (int i = 0; i < my; ++i) {
    const int n0 = (p + i * P) * TN, nvalid = min(TN, N - n0);
    const int s = i % S;
    const uint32_t xs = x_off + s * xsz;
    mbar_wait_warp(xfull + 8 * s, (i / S) & 1);
    chunk_ln<1>(sm, xs - base, xs - base, C, warp, gS);  // LN(x) over x; warp w: positions 8 w ..
    bar_sync(1, 256);

    // [k | v] of heads 2 wg, 2 wg + 1 = LN(x) W_kv^T: warp group wg takes the
    // rows 64 wg .. (k) and 128 + 64 wg .. (v) of each plane
    float ka[32], va[32];  // the first product overwrites them (scale_d = 0)
    for (int ch = 0; ch < nch; ++ch) {
      const int it = i * nch + ch;
      const int slot = resident ? ch : it % slots;
      mbar_wait_warp(wfull + 8 * slot, resident ? 0 : (it / slots) & 1);
      const uint32_t wa = w_off + slot * 2 * CHUNK + wg * 64 * XROW;  // row 64 wg of [256][64]
      wgmma_fence();
#pragma unroll
      for (int sub = 0; sub < 4; ++sub) {
        const int kk = 4 * ch + sub;
        if (kk < ksteps) {
          const uint64_t da = desc_sw128(xs + kk * 2048, 4096, 1024);
          wgmma_n64(ka, da, desc_sw128(wa + sub * 32, 16, 1024), kk > 0);
          wgmma_n64(va, da, desc_sw128(wa + HD * XROW + sub * 32, 16, 1024), kk > 0);
        }
      }
      wgmma_commit();
      if (!resident) {  // the slot goes back to the producer once read
        wgmma_wait0();
        if (lane == 0) mbar_arrive(wempty + 8 * slot);
      }
    }
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      reg_fence(ka[j]);
      reg_fence(va[j]);
    }
    if (lane == 0) mbar_arrive(xempty + 8 * s);  // x tile (now LN(x)) read

    // per-channel max of this tile's k over the valid rows; this warp group's
    // 64 channels: accumulator column 8 j + 2 cq + e is channel 64 wg + it
    const bool v0 = r0 < nvalid, v1 = r1 < nvalid;
    const int bar = 2 + wg, ch0 = 64 * wg;
    float v[16], r[2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[2 * j + e] = fmaxf(v0 ? ka[4 * j + e] : -INFINITY, v1 ? ka[4 * j + 2 + e] : -INFINITY);
    warp_cols16<true>(v, r);
#pragma unroll
    for (int k = 0; k < 2; ++k) redm[wwarp * HD + ch0 + 8 * g8 + 2 * cq + k] = r[k];
    bar_sync(bar, 128);
    if (wtid < 64) {
      const int c = ch0 + wtid;
      const float mt = fmaxf(fmaxf(redm[c], redm[HD + c]), fmaxf(redm[2 * HD + c], redm[3 * HD + c]));
      const float m_new = fmaxf(m_run, mt);
      alphaS[c] = expf(m_run - m_new);
      mS[c] = m_new;
    }
    bar_sync(bar, 128);
    // exp(k - m) -> E and v -> V (f32, rows r0 and r1), and the sum of exp(k - m)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = ch0 + 8 * j + 2 * cq;
      const float ma = mS[col] * L2E, mb = mS[col + 1] * L2E;
      const float2 ea = make_float2(v0 ? ex2(fmaf(ka[4 * j], L2E, -ma)) : 0.f,
                                    v0 ? ex2(fmaf(ka[4 * j + 1], L2E, -mb)) : 0.f);
      const float2 eb = make_float2(v1 ? ex2(fmaf(ka[4 * j + 2], L2E, -ma)) : 0.f,
                                    v1 ? ex2(fmaf(ka[4 * j + 3], L2E, -mb)) : 0.f);
      *reinterpret_cast<float2*>(E + r0 * EP + col) = ea;
      *reinterpret_cast<float2*>(E + r1 * EP + col) = eb;
      *reinterpret_cast<float2*>(V + r0 * EP + col) = make_float2(va[4 * j], va[4 * j + 1]);
      *reinterpret_cast<float2*>(V + r1 * EP + col) = make_float2(va[4 * j + 2], va[4 * j + 3]);
      v[2 * j] = ea.x + eb.x;
      v[2 * j + 1] = ea.y + eb.y;
    }
    warp_cols16<false>(v, r);
#pragma unroll
    for (int k = 0; k < 2; ++k) reds[wwarp * HD + ch0 + 8 * g8 + 2 * cq + k] = r[k];
    bar_sync(bar, 128);
    if (wtid < 64) {
      const int c = ch0 + wtid;
      const float ssum = reds[c] + reds[HD + c] + reds[2 * HD + c] + reds[3 * HD + c];
      s_run = s_run * alphaS[c] + ssum;
      m_run = mS[c];
    }

    // ctx[h][d][e] sums over the tile on the tensor cores, 3xTF32: warp (hd,
    // mh) takes E^T (16 d x 64 t) V (64 t x 32 e) of its head as m16n8k8
    // products (4 tiles of 8 e, 8 steps of 8 positions)
    float ts[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) ts[nt][k] = 0.f;
    const float* eh = E + hd * DH + 16 * mh + g8;
    const float* vh = V + hd * DH + g8;
#pragma unroll
    for (int kb = 0; kb < TN; kb += 8) {
      const float* e0 = eh + (kb + cq) * EP;
      const float* e4 = e0 + 4 * EP;
      uint32_t ahi[4], alo[4];
      split_tf32(e0[0], ahi[0], alo[0]);
      split_tf32(e0[8], ahi[1], alo[1]);
      split_tf32(e4[0], ahi[2], alo[2]);
      split_tf32(e4[8], ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bhi[2], blo[2];
        split_tf32(vh[(kb + cq) * EP + 8 * nt], bhi[0], blo[0]);
        split_tf32(vh[(kb + cq + 4) * EP + 8 * nt], bhi[1], blo[1]);
        mma_tf32(ts[nt], alo, bhi);  // the small products first
        mma_tf32(ts[nt], ahi, blo);
        mma_tf32(ts[nt], ahi, bhi);
      }
    }
    const float al0 = alphaS[hd * DH + 16 * mh + g8], al1 = alphaS[hd * DH + 16 * mh + g8 + 8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      cacc[nt][0] = cacc[nt][0] * al0 + ts[nt][0];
      cacc[nt][1] = cacc[nt][1] * al0 + ts[nt][1];
      cacc[nt][2] = cacc[nt][2] * al1 + ts[nt][2];
      cacc[nt][3] = cacc[nt][3] * al1 + ts[nt][3];
    }
  }

  float* pb = part + ((size_t)b * P + p) * PART;
  if (wtid < 64) {
    pb[64 * wg + wtid] = m_run;
    pb[HD + 64 * wg + wtid] = s_run;
  }
  float* pc = pb + 2 * HD + (hd * DH + 16 * mh + g8) * DH + 2 * cq;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(pc + 8 * nt) = make_float2(cacc[nt][0], cacc[nt][1]);
    *reinterpret_cast<float2*>(pc + 8 * DH + 8 * nt) = make_float2(cacc[nt][2], cacc[nt][3]);
  }
}

// The combine of a context pass (the block's pass A in either dtype, and the
// unfused middle's): part (B, P, PART) -> ctx (B, NH, DH, DH) = sums / s and,
// where given, m and s (B, HD).  grid (NH * DH * DH / THREADS, B); thread
// (kj, e) folds the P partials of its entry in the order p = 0 .. P-1.
__global__ void __launch_bounds__(THREADS)
la_ctx_combine_kernel(const float* __restrict__ part, int P, float* __restrict__ ctx_out,
                      float* __restrict__ m_out, float* __restrict__ s_out) {
  const int b = blockIdx.y, idx = blockIdx.x * THREADS + threadIdx.x;
  const int kj = idx / DH, e = idx % DH;
  const float* base = part + (size_t)b * P * PART;
  float m = -INFINITY;
  for (int q = 0; q < P; ++q) m = fmaxf(m, __ldg(base + (size_t)q * PART + kj));
  float s = 0.f;
  for (int q = 0; q < P; ++q)
    s += __ldg(base + (size_t)q * PART + HD + kj) * expf(__ldg(base + (size_t)q * PART + kj) - m);
  float out = 0.f;
  for (int q = 0; q < P; ++q) {
    const float w = expf(__ldg(base + (size_t)q * PART + kj) - m);
    out += w * __ldg(base + (size_t)q * PART + 2 * HD + kj * DH + e);
  }
  ctx_out[(size_t)b * NH * DH * DH + idx] = out / s;
  if (e == 0 && m_out != nullptr) {
    m_out[b * HD + kj] = m;
    s_out[b * HD + kj] = s;
  }
}

// Pass B, bf16 x.  grid (P, B), 128 nw + 32 threads (nw consumer warp
// groups, then the producer warp), out_bf16_smem bytes; tx and ty map x and
// y as (ld, C, B) with [64][C / nbox] boxes, twq maps w_q (128, C) with
// [128][64] boxes, two maps w_out (C, 128) with [64][64] boxes.  NW
// consumer warp groups (2 at C <= 128, else 1); OG chunks of 64 output
// channels whose o accumulators a thread holds at once: 1 at C <= 64, 2 at
// C <= 128 (two warp groups and the producer warp leave a thread 168
// registers, and 128 accumulators beside attn's 32 spill), else 4 (one warp
// group: 255 registers); RECOMPUTE (C > 64 OG): the chunks computed again for
// the variance and for y.
template <int OG, bool RECOMPUTE, int NW>
__global__ void __launch_bounds__(128 * NW + 32, 1)
la_out_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ty,
              const __grid_constant__ CUtensorMap twq, const __grid_constant__ CUtensorMap two,
              const float* __restrict__ g_pre, const float* __restrict__ ctx,
              const float* __restrict__ b_out, const float* __restrict__ g_post, OutPlan pl) {
  extern __shared__ unsigned char la_smem_raw[];
  unsigned char* sm = align1024(la_smem_raw);
  const int C = pl.C, N = pl.N, S = pl.S, slots = pl.slots, nw = NW;
  const bool resident = pl.resident != 0;
  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int ntiles = (N + TN - 1) / TN;
  const int my = (ntiles - 1 - p) / P + 1;
  const int nq = (C + 63) / 64, no = nq;  // chunks of w_q (64 input) and w_out (64 output channels)
  const int ng = (no + OG - 1) / OG;      // groups of OG o chunks (RECOMPUTE: ng > 1, o
                                          // recomputed for the mean, the variance and y)
  const int L = nq + (RECOMPUTE ? 3 : 1) * no;  // chunks a tile uses, in order
  const int nbox = C > 256 ? 2 : 1, cb = C / nbox;
  const uint32_t xsz = (uint32_t)C * XROW;

  const uint32_t base = smem_u32(sm);
  const uint32_t x_off = base, la_off = x_off + S * xsz, w_off = la_off + nw * xsz;
  const uint32_t ctx_off = w_off + slots * CHUNK;
  float* gS = reinterpret_cast<float*>(sm + (ctx_off - base) + NH * DH * DH * 2);
  float* bS = gS + C;
  float* gpS = bS + C;
  const uint32_t xfull = smem_u32(gpS + C), xempty = xfull + 8 * S;
  const uint32_t wfull = xempty + 8 * S, wempty = wfull + 8 * slots;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(xfull + 8 * s, 1);
      mbar_init(xempty + 8 * s, 1);  // after the tile's y store has read the stage
    }
    for (int s = 0; s < slots; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 4);  // lane 0 of each consumer warp (streaming: nw = 1)
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    gS[c] = g_pre[c];
    bS[c] = b_out[c];
    gpS[c] = g_post[c];
  }
  // ctx / N as bf16 K-major planes: head h, plane d / 8, row e, d % 8
  for (int i = threadIdx.x; i < NH * DH * DH; i += blockDim.x) {
    const int h = i / (DH * DH), d = (i / DH) % DH, e = i % DH;
    sts_bf16(sm, ctx_off - base + h * 2048 + (d >> 3) * 512 + e * 16 + (d & 7) * 2,
             __fdiv_rn(ctx[(size_t)b * NH * DH * DH + i], (float)N));
  }
  fence_async_smem();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4 * nw) {
    // ---- producer: x tiles, and the weight chunks (once, or per tile)
    if (lane == 0) {
      auto load_q = [&](int k, int slot) {  // one [128][64] box
        mbar_expect_tx(wfull + 8 * slot, CHUNK);
        tma_load_2d(w_off + slot * CHUNK, &twq, wfull + 8 * slot, 64 * k, 0);
      };
      auto load_o = [&](int j, int slot) {  // two [64][64] boxes: hidden 0-63, 64-127
        mbar_expect_tx(wfull + 8 * slot, CHUNK);
        for (int h = 0; h < 2; ++h)
          tma_load_2d(w_off + slot * CHUNK + h * CHUNK / 2, &two, wfull + 8 * slot, 64 * h, 64 * j);
      };
      if (resident) {
        for (int k = 0; k < nq; ++k) load_q(k, k);
        for (int j = 0; j < no; ++j) load_o(j, nq + j);
      }
      int wit = 0;
      for (int i = 0; i < my; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(xempty + 8 * s, (i / S - 1) & 1);
        mbar_expect_tx(xfull + 8 * s, xsz);
        for (int bx = 0; bx < nbox; ++bx)
          tma_load_3d(x_off + s * xsz + bx * cb * XROW, &tx, xfull + 8 * s, (p + i * P) * TN,
                      bx * cb, b);
        if (!resident)
          for (int u = 0; u < L; ++u, ++wit) {
            const int slot = wit % slots;
            if (wit >= slots) mbar_wait(wempty + 8 * slot, (wit / slots - 1) & 1);
            if (u < nq)
              load_q(u, slot);
            else
              load_o((u - nq) % no, slot);
          }
      }
    }
    return;
  }

  // ---- consumers: warp group cw takes the CTA's tiles cw, cw + nw, ...
  const int tid = threadIdx.x, cw = tid >> 7, wtid = tid & 127, wwarp = wtid >> 5;
  const int g8 = lane >> 2, cq = lane & 3;
  const int r0 = wwarp * 16 + g8, r1 = r0 + 8;
  const uint32_t la = la_off + cw * xsz;
  const int ksteps = C / 16;
  // x[c][r] of this thread's rows r0, r1 and columns c = 8 i + 2 cq + e lies
  // at byte yo[h][e] + 8 i 128 of the x tile (the swizzle of c % 8 = 2 cq + e)
  uint32_t yo[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      yo[h][e] = (2 * cq + e) * XROW + ((((2 * wwarp + h) ^ (2 * cq + e)) << 4) | (g8 << 1));

  for (int i = cw; i < my; i += nw) {
    const int n0 = (p + i * P) * TN;
    const int s = i % S;
    const uint32_t xs = x_off + s * xsz;
    mbar_wait_warp(xfull + 8 * s, (i / S) & 1);
    chunk_ln<2>(sm, xs - base, la - base, C, wwarp, gS);  // warp w: positions 8 w .., 8 w + 32 ..
    bar_sync(1 + cw, 128);

    int u = 0;  // this tile's next chunk (streaming: nw = 1, so i counts the tiles)
    auto acquire = [&](int rslot) -> int {
      const int it = i * L + u++;
      const int slot = resident ? rslot : it % slots;
      mbar_wait_warp(wfull + 8 * slot, resident ? 0 : (it / slots) & 1);
      return slot;
    };
    auto release = [&](int slot) {
      if (!resident && lane == 0) mbar_arrive(wempty + 8 * slot);
    };

    // q = LN(x) W_q^T
    float qa[64];  // the first product overwrites it (scale_d = 0)
    for (int k = 0; k < nq; ++k) {
      const int slot = acquire(k);
      const uint32_t wa = w_off + slot * CHUNK;
      wgmma_fence();
#pragma unroll
      for (int sub = 0; sub < 4; ++sub) {
        const int kk = 4 * k + sub;
        if (kk < ksteps)
          wgmma_n128(qa, desc_sw128(la + kk * 2048, 4096, 1024), desc_sw128(wa + sub * 32, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      if (!resident) {
        wgmma_wait0();
        release(slot);
      }
    }
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < 64; ++j) reg_fence(qa[j]);

    // softmax over each head's 32 channels (a quad of lanes holds a row's),
    // q' = softmax * dim_head^-0.5 packed as the A fragments of attn
    uint32_t pa[8][4];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j) {
        m0 = fmaxf(m0, fmaxf(qa[4 * j], qa[4 * j + 1]));
        m1 = fmaxf(m1, fmaxf(qa[4 * j + 2], qa[4 * j + 3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(FULL_MASK, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(FULL_MASK, m1, o));
      }
      float s0 = 0.f, s1 = 0.f;
      m0 *= L2E;
      m1 *= L2E;
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j) {
        qa[4 * j] = ex2(fmaf(qa[4 * j], L2E, -m0));
        qa[4 * j + 1] = ex2(fmaf(qa[4 * j + 1], L2E, -m0));
        qa[4 * j + 2] = ex2(fmaf(qa[4 * j + 2], L2E, -m1));
        qa[4 * j + 3] = ex2(fmaf(qa[4 * j + 3], L2E, -m1));
        s0 += qa[4 * j] + qa[4 * j + 1];
        s1 += qa[4 * j + 2] + qa[4 * j + 3];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s0 += __shfl_xor_sync(FULL_MASK, s0, o);
        s1 += __shfl_xor_sync(FULL_MASK, s1, o);
      }
      s0 = Q_SCALE / s0;
      s1 = Q_SCALE / s1;
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j) {
        qa[4 * j] *= s0;
        qa[4 * j + 1] *= s0;
        qa[4 * j + 2] *= s1;
        qa[4 * j + 3] *= s1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(qa[8 * kk + 2 * r], qa[8 * kk + 2 * r + 1]);

    // attn = q' (ctx / N) per head
    float at[NH][16];
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        wgmma_n32_rs(at[h], pa[2 * h + half], desc_plain(ctx_off + h * 2048 + half * 1024, 512, 128),
                     half);
    wgmma_commit();
    wgmma_wait0();
    uint32_t pb[8][4];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) reg_fence(at[h][j]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pb[kk][r] = pack_bf16(at[kk >> 1][8 * (kk & 1) + 2 * r], at[kk >> 1][8 * (kk & 1) + 2 * r + 1]);

    // o = attn W_out^T + b in groups of OG chunks; postLN statistics of rows
    // r0, r1 on the accumulators; y = x + postLN(o) over the x tile
    float o[OG][32];
    auto compute = [&](int grp) {
      int held[OG];
#pragma unroll
      for (int jj = 0; jj < OG; ++jj) {
        const int j = grp * OG + jj;
        held[jj] = -1;
        if (j < no) {
          held[jj] = acquire(nq + j);
          const uint32_t wa = w_off + held[jj] * CHUNK;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            wgmma_n64_rs(o[jj], pb[kk], desc_sw128(wa + (kk >> 2) * (CHUNK / 2) + (kk & 3) * 32, 16, 1024),
                         kk > 0);
          wgmma_commit();
        }
      }
      wgmma_wait0();
#pragma unroll
      for (int jj = 0; jj < OG; ++jj) {
#pragma unroll
        for (int j = 0; j < 32; ++j) reg_fence(o[jj][j]);
        if (held[jj] >= 0) release(held[jj]);
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // + b (columns past C: 0, never used)
            const int c = 64 * (grp * OG + jj) + 8 * i8 + 2 * cq + e;
            const float bv = c < C ? bS[c] : 0.f;
            o[jj][4 * i8 + e] += bv;
            o[jj][4 * i8 + 2 + e] += bv;
          }
      }
    };
    // f(rows r0 and r1's values) on this group's columns inside C (C % 16
    // == 0: a block of 8 columns is inside or outside for the whole warp)
    auto each = [&](int grp, auto&& f) {
#pragma unroll
      for (int jj = 0; jj < OG; ++jj)
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8)
          if (64 * (grp * OG + jj) + 8 * i8 < C)
#pragma unroll
            for (int e = 0; e < 2; ++e) f(o[jj][4 * i8 + e], o[jj][4 * i8 + 2 + e]);
    };
    auto quad_sum = [](float& a, float& b) {
#pragma unroll
      for (int k = 1; k < 4; k <<= 1) {
        a += __shfl_xor_sync(FULL_MASK, a, k);
        b += __shfl_xor_sync(FULL_MASK, b, k);
      }
    };
    float sa = 0.f, sb = 0.f;  // pass 0: the mean
    for (int grp = 0; grp < ng; ++grp) {
      compute(grp);
      each(grp, [&](float va, float vb) {
        sa += va;
        sb += vb;
      });
    }
    quad_sum(sa, sb);
    const float mean0 = sa / C, mean1 = sb / C;
    sa = sb = 0.f;  // pass 1: the variance
    for (int grp = 0; grp < ng; ++grp) {
      if (RECOMPUTE) compute(grp);
      each(grp, [&](float va, float vb) {
        sa += (va - mean0) * (va - mean0);
        sb += (vb - mean1) * (vb - mean1);
      });
    }
    quad_sum(sa, sb);
    const float rstd0 = rsqrtf(sa / C + EPS), rstd1 = rsqrtf(sb / C + EPS);
    const uint32_t xrel = xs - base;  // pass 2: y = x + postLN(o), over x
    for (int grp = 0; grp < ng; ++grp) {
      if (RECOMPUTE) compute(grp);
#pragma unroll
      for (int jj = 0; jj < OG; ++jj)
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8) {
          const int c8 = 64 * (grp * OG + jj) + 8 * i8;  // this block of 8 columns
          if (c8 >= C) continue;
          const uint32_t cb = xrel + c8 * XROW;
          float xv[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) xv[h][e] = lds_bf16(sm, cb + yo[h][e]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float gc = gpS[c8 + 2 * cq + e];
            sts_bf16(sm, cb + yo[0][e], xv[0][e] + (o[jj][4 * i8 + e] - mean0) * rstd0 * gc);
            sts_bf16(sm, cb + yo[1][e], xv[1][e] + (o[jj][4 * i8 + 2 + e] - mean1) * rstd1 * gc);
          }
        }
    }
    fence_async_smem();
    bar_sync(1 + cw, 128);
    if (wtid == 0) {
      for (int bx = 0; bx < nbox; ++bx) tma_store_3d(&ty, xs + bx * cb * XROW, n0, bx * cb, b);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(xempty + 8 * s);
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
//                        v[n, h, e], f32 (B, NH, DH, DH) (with
//                        la_ctx_combine_kernel, which folds the CTAs'
//                        partials).
//   la_mid_out_kernel <- _out_kernel (pass B): per position and head q' =
//                        softmax_d(q) * DH^-0.5 and out[h, e] = sum_d q'[d]
//                        ctx[h][d][e] / N, rounded once to qkv's dtype and
//                        written (B, HD, N).
//
// Numerics are the TPU kernels': f32 exponentials, sums and products on the
// values of qkv (bf16 or f32), the context kept per head (the TPU's
// block-diagonal (128, 128) without its zeros), ctx / N folded into pass B.
// N takes any value: a ragged last tile leaves its tail out of every sum
// (the TPU pads N with k = -1e30).  The TPU's roll-max cascade and selector
// matmuls exist for its 128-lane tiles and have no counterpart here.
//
// Bound on the H100: pass A reads k and v, pass B reads q and writes out:
// 2 HD values per position each, ~470 MB at B 2, N 458752 in bf16 (0.14
// ms).  Their f32 arithmetic (2 * 4096 FLOP per position) is the next
// bound.
//
// Pass A is the block's pass A (the Hopper bodies of rows 1-2) without the
// LayerNorm and the projection: persistent CTAs, grid (P, B) from the
// wrapper's mid_plan, CTA p walking the tiles p, p + P, ... of batch element
// b.  One producer thread keeps a ring of MID_STAGES tiles filled by TMA
// (cp.async.bulk.tensor, a 3-d map over the k and v rows as (ld, 2 HD, B)
// with the batch stride, [2 HD][TN] boxes of 128-byte rows, TN = 64 bf16 or
// 32 f32 positions, 128-byte swizzle); ld and the batch stride are
// multiples of 16 bytes (the wrapper copies a ragged or misaligned qkv once
// into a zero-padded buffer).  Eight consumer warps share nothing but the
// ring: warp (h, mh) owns the k channels d = 16 mh .. 16 mh + 15 of head h
// and their context rows ctx[h][d][0 .. 31].  A lane reads its two channels'
// k values of the tile straight into the A fragments of mma.sync m16n8k8,
// keeps their online max and sum (a quad of lanes holds a channel's row:
// two shuffles), turns them into exp(k - m) (ex2.approx) in registers, and
// sums the tile's E^T V (16 d x TN positions x 32 e) on the tensor cores in
// split TF32: exp(k - m) split into two TF32 parts, v too for f32 x (the
// three largest of the four products), while a bf16 v is exact in TF32 (two
// products).  V's fragments come from the tile as TMA left it: the
// swizzle puts the 8 rows a fragment reads in 8 different bank groups, so
// the loads are conflict-free (bf16 takes a lane's two positions of a
// k-step as one 32-bit word, its k index permuted alike in A and B).  Each
// tile's products are summed on their own before they join the running
// sums, rescaled as the max grows (the two-level sum of the block's pass
// A).  Each CTA writes one partial (m, s, sums) and la_ctx_combine_kernel
// folds them in the order p = 0 .. P-1: no float atomics, the same bits on
// every run.  Every mbarrier wait traps after ~10 s.
//
// Pass B (row 8; replaces _out_kernel, ops/attention_pallas.py:89, whose
// pallas_call is at :180) is bound by its bytes too: q read and out written
// once, 0.140 ms at B 2, N 458752 in bf16 and 0.281 in f32 (3.35 TB/s); its
// 2 * 4096 FLOP a position take 0.112 ms on f32 CUDA cores (67 TFLOP/s),
// 0.046 in split TF32 on the tensor cores (three products, 495 TFLOP/s).
// Its first body (one CTA of 256 threads a 32-position tile) reached ~21%
// of that: every CTA loaded the whole ctx and divided it by N (~470 MB of
// L2 reads at that shape), q came in by scalar loads with nothing in
// flight, half the threads ran the softmax serially over d, the product ran
// on f32 CUDA cores (~80% of the byte bound alone), and a warp's stores
// were 64-byte pieces.  This body is pass A's shape:
// - persistent CTAs, grid (P, B) from the wrapper's mid_out_plan (three
//   CTAs an SM, no second wave); each consumer warp
//   loads ctx[b][h] / N once (a division, as the plain version's), split
//   into TF32 hi and lo parts held in registers as the product's fixed
//   operand for every tile the CTA walks;
// - a producer warp keeps a ring of MO_STAGES q tiles full by TMA (a 3-d
//   map over the q rows as (N, HD, B) with the batch stride, [HD][128-byte]
//   boxes under the 128-byte swizzle, zero past N; a qkv whose rows or
//   batch stride are no multiple of 16 bytes is copied once into a padded
//   buffer by the wrapper);
// - four consumer warps, warp h for head h, share nothing but the ring.  A
//   lane reads, for two neighbouring positions at once (one 32-bit word in
//   bf16, 8 bytes in f32), its k index's d values straight from the
//   swizzled tile into B fragments of mma.sync m16n8k8 (K = d, N = 8
//   positions, the k index t <-> d = 8 kk + 2 t and t + 4 <-> 8 kk + 2 t + 1
//   permuted alike in A, which puts the rows a load reads in distinct bank
//   groups), so a quad holds one position's DH values: the softmax over d
//   is two quad shuffles for the max and two for the sum, ex2.approx in
//   registers, every lane busy;
// - out[e][pos] = sum_d (ctx / N)[d][e] q'[d][pos] runs on the tensor cores
//   in split TF32, three products (q' and ctx / N are both f32 and neither
//   is exact in TF32; a bf16 wgmma on a rounded q' would lose the f32
//   numerics), M = 16 channels e, so the accumulator is channel-major like
//   out;
// - a warp stages its head's [DH][128-byte] output tile in shared memory
//   (the same swizzle; its rows permuted, mo_row, so that the
//   8- or 16-byte stores fall in distinct banks) and writes it with one TMA
//   store of whole 128-byte rows, dropped past N.  An output whose rows
//   are no multiple of 16 bytes goes to a padded buffer the wrapper copies
//   out.  No atomics: the same bits on every run.
// Three CTAs an SM (12 consumer warps) beat two CTAs of four stages at the
// native shapes, and one CTA of six stages lost to both: the warps, not
// the tiles in flight, hide the latency.
// Measured (chip_smoke.py's profiler phase, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.1945 ms at (2, 458752) bf16 (72% of its bound), 0.370 f32 (76%), 0.579
// a native b2 eval's 8 blocks (64% of 0.373; the first body 1.509).
constexpr int MID_THREADS = 288;  // 8 consumer warps, then the producer warp
constexpr int MID_ROW = 128;      // bytes of one channel row of a tile
constexpr uint32_t MID_TILE = 2 * HD * MID_ROW;
constexpr int MID_STAGES = 3;     // tiles in flight a CTA (two CTAs an SM)
// the ring, its full and empty barriers, and the 1024-byte alignment slack
constexpr size_t MID_SMEM = 1024 + (size_t)MID_STAGES * MID_TILE + (size_t)2 * MID_STAGES * 8;
static_assert(2 * MID_SMEM <= 228 * 1024, "two pass-A CTAs must share an SM");

// Byte offset of (row r, position t) in a [2 HD][TN] tile of 128-byte rows
// under the 128-byte swizzle (16-byte chunk t / 16 XOR r mod 8).
template <typename TX>
__device__ __forceinline__ uint32_t mid_at(int r, int t) {
  const uint32_t byte = t * sizeof(TX);
  return r * MID_ROW + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}
// The position of a lane's value h (0: the k index cq of an m16n8k8 A or B
// fragment, 1: cq + 4) of k-step kk.  f32: 8 kk + cq + 4 h; bf16: 8 kk + 2 cq
// + h, both in one 32-bit word (the k index permuted alike in A and B).
template <typename TX>
__device__ __forceinline__ int mid_pos(int kk, int cq, int h) {
  return sizeof(TX) == 4 ? 8 * kk + cq + 4 * h : 8 * kk + 2 * cq + h;
}
// a lane's values 0 and 1 of k-step kk of row r, as f32
__device__ __forceinline__ void mid_pair(const unsigned char* tile, int r, int kk, int cq,
                                         float (&v)[2], float) {
  v[0] = *reinterpret_cast<const float*>(tile + mid_at<float>(r, mid_pos<float>(kk, cq, 0)));
  v[1] = *reinterpret_cast<const float*>(tile + mid_at<float>(r, mid_pos<float>(kk, cq, 1)));
}
__device__ __forceinline__ void mid_pair(const unsigned char* tile, int r, int kk, int cq,
                                         float (&v)[2], bf16) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(tile + mid_at<bf16>(r, mid_pos<bf16>(kk, cq, 0)));
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}

// Pass A.  grid (P, B), MID_THREADS threads, MID_SMEM bytes; tkv maps the
// k and v rows of qkv (channels HD .. 3 HD - 1) as (ld, 2 HD, B).  Writes this
// CTA's partial to part (B, P, PART).
template <typename TX>
__global__ void __launch_bounds__(MID_THREADS, 2)
la_mid_ctx_kernel(const __grid_constant__ CUtensorMap tkv, float* __restrict__ part, int N) {
  constexpr int S = MID_STAGES;
  constexpr int TN = MID_ROW / sizeof(TX);  // positions per tile
  constexpr int KS = TN / 8;                // k-steps of m16n8k8
  extern __shared__ unsigned char la_smem_raw[];
  unsigned char* sm = align1024(la_smem_raw);
  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int ntiles = (N + TN - 1) / TN;
  const int my = (ntiles - 1 - p) / P + 1;  // tiles p, p + P, ... (p < ntiles)
  const uint32_t base = smem_u32(sm);
  const uint32_t full = base + S * MID_TILE, empty = full + 8 * S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 8) {
    // ---- producer: the k | v tiles
    if (lane == 0)
      for (int i = 0; i < my; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(empty + 8 * s, (i / S - 1) & 1);
        mbar_expect_tx(full + 8 * s, MID_TILE);
        tma_load_3d(base + s * MID_TILE, &tkv, full + 8 * s, (p + i * P) * TN, 0, b);
      }
    return;
  }

  // ---- consumers: warp (h, mh) takes the k rows rk and rk + 8 (a lane's two
  // fragment rows), and all DH v rows of head h from rv
  const int h = warp >> 1, mh = warp & 1, g8 = lane >> 2, cq = lane & 3;
  const int rk = h * DH + 16 * mh + g8, rv = HD + h * DH + g8;
  float cacc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) cacc[nt][k] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, s_run[2] = {0.f, 0.f};

  for (int i = 0; i < my; ++i) {
    const int s = i % S, nvalid = min(TN, N - (p + i * P) * TN);
    const unsigned char* tile = sm + s * MID_TILE;
    mbar_wait_warp(full + 8 * s, (i / S) & 1);
    float a[2][KS][2];  // k, then exp(k - m): rows rk, rk + 8
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) mid_pair(tile, rk + 8 * r, kk, cq, a[r][kk], TX());
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (mid_pos<TX>(kk, cq, e) < nvalid) mt = fmaxf(mt, a[r][kk][e]);
      mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, 2));
      const float m_new = fmaxf(m_run[r], mt), ml = m_new * L2E;
      alpha[r] = expf(m_run[r] - m_new);
      float ssum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = mid_pos<TX>(kk, cq, e) < nvalid ? ex2(fmaf(a[r][kk][e], L2E, -ml)) : 0.f;
          a[r][kk][e] = x;
          ssum += x;
        }
      ssum += __shfl_xor_sync(FULL_MASK, ssum, 1);
      ssum += __shfl_xor_sync(FULL_MASK, ssum, 2);
      s_run[r] = s_run[r] * alpha[r] + ssum;
      m_run[r] = m_new;
    }

    // this tile's E^T V in split TF32: A (16 d x 8 positions) from registers,
    // B (8 positions x 8 e) from the v rows of the tile
    float ts[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) ts[nt][k] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ahi[4], alo[4];
      split_tf32(a[0][kk][0], ahi[0], alo[0]);
      split_tf32(a[1][kk][0], ahi[1], alo[1]);
      split_tf32(a[0][kk][1], ahi[2], alo[2]);
      split_tf32(a[1][kk][1], ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float bv[2];
        mid_pair(tile, rv + 8 * nt, kk, cq, bv, TX());
        uint32_t bhi[2], blo[2];
        if (sizeof(TX) == 2) {  // a bf16 value is exact in TF32
          bhi[0] = __float_as_uint(bv[0]);
          bhi[1] = __float_as_uint(bv[1]);
          mma_tf32(ts[nt], alo, bhi);
          mma_tf32(ts[nt], ahi, bhi);
        } else {
          split_tf32(bv[0], bhi[0], blo[0]);
          split_tf32(bv[1], bhi[1], blo[1]);
          mma_tf32(ts[nt], alo, bhi);  // the small products first
          mma_tf32(ts[nt], ahi, blo);
          mma_tf32(ts[nt], ahi, bhi);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // the warp's reads of the stage are done
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      cacc[nt][0] = cacc[nt][0] * alpha[0] + ts[nt][0];
      cacc[nt][1] = cacc[nt][1] * alpha[0] + ts[nt][1];
      cacc[nt][2] = cacc[nt][2] * alpha[1] + ts[nt][2];
      cacc[nt][3] = cacc[nt][3] * alpha[1] + ts[nt][3];
    }
  }

  float* pb = part + ((size_t)b * P + p) * PART;
  if (cq == 0) {
    pb[rk] = m_run[0], pb[rk + 8] = m_run[1];
    pb[HD + rk] = s_run[0], pb[HD + rk + 8] = s_run[1];
  }
  float* pc = pb + 2 * HD + rk * DH + 2 * cq;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(pc + 8 * nt) = make_float2(cacc[nt][0], cacc[nt][1]);
    *reinterpret_cast<float2*>(pc + 8 * DH + 8 * nt) = make_float2(cacc[nt][2], cacc[nt][3]);
  }
}

// ---- pass B (row 8)
constexpr int MO_WARPS = NH;                   // one consumer warp a head
constexpr int MO_THREADS = 32 * (MO_WARPS + 1);  // then the producer warp
constexpr uint32_t MO_TILE = HD * MID_ROW;     // a [HD][128 bytes] q tile
constexpr uint32_t MO_OUT = DH * MID_ROW;      // a warp's [DH][128 bytes] output tile
constexpr int MO_STAGES = 3;                   // q tiles in flight a CTA (three CTAs an SM)
// the ring, the warps' output tiles, the full and empty barriers, the alignment slack
constexpr size_t MO_SMEM = 1024 + (size_t)MO_STAGES * MO_TILE + (size_t)MO_WARPS * MO_OUT +
                           (size_t)2 * MO_STAGES * 8;
static_assert(3 * (MO_SMEM + 1024) <= 228 * 1024, "three pass-B CTAs must share an SM");

// The output channel e (of a head's DH) of row m of an A fragment of m-tile
// mt: rows g and g + 8 hold e = 16 mt + s(g) and 16 mt + 8 + s(g), with s a
// permutation of 0 .. 7 under which a warp's stores to its swizzled output
// tile fall in distinct banks (bf16: 8 bytes a lane, half a warp a wavefront,
// rows 0 2 4 6 then 1 3 5 7; f32: 16 bytes, a quarter, rows 4 apart).
template <typename TX>
__device__ __forceinline__ int mo_row(int mt, int m) {
  const int g = m & 7;
  const int s = sizeof(TX) == 2 ? (g < 4 ? 2 * g : 2 * g - 7) : ((g & 1) << 2) | (g >> 1);
  return 16 * mt + (m & 8) + s;
}
// a lane's values at positions pos and pos + 1 (pos even) of row r, as f32
__device__ __forceinline__ void mo_pair(const unsigned char* tile, int r, int pos, float (&v)[2],
                                        float) {
  const float2 u = *reinterpret_cast<const float2*>(tile + mid_at<float>(r, pos));
  v[0] = u.x, v[1] = u.y;
}
__device__ __forceinline__ void mo_pair(const unsigned char* tile, int r, int pos, float (&v)[2],
                                        bf16) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(tile + mid_at<bf16>(r, pos));
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}
// positions pos .. pos + 3 (pos a multiple of 4) of row r, rounded once to TX
__device__ __forceinline__ void mo_put(unsigned char* tile, int r, int pos, float a, float b,
                                       float c, float d, float) {
  *reinterpret_cast<float4*>(tile + mid_at<float>(r, pos)) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void mo_put(unsigned char* tile, int r, int pos, float a, float b,
                                       float c, float d, bf16) {
  *reinterpret_cast<uint2*>(tile + mid_at<bf16>(r, pos)) = make_uint2(pack_bf16(a, b),
                                                                      pack_bf16(c, d));
}

// Pass B.  grid (P, B) from the wrapper's mid_out_plan, MO_THREADS threads,
// MO_SMEM bytes; tq maps the q rows
// of qkv (channels 0 .. HD - 1) as (N, HD, B) in [HD][128-byte] boxes, tout
// the output (B, HD, ldo) as (N, HD, B) in [DH][128-byte] boxes (stores past
// N are dropped); ctx (B, NH, DH, DH) f32 from pass A.
template <typename TX>
__global__ void __launch_bounds__(MO_THREADS, 3)
la_mid_out_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tout,
                  const float* __restrict__ ctx, int N) {
  constexpr int S = MO_STAGES;
  constexpr int TN = MID_ROW / sizeof(TX);  // positions per tile
  constexpr int NJ = TN / 16;               // pairs of n8 position tiles a tile
  extern __shared__ unsigned char la_smem_raw[];
  unsigned char* sm = align1024(la_smem_raw);
  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int ntiles = (N + TN - 1) / TN;
  const int my = (ntiles - 1 - p) / P + 1;  // tiles p, p + P, ... (p < ntiles)
  const uint32_t base = smem_u32(sm);
  const uint32_t full = base + S * MO_TILE + MO_WARPS * MO_OUT, empty = full + 8 * S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, MO_WARPS);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == MO_WARPS) {
    // ---- producer: the q tiles
    if (lane == 0)
      for (int i = 0; i < my; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(empty + 8 * s, (i / S - 1) & 1);
        mbar_expect_tx(full + 8 * s, MO_TILE);
        tma_load_3d(base + s * MO_TILE, &tq, full + 8 * s, (p + i * P) * TN, 0, b);
      }
    return;
  }

  // ---- consumers: warp h takes head h.  The fixed operand A (16 e x 8 d,
  // two m-tiles, four k-steps) is ctx[b][h] / N in split TF32, its k index
  // t <-> d = 8 kk + 2 t and t + 4 <-> d = 8 kk + 2 t + 1 (permuted alike in B)
  const int h = warp, g = lane >> 2, t = lane & 3;
  uint32_t ahi[2][4][4], alo[2][4][4];
  {
    const float* ch = ctx + ((size_t)b * NH + h) * DH * DH;
    const float fn = (float)N;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int d = 8 * kk + 2 * t, e0 = mo_row<TX>(mt, g), e1 = mo_row<TX>(mt, g + 8);
        split_tf32(ch[d * DH + e0] / fn, ahi[mt][kk][0], alo[mt][kk][0]);
        split_tf32(ch[d * DH + e1] / fn, ahi[mt][kk][1], alo[mt][kk][1]);
        split_tf32(ch[(d + 1) * DH + e0] / fn, ahi[mt][kk][2], alo[mt][kk][2]);
        split_tf32(ch[(d + 1) * DH + e1] / fn, ahi[mt][kk][3], alo[mt][kk][3]);
      }
  }
  const int rq = h * DH + 2 * t;  // the lane's q row of k-step 0
  unsigned char* ot = sm + S * MO_TILE + warp * MO_OUT;  // the warp's output tile

  for (int i = 0; i < my; ++i) {
    const int s = i % S;
    const unsigned char* tile = sm + s * MO_TILE;
    if (lane == 0 && i > 0) bulk_wait_read();  // the last tile's store has read ot
    mbar_wait_warp(full + 8 * s, (i / S) & 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      // positions 16 j + 2 n (c = 0) and 16 j + 2 n + 1 (c = 1) are the
      // columns n of two n8 tiles; a lane holds the d values of its k index
      // at position n = g, so a quad holds a position's DH values
      float q[4][2][2];  // [kk][d = 8 kk + 2 t + hh][c]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) mo_pair(tile, rq + 8 * kk + hh, 16 * j + 2 * g, q[kk][hh], TX());
      // q' = softmax_d(q) * DH^-0.5: max and sum over the quad
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float m = -INFINITY;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) m = fmaxf(m, fmaxf(q[kk][0][c], q[kk][1][c]));
        m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 1));
        m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 2));
        const float ml = m * L2E;
        float sum = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            q[kk][hh][c] = ex2(fmaf(q[kk][hh][c], L2E, -ml));
            sum += q[kk][hh][c];
          }
        sum += __shfl_xor_sync(FULL_MASK, sum, 1);
        sum += __shfl_xor_sync(FULL_MASK, sum, 2);
        const float f = Q_SCALE / sum;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) q[kk][hh][c] *= f;
      }
      // out[e][pos] = sum_d (ctx / N)[d][e] q'[d][pos] in split TF32: three
      // products, the small ones first
      float acc[2][2][4];  // [c][mt]
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[c][mt][k] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bhi[2][2], blo[2][2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          split_tf32(q[kk][0][c], bhi[c][0], blo[c][0]);
          split_tf32(q[kk][1][c], bhi[c][1], blo[c][1]);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[c][mt], alo[mt][kk], bhi[c]);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[c][mt], ahi[mt][kk], blo[c]);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[c][mt], ahi[mt][kk], bhi[c]);
      }
      // a lane's accumulators hold rows mo_row(mt, g) and mo_row(mt, g + 8)
      // at positions 16 j + 4 t + (0, 1, 2, 3) = (c0 of c = 0, c0 of c = 1,
      // c1 of c = 0, c1 of c = 1) (c2, c3 alike)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mo_put(ot, mo_row<TX>(mt, g), 16 * j + 4 * t, acc[0][mt][0], acc[1][mt][0],
               acc[0][mt][1], acc[1][mt][1], TX());
        mo_put(ot, mo_row<TX>(mt, g + 8), 16 * j + 4 * t, acc[0][mt][2], acc[1][mt][2],
               acc[0][mt][3], acc[1][mt][3], TX());
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // the warp's reads of the stage are done
    fence_async_smem();                          // the output tile, to the TMA store
    __syncwarp();
    if (lane == 0) {
      tma_store_3d(&tout, smem_u32(ot), (p + i * P) * TN, h * DH, b);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait_read();  // the last store has read ot before the CTA exits
}

// ------------------------------------------------------------------ backward
//
// The block's backward, recompute-based like the TPU's (nothing but ctx, m
// and s is saved from the forward).  This section holds the first bodies of
// passes B' and A'2, which f32 x runs, and the one body of pass A'1, which
// both dtypes run; bf16 x runs the Hopper bodies of passes B' and A'2
// further below ("Hopper bodies of rows 3 and 5"), which keep the
// arithmetic described here but take the f32 products in split TF32 on the
// tensor cores:
//
//   la_bwd_q_kernel    <- _bwd_q_kernel (pass B'): recompute preLN -> q ->
//                         softmax -> attn -> W_out -> postLN, run the chain
//                         backward: dx_q (with the residual dy), dW_out,
//                         db_out, dW_q, the gain gradients and dctx.
//   la_bwd_sdot_kernel <- _bwd_kv1_kernel (pass A'1): the k-softmax coupling
//                         sdot = sum_n k' * dk', dk' = (v / N) headmask(dctx)^T,
//                         in its closed form sum_e ctx * dctx / N from the
//                         forward's ctx (below, "Pass A'1"): no recompute.
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
// 2 * 2 * 256 * C bf16 and ~2 * (256 * C + 2 * 4096) f32; at these widths
// the f32 work is the bound, above
// the bytes (x, dy read once, dx written once): on CUDA cores (67 TFLOP/s)
// in these bodies, which read the weight-gradient update's operands from
// shared memory and add into the partial once per tile of 32 positions; in
// split TF32 on the tensor cores (495 TFLOP/s, three or two products each)
// in the Hopper bodies.
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
la_bwd_q_f32_kernel(const TX* __restrict__ x, const TX* __restrict__ dy,
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

// Pass A'1 (row 4).  The TPU's pass recomputes k' and v over every position
// and sums sdot[h, d] = sum_n k'[n, h, d] dk'[n, h, d] with dk'[n, h, d] =
// sum_e v[n, h, e] / N dctx[h, d, e].  Exchanging the sums over n and e,
//   sdot[h, d] = sum_e (sum_n k'[n, h, d] v[n, h, e]) dctx[h, d, e] / N
//              = sum_e ctx[h, d, e] dctx[h, d, e] / N,
// where ctx is pass A's output from the same m and s, which the backward
// holds (saved by the forward, or recomputed by the same deterministic
// kernels under remat).  So the pass reads ctx and dctx (2 x 16 KB per batch
// element) and writes sdot (512 B): one warp per (b, h, d) row, lane e takes
// one product, a butterfly of shuffles sums the 32 in a fixed order, and one
// exact division by N ends it.  No atomics: the same bits on every launch;
// ctx and dctx are f32 whatever x is, so one body serves both dtypes.
// Bound on the H100: bytes (~33 KB per batch element); at the flagship's
// batches the launch itself is the floor.  grid (rows / 8), 256 threads.
__global__ void __launch_bounds__(THREADS)
la_bwd_sdot_kernel(const float* __restrict__ ctx, const float* __restrict__ dctx,
                   float* __restrict__ sdot, int rows, float n_f) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t i = (size_t)row * DH + lane;
  float v = __fmul_rn(ctx[i], dctx[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) sdot[row] = __fdiv_rn(v, n_f);
}

// An empty kernel: the launch floor that chip_smoke.py times beside pass A'1.
__global__ void la_empty_kernel() {}

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
la_bwd_kv2_f32_kernel(const TX* __restrict__ x, const float* __restrict__ g_pre,
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

// ------------------------------------------------ Hopper bodies of rows 3 and 5
//
// The bf16-x backward passes B' (la_bwd_q_kernel) and A'2 (la_bwd_kv2_kernel),
// redesigned for Hopper (sm_90a).  The f32-x instantiations keep the first
// bodies above (la_bwd_q_f32_kernel, la_bwd_kv2_f32_kernel); pass A'1 (row 4)
// is la_bwd_sdot_kernel for both.  Both passes share the plan of ops/attention_fused.py::
// la_bwd_plan, and the records and their ordered fold (la_reduce_kernel).
//
// - Persistent CTAs, grid (P, B), one consumer warp group and one producer
//   warp (BW_THREADS).  CTA p walks the tiles p, p + P, ... of batch element
//   b; a tile is TN = 64 positions, one wgmma row block.  The producer keeps
//   TMA loads in flight into a ring of S stages (3-d maps over (ld, C, B),
//   [64][C / nbox] boxes, 128-byte swizzle, as the forward): x with dy (pass
//   B') or x with dxq (pass A'2).  The output tile (dxq, dx) is written over
//   the dy / dxq stage and stored by TMA.
// - x stays in shared memory for the LayerNorm backward.  The normalised
//   tile LN(x) is kept beside it where the plan finds room (C <= 256: the A
//   of the projections q = LN(x) W_q^T and [k | v] = LN(x) W_kv^T, as in
//   the forward, and the exact TF32 B of dW_q and dW_kv); at C = 512 those
//   fragments are formed from x and the per-position statistics as they
//   are needed (the projections then take A from registers).
// - The bf16 products on wgmma, weights in shared memory (16 KB chunks:
//   w_q [128][64 channels], w_out [64 channels][128] as two boxes, w_kv
//   [128][64 channels] per half), resident where they fit and otherwise
//   streamed per tile through chunk slots in the order the consumers use
//   them.  The products whose reduction runs over the hidden index (dattn =
//   do W_out, dln = dq W_q, dln = dkv W_kv) read the same chunks as MN-major
//   B operands (the transpose bit), with A from registers: an accumulator of
//   one product packed to bf16 is the A fragment of the next.
// - The f32 products on the tensor cores, mma.sync m16n8k8 in split TF32
//   (each f32 operand split into hi + lo, the three largest of the four
//   products summed in f32: f32's accuracy; two products where the other
//   operand is bf16, which TF32 holds exactly):
//     dq' = dattn (ctx / N)^T, dk' = (v / N) dctx^T, dv = k' dctx / N sum over
//       a row's own columns, so their A fragments are the wgmma accumulators
//       themselves (the k index permuted alike in A and B);
//     dctx += q'^T dattn, dW_out += do^T attn, dW_q += dq^T ln, dW_kv += dkv^T
//       ln sum over the positions: the f32 operand is staged in shared memory
//       as [t][.] rows (pitch 8 mod 32: conflict-free fragment loads).
// - Partial sums kept over the CTA's run: dctx in registers; the weight and
//   gain gradients in shared memory where they fit (C = 64: 64 KB), written
//   to the CTA's record once at the end.  Wider blocks keep them in the
//   record itself, added to once per tile straight from the mma
//   accumulators (no float atomics: each element has one owner thread), with
//   P capped so that all records stay within L2 (la_bwd_plan).  The fold of
//   the records is ordered: the same bits on every run.
// - Per-position statistics by shuffles: the LN statistics by a warp's
//   transposing butterfly over its 8 positions' 16-byte chunks, the postLN
//   statistics, the softmax backward's row dot and the LayerNorm backward's
//   means by quad shuffles on the accumulators (a quad holds a row), the
//   per-channel sums by the 8-row-group butterfly and a 4-warp fold.  The
//   warp group synchronises by a named barrier.
// - Every mbarrier wait traps after ~10 s instead of hanging the card.
//
// Measured on an H100 (PERF.md), both passes are latency-bound: one
// consumer warp group (4 warps an SM) walks ~15 dependent phases a tile.
// Pass B' holds the most state (dattn, the postLN and softmax backwards)
// and spills at 255 registers; splitting its heads and channels between two
// cooperating warp groups is the next step.
constexpr int BW_THREADS = 160;  // one consumer warp group, then the producer warp
constexpr int AP = 136;          // f32 pitch of [64][128] staging (8 mod 32)
constexpr int DP = 72;           // f32 pitch of [64][64] staging
constexpr int CP = 36;           // f32 pitch of pass A'2's dctx rows [h][d][e]

// Shared memory of the two passes (la_bwd_plan in ops/attention_fused.py
// computes the same): 1 KB of alignment slack, the x and dy (dxq) rings, the
// normalised tile (ln), the weight chunk slots, then per pass the tiles
// below; acc: the partial sums in shared memory.
__host__ __device__ inline size_t bwdq_bf16_smem(int C, int S, int slots, bool acc, bool ln) {
  return 1024 + (size_t)(2 * S + ln) * C * XROW + (size_t)slots * CHUNK +
         (size_t)NH * DH * DH * 2 +                   // ctx / N, bf16 planes
         (size_t)TN * AP * 4 + (size_t)TN * DP * 4 +   // attn (then q', dattn, dq of a head); do
         (size_t)4 * 128 * 4 + (size_t)2 * TN * 4 +    // per-warp column sums; mean, rstd
         (acc ? bwdq_record(C) * 4 : 0) +               // the record (dctx included)
         (size_t)(2 * S + 2 * slots) * 8;              // mbarriers
}
__host__ __device__ inline size_t kv2_bf16_smem(int C, int S, int slots, bool acc, bool ln) {
  return 1024 + (size_t)(2 * S + ln) * C * XROW + (size_t)slots * CHUNK +
         (size_t)NH * DH * CP * 4 + (size_t)TN * AP * 4 +  // dctx; dk | dv of two heads
         (size_t)2 * TN * 4 + (size_t)3 * HD * 4 +          // mean, rstd; m, s, sdot
         (acc ? (size_t)2 * HD * C * 4 + (size_t)C * 4 : 0) +
         (size_t)(2 * S + 2 * slots) * 8;
}

struct BwdPlan {
  int C, N, S, slots, resident;
};

// D (64 x 128) += A (64 x 16, registers) B (16 x 128, K-major planes, 128-byte swizzle)
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 64) += A (64 x 16, registers) B (16 x 64, MN-major: N contiguous, 128-byte swizzle)
__device__ __forceinline__ void wgmma_n64_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// byte offset of element (c, t) of a [C][64] bf16 tile under the 128-byte swizzle
__device__ __forceinline__ uint32_t tile_at(int c, int t) {
  return c * XROW + ((((t >> 3) ^ c) & 7) << 4) + ((t & 7) << 1);
}

// Mean and rstd over C of the positions 8 j .. 8 j + 7, j = j0 and j0 + 4,
// of a [C][64] bf16 tile at byte offset xs (two passes, as chunk_ln), by one
// warp -> stat[t], stat[TN + t]; with LN, a third pass writes bf16((x -
// mean) rstd g) at byte offset la, in the tile's layout.
template <bool LN>
__device__ __forceinline__ void tile_stats(unsigned char* sm, uint32_t xs, uint32_t la, int C, int j0,
                                           float* stat, const float* g) {
  const int lane = threadIdx.x & 31;
  float v[8], acc[2][8], mean[2][8];
  auto at = [&](int c, int n) { return xs + c * XROW + (((j0 + 4 * n) ^ (c & 7)) << 4); };
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[n][k] = 0.f;
  for (int c = lane; c < C; c += 32)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      unpack8(*reinterpret_cast<const uint4*>(sm + at(c, n)), v);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[n][k] += v[k];
    }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float m = warp_sum8(acc[n]) / C;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      mean[n][k] = __shfl_sync(FULL_MASK, m, 4 * k);
      acc[n][k] = 0.f;
    }
    if ((lane & 3) == 0) stat[8 * (j0 + 4 * n) + (lane >> 2)] = m;
  }
  for (int c = lane; c < C; c += 32)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      unpack8(*reinterpret_cast<const uint4*>(sm + at(c, n)), v);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[n][k] += (v[k] - mean[n][k]) * (v[k] - mean[n][k]);
    }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float r = rsqrtf(warp_sum8(acc[n]) / C + EPS);
    if ((lane & 3) == 0) stat[TN + 8 * (j0 + 4 * n) + (lane >> 2)] = r;
    if (LN)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[n][k] = __shfl_sync(FULL_MASK, r, 4 * k);  // rstd
  }
  if (LN) {
    for (int c = lane; c < C; c += 32) {
      const float gc = __ldg(g + c);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t o = c * XROW + (((j0 + 4 * n) ^ (c & 7)) << 4);
        unpack8(*reinterpret_cast<const uint4*>(sm + xs + o), v);
        float y[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) y[k] = (v[k] - mean[n][k]) * acc[n][k] * gc;
        *reinterpret_cast<uint4*>(sm + la + o) = make_uint4(
            pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
      }
    }
    fence_async_smem();
  }
}

// d += a b in split TF32: the small products first (3xTF32), or two products
// where b is exact in TF32 (a bf16 value)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&b)[2]) {
  mma_tf32(d, al, b);
  mma_tf32(d, ah, b);
}
// the fragments of a product summed over positions, from [t][.] f32 rows
// (pitch ld): A (16 x 8) element (m, k) = S[(k0 + k) ld + m0 + m] f, B (8 x
// 8) element (k, n) = S[(k0 + k) ld + n0 + n], both split
__device__ __forceinline__ void frag_a(const float* S, int ld, int m0, int k0, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4], float f = 1.f) {
  const int lane = threadIdx.x & 31;
  const float* q = S + (k0 + (lane & 3)) * ld + m0 + (lane >> 2);
  split_tf32(q[0] * f, hi[0], lo[0]);
  split_tf32(q[8] * f, hi[1], lo[1]);
  split_tf32(q[4 * ld] * f, hi[2], lo[2]);
  split_tf32(q[4 * ld + 8] * f, hi[3], lo[3]);
}
__device__ __forceinline__ void frag_b(const float* S, int ld, int n0, int k0, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const int lane = threadIdx.x & 31;
  const float* q = S + (k0 + (lane & 3)) * ld + n0 + (lane >> 2);
  split_tf32(q[0], hi[0], lo[0]);
  split_tf32(q[4 * ld], hi[1], lo[1]);
}
// the A fragment of a product over a row's own 8 columns 8 i .. 8 i + 7 of
// a wgmma accumulator, d0 .. d3 = its registers 4 i .. 4 i + 3 (k index
// permuted: k = cq <- column 2 cq, cq + 4 <- 2 cq + 1; the B fragment takes
// the same order), each value scaled by f
__device__ __forceinline__ void frag_acc(float d0, float d1, float d2, float d3, float f,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(d0 * f, hi[0], lo[0]);
  split_tf32(d2 * f, hi[1], lo[1]);
  split_tf32(d1 * f, hi[2], lo[2]);
  split_tf32(d3 * f, hi[3], lo[3]);
}
// keeps the A registers of an in-flight wgmma from reuse until after its wait
template <int R>
__device__ __forceinline__ void a_fence(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}
// TF32 bits of bf16(v): exact
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __float_as_uint(__bfloat162float(__float2bfloat16(v)));
}
__device__ __forceinline__ void quad_sum2(float& a, float& b) {
#pragma unroll
  for (int k = 1; k < 4; k <<= 1) {
    a += __shfl_xor_sync(FULL_MASK, a, k);
    b += __shfl_xor_sync(FULL_MASK, b, k);
  }
}

// What both passes share: the thread's place in the warp group, the x and
// output stages of tile i, the weight chunks in use order, and the
// fragments formed from the x tile.
struct BwdCtx {
  unsigned char* sm;
  uint32_t base, w_off, wfull, wempty;
  int slots, L, tid, lane, w, g8, cq, r0, r1;
  bool resident;
  uint32_t yo[2][2];  // byte offsets of (row r0 / r1, column 2 cq + e) of an 8-column block
  __device__ BwdCtx(unsigned char* sm_, uint32_t base_, uint32_t w_off_, uint32_t wfull_,
                    uint32_t wempty_, int slots_, int L_, bool resident_)
      : sm(sm_), base(base_), w_off(w_off_), wfull(wfull_), wempty(wempty_), slots(slots_), L(L_),
        resident(resident_) {
    tid = threadIdx.x;
    lane = tid & 31;
    w = tid >> 5;
    g8 = lane >> 2;
    cq = lane & 3;
    r0 = w * 16 + g8;
    r1 = r0 + 8;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        yo[h][e] = (2 * cq + e) * XROW + ((((2 * w + h) ^ (2 * cq + e)) << 4) | (g8 << 1));
  }
  // the slot of this tile's next weight chunk (resident: rslot), once loaded
  __device__ int acquire(int i, int& u, int rslot) const {
    const int it = i * L + u++;
    const int slot = resident ? rslot : it % slots;
    mbar_wait_warp(wfull + 8 * slot, resident ? 0 : (it / slots) & 1);
    return slot;
  }
  __device__ void release(int slot) const {
    if (!resident && lane == 0) mbar_arrive(wempty + 8 * slot);
  }
  // bf16 value at (row h of this thread, column c8 + 2 cq + e) of a tile
  __device__ float at(uint32_t tile, int c8, int h, int e) const {
    return lds_bf16(sm, tile - base + c8 * XROW + yo[h][e]);
  }
  __device__ void put(uint32_t tile, int c8, int h, int e, float v) const {
    sts_bf16(sm, tile - base + c8 * XROW + yo[h][e], v);
  }
};

// The A fragment of k-step kk of LN(x) (rows r0, r1; channels 16 kk ..): bf16
// of (x - mean) rstd g, as the forward's normalised tile
__device__ __forceinline__ void ln_frag(const BwdCtx& K, uint32_t xt, int kk, const float* g,
                                        float mu0, float rs0, float mu1, float rs1,
                                        uint32_t (&a)[4]) {
  const int c = 16 * kk + 2 * K.cq;
  const float g0 = __ldg(g + c), g1 = __ldg(g + c + 1), g2 = __ldg(g + c + 8), g3 = __ldg(g + c + 9);
  const uint32_t x = xt - K.base;
  auto v = [&](int cc, int t, float mu, float rs, float gg) {
    return (lds_bf16(K.sm, x + tile_at(cc, t)) - mu) * rs * gg;
  };
  a[0] = pack_bf16(v(c, K.r0, mu0, rs0, g0), v(c + 1, K.r0, mu0, rs0, g1));
  a[1] = pack_bf16(v(c, K.r1, mu1, rs1, g0), v(c + 1, K.r1, mu1, rs1, g1));
  a[2] = pack_bf16(v(c + 8, K.r0, mu0, rs0, g2), v(c + 9, K.r0, mu0, rs0, g3));
  a[3] = pack_bf16(v(c + 8, K.r1, mu1, rs1, g2), v(c + 9, K.r1, mu1, rs1, g3));
}

// acc[j][c] += sum_t A[t][j] ln[c][t] for this warp's rows j = m0 .. m0 + 31
// (NMB = 2 row blocks of 16; A f32 rows [t][.] of pitch lda, staged column
// a0) and the channel blocks nb = nb0, nb0 + nbs, ... of 8 (all C / 8 of
// them), in split TF32 (ln is exact in TF32).  The partial acc (rows of C)
// is in shared memory or in the record (first: the tile stores, not adds).
template <bool LNT>
__device__ __forceinline__ void wgrad_ln(const BwdCtx& K, const float* A, int lda, int a0,
                                         float* acc, int row0, uint32_t xt, uint32_t lt,
                                         const float* stat, const float* g, int C, int nb0, int nbs,
                                         bool load) {
  const uint32_t x = xt - K.base, l = lt - K.base;
  const int nbk = C / 8;
  for (int nbg = nb0; nbg < nbk; nbg += 4 * nbs) {
    float d[2][4][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int nb = nbg + m * nbs;
        float* row = acc + (size_t)(row0 + 16 * mb + K.g8) * C + 8 * nb + 2 * K.cq;
        float2 p = make_float2(0.f, 0.f), q = p;
        if (load && nb < nbk) {
          p = *reinterpret_cast<const float2*>(row);
          q = *reinterpret_cast<const float2*>(row + 8 * C);
        }
        d[mb][m][0] = p.x;
        d[mb][m][1] = p.y;
        d[mb][m][2] = q.x;
        d[mb][m][3] = q.y;
      }
#pragma unroll 2
    for (int kb = 0; kb < TN / 8; ++kb) {
      const int t0 = 8 * kb + K.cq, t1 = t0 + 4;
      float mu0 = 0.f, rs0 = 0.f, mu1 = 0.f, rs1 = 0.f;
      if (!LNT) {
        mu0 = stat[t0];
        rs0 = stat[TN + t0];
        mu1 = stat[t1];
        rs1 = stat[TN + t1];
      }
      uint32_t bl[4][2];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int nb = nbg + m * nbs;
        if (nb >= nbk) continue;
        const int c = 8 * nb + K.g8;
        if (LNT) {
          bl[m][0] = __float_as_uint(lds_bf16(K.sm, l + tile_at(c, t0)));
          bl[m][1] = __float_as_uint(lds_bf16(K.sm, l + tile_at(c, t1)));
        } else {
          const float gc = __ldg(g + c);
          bl[m][0] = bf16_bits((lds_bf16(K.sm, x + tile_at(c, t0)) - mu0) * rs0 * gc);
          bl[m][1] = bf16_bits((lds_bf16(K.sm, x + tile_at(c, t1)) - mu1) * rs1 * gc);
        }
      }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        uint32_t ah[4], al[4];
        frag_a(A, lda, a0 + 16 * mb, 8 * kb, ah, al);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (nbg + m * nbs < nbk) mma2(d[mb][m], ah, al, bl[m]);
      }
    }
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int nb = nbg + m * nbs;
        if (nb >= nbk) continue;
        float* row = acc + (size_t)(row0 + 16 * mb + K.g8) * C + 8 * nb + 2 * K.cq;
        *reinterpret_cast<float2*>(row) = make_float2(d[mb][m][0], d[mb][m][1]);
        *reinterpret_cast<float2*>(row + 8 * C) = make_float2(d[mb][m][2], d[mb][m][3]);
      }
  }
}

// Pass B', bf16 x.  grid (P, B), BW_THREADS threads, bwdq_bf16_smem bytes.
// tx, tdy, tdo map x, dy and dxq as (ld, C, B) with [64][C / nbox] boxes; twq
// maps w_q (128, C) with [128][64] boxes, two w_out (C, 128) with [64][64]
// boxes.  ACC: the partial sums in shared memory (else in the record); LNT:
// the normalised tile in shared memory (else formed from x where needed).
// part (B * P, bwdq_record(C)).
template <bool ACC, bool LNT>
__global__ void __launch_bounds__(BW_THREADS, 1)
la_bwd_q_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap twq,
                const __grid_constant__ CUtensorMap two, const float* __restrict__ g_pre,
                const float* __restrict__ ctx, const float* __restrict__ b_out,
                const float* __restrict__ g_post, float* __restrict__ part, BwdPlan pl) {
  extern __shared__ unsigned char la_smem_raw[];
  unsigned char* sm = align1024(la_smem_raw);
  const int C = pl.C, N = pl.N, S = pl.S, slots = pl.slots;
  const bool resident = pl.resident != 0;
  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int ntiles = (N + TN - 1) / TN;
  const int my = (ntiles - 1 - p) / P + 1;
  const int nq = (C + 63) / 64;  // 64-channel chunks of w_q and of w_out
  const int L = 7 * nq;          // chunks a tile uses: w_q, w_out x 3, w_q x 3
  const int nbox = C > 256 ? 2 : 1, cb = C / nbox;
  const uint32_t xsz = (uint32_t)C * XROW;

  const uint32_t base = smem_u32(sm);
  const uint32_t x_off = base, y_off = x_off + S * xsz, la_off = y_off + S * xsz;
  const uint32_t w_off = la_off + (LNT ? xsz : 0), ctx_off = w_off + slots * CHUNK;
  float* As = reinterpret_cast<float*>(sm + (ctx_off - base) + NH * DH * DH * 2);  // [TN][AP]
  float* Ds = As + TN * AP;      // [TN][DP]: do of a chunk; per-warp channel sums [4][C]
  float* colb = Ds + TN * DP;    // [4][128]
  float* stat = colb + 4 * 128;  // mean [TN] | rstd [TN]
  float* accS = stat + 2 * TN;   // ACC: the partial sums, laid out as the record
  const uint32_t xfull = smem_u32(accS + (ACC ? bwdq_record(C) : 0)), xempty = xfull + 8 * S;
  const uint32_t wfull = xempty + 8 * S, wempty = wfull + 8 * slots;
  float* rec = part + ((size_t)b * P + p) * bwdq_record(C);
  float* acc = ACC ? accS : rec;  // dW_out (C, HD) | dW_q (HD, C) | db_out | dg_pre | dg_post | dctx

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(xfull + 8 * s, 1);
      mbar_init(xempty + 8 * s, 1);  // after the tile's dxq store has read the stage
    }
    for (int s = 0; s < slots; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ACC)
    for (int i = threadIdx.x; i < (int)bwdq_record(C); i += blockDim.x) accS[i] = 0.f;
  // ctx / N as bf16 K-major planes (the B of attn, as la_out_kernel)
  for (int i = threadIdx.x; i < NH * DH * DH; i += blockDim.x) {
    const int h = i / (DH * DH), d = (i / DH) % DH, e = i % DH;
    sts_bf16(sm, ctx_off - base + h * 2048 + (d >> 3) * 512 + e * 16 + (d & 7) * 2,
             __fdiv_rn(ctx[(size_t)b * NH * DH * DH + i], (float)N));
  }
  fence_async_smem();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4) {
    // ---- producer: x and dy tiles, and the weight chunks (once, or per tile)
    if (lane == 0) {
      auto load_q = [&](int k, int slot) {  // one [128][64] box
        mbar_expect_tx(wfull + 8 * slot, CHUNK);
        tma_load_2d(w_off + slot * CHUNK, &twq, wfull + 8 * slot, 64 * k, 0);
      };
      auto load_o = [&](int j, int slot) {  // two [64][64] boxes: hidden 0-63, 64-127
        mbar_expect_tx(wfull + 8 * slot, CHUNK);
        for (int h = 0; h < 2; ++h)
          tma_load_2d(w_off + slot * CHUNK + h * CHUNK / 2, &two, wfull + 8 * slot, 64 * h, 64 * j);
      };
      if (resident) {
        for (int k = 0; k < nq; ++k) load_q(k, k);
        for (int j = 0; j < nq; ++j) load_o(j, nq + j);
      }
      int wit = 0;
      for (int i = 0; i < my; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(xempty + 8 * s, (i / S - 1) & 1);
        mbar_expect_tx(xfull + 8 * s, 2 * xsz);
        for (int bx = 0; bx < nbox; ++bx) {
          tma_load_3d(x_off + s * xsz + bx * cb * XROW, &tx, xfull + 8 * s, (p + i * P) * TN,
                      bx * cb, b);
          tma_load_3d(y_off + s * xsz + bx * cb * XROW, &tdy, xfull + 8 * s, (p + i * P) * TN,
                      bx * cb, b);
        }
        if (!resident)
          for (int u = 0; u < L; ++u, ++wit) {
            const int slot = wit % slots;
            if (wit >= slots) mbar_wait(wempty + 8 * slot, (wit / slots - 1) & 1);
            if (u < nq)
              load_q(u, slot);
            else if (u < 4 * nq)
              load_o((u - nq) % nq, slot);
            else
              load_q((u - 4 * nq) % nq, slot);
          }
      }
    }
    return;
  }

  // ---- the consumer warp group
  const BwdCtx K(sm, base, w_off, wfull, wempty, slots, L, resident);
  const int tid = K.tid, w = K.w, g8 = K.g8, cq = K.cq, r0 = K.r0, r1 = K.r1;
  const int ksteps = C / 16;
  const float inv_n = 1.f / (float)N;
  const float* ctxb = ctx + (size_t)b * NH * DH * DH;
  float* dW_out = acc;
  float* dW_q = acc + (size_t)C * HD;
  float* cols = acc + (size_t)2 * C * HD;      // db_out | dg_pre | dg_post
  float* dctx_p = cols + 3 * C;                // (NH, DH, DH)

  for (int i = 0; i < my; ++i) {
    const bool load = ACC || i > 0;  // the record's partial: the first tile stores
    const int n0 = (p + i * P) * TN, nvalid = min(TN, N - n0);
    const int s = i % S;
    const uint32_t xt = x_off + s * xsz, yt = y_off + s * xsz;
    mbar_wait_warp(xfull + 8 * s, (i / S) & 1);
    tile_stats<LNT>(sm, xt - base, la_off - base, C, w, stat, g_pre);
    bar_sync(1, 128);
    const float mu0 = stat[r0], rs0 = stat[TN + r0], mu1 = stat[r1], rs1 = stat[TN + r1];
    const bool v0 = r0 < nvalid, v1 = r1 < nvalid;
    int u = 0;

    // q = LN(x) W_q^T and its softmax over each head's 32 channels (sq)
    auto q_softmax = [&](float (&qa)[64]) {
      for (int k = 0; k < nq; ++k) {
        const int slot = K.acquire(i, u, k);
        const uint32_t wa = w_off + slot * CHUNK;
        uint32_t a[4][4];
        if (!LNT)
#pragma unroll
          for (int sub = 0; sub < 4; ++sub)
            if (4 * k + sub < ksteps) ln_frag(K, xt, 4 * k + sub, g_pre, mu0, rs0, mu1, rs1, a[sub]);
        wgmma_fence();
#pragma unroll
        for (int sub = 0; sub < 4; ++sub) {
          const int kk = 4 * k + sub;
          if (kk >= ksteps) continue;
          const uint64_t db = desc_sw128(wa + sub * 32, 16, 1024);
          if (LNT)
            wgmma_n128(qa, desc_sw128(la_off + kk * 2048, 4096, 1024), db, kk > 0);
          else
            wgmma_n128_rs(qa, a[sub], db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        if (!LNT) a_fence(a);
        K.release(slot);
      }
#pragma unroll
      for (int j = 0; j < 64; ++j) reg_fence(qa[j]);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int j = 4 * h; j < 4 * h + 4; ++j) {
          m0 = fmaxf(m0, fmaxf(qa[4 * j], qa[4 * j + 1]));
          m1 = fmaxf(m1, fmaxf(qa[4 * j + 2], qa[4 * j + 3]));
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(FULL_MASK, m0, o));
          m1 = fmaxf(m1, __shfl_xor_sync(FULL_MASK, m1, o));
        }
        float s0 = 0.f, s1 = 0.f;
        m0 *= L2E;
        m1 *= L2E;
#pragma unroll
        for (int j = 4 * h; j < 4 * h + 4; ++j) {
          qa[4 * j] = ex2(fmaf(qa[4 * j], L2E, -m0));
          qa[4 * j + 1] = ex2(fmaf(qa[4 * j + 1], L2E, -m0));
          qa[4 * j + 2] = ex2(fmaf(qa[4 * j + 2], L2E, -m1));
          qa[4 * j + 3] = ex2(fmaf(qa[4 * j + 3], L2E, -m1));
          s0 += qa[4 * j] + qa[4 * j + 1];
          s1 += qa[4 * j + 2] + qa[4 * j + 3];
        }
        quad_sum2(s0, s1);
        s0 = 1.f / s0;
        s1 = 1.f / s1;
#pragma unroll
        for (int j = 4 * h; j < 4 * h + 4; ++j) {
          qa[4 * j] *= s0;
          qa[4 * j + 1] *= s0;
          qa[4 * j + 2] *= s1;
          qa[4 * j + 3] *= s1;
        }
      }
    };

    // ---- q' -> attn = q' (ctx / N), f32 to As: the B of dW_out, and (each
    // thread's own rows, packed to bf16 again per use) the A of o
    {
      float qa[64];
      q_softmax(qa);
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(qa[8 * kk + 2 * r] * Q_SCALE, qa[8 * kk + 2 * r + 1] * Q_SCALE);
      float at[NH][16];
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          wgmma_n32_rs(at[h], pa[2 * h + half], desc_plain(ctx_off + h * 2048 + half * 1024, 512, 128),
                       half);
      wgmma_commit();
      wgmma_wait0();
      a_fence(pa);
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) reg_fence(at[h][j]);
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int col = 32 * h + 8 * m + 2 * cq;
          *reinterpret_cast<float2*>(As + r0 * AP + col) = make_float2(at[h][4 * m], at[h][4 * m + 1]);
          *reinterpret_cast<float2*>(As + r1 * AP + col) =
              make_float2(at[h][4 * m + 2], at[h][4 * m + 3]);
        }
    }

    // ---- o = attn W_out^T + b, chunk j of 64 channels (its slot still held)
    auto o_chunk = [&](int j, float (&o)[32]) -> int {
      const int slot = K.acquire(i, u, nq + j);
      const uint32_t wa = w_off + slot * CHUNK;
      uint32_t pb[8][4];  // attn of rows r0, r1, bf16: k-step kk is columns 16 kk ..
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 a = *reinterpret_cast<const float2*>(As + r0 * AP + 16 * kk + 8 * hf + 2 * cq);
          const float2 c2 = *reinterpret_cast<const float2*>(As + r1 * AP + 16 * kk + 8 * hf + 2 * cq);
          pb[kk][2 * hf] = pack_bf16(a.x, a.y);
          pb[kk][2 * hf + 1] = pack_bf16(c2.x, c2.y);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_n64_rs(o, pb[kk], desc_sw128(wa + (kk >> 2) * (CHUNK / 2) + (kk & 3) * 32, 16, 1024),
                     kk > 0);
      wgmma_commit();
      wgmma_wait0();
      a_fence(pb);
#pragma unroll
      for (int k = 0; k < 32; ++k) reg_fence(o[k]);
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 64 * j + 8 * i8 + 2 * cq + e;
          const float bv = c < C ? __ldg(b_out + c) : 0.f;
          o[4 * i8 + e] += bv;
          o[4 * i8 + 2 + e] += bv;
        }
      return slot;
    };
    // postLN statistics of o (mean, then the variance and the two sums of
    // its backward: sum dy g, sum dy g (o - mean)), on the accumulators
    float mo0 = 0.f, mo1 = 0.f;
    for (int j = 0; j < nq; ++j) {
      float o[32];
      K.release(o_chunk(j, o));
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8)
        if (64 * j + 8 * i8 < C)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mo0 += o[4 * i8 + e];
            mo1 += o[4 * i8 + 2 + e];
          }
    }
    quad_sum2(mo0, mo1);
    mo0 /= C;
    mo1 /= C;
    float va = 0.f, vb = 0.f, d1a = 0.f, d1b = 0.f, d2a = 0.f, d2b = 0.f;
    for (int j = 0; j < nq; ++j) {
      float o[32];
      K.release(o_chunk(j, o));
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const int c8 = 64 * j + 8 * i8;
        if (c8 >= C) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gp = __ldg(g_post + c8 + 2 * cq + e);
          const float da = o[4 * i8 + e] - mo0, db = o[4 * i8 + 2 + e] - mo1;
          const float ga = K.at(yt, c8, 0, e) * gp, gb = K.at(yt, c8, 1, e) * gp;
          va += da * da;
          vb += db * db;
          d1a += ga;
          d1b += gb;
          d2a += ga * da;
          d2b += gb * db;
        }
      }
    }
    quad_sum2(va, vb);
    quad_sum2(d1a, d1b);
    quad_sum2(d2a, d2b);
    const float ro0 = rsqrtf(va / C + EPS), ro1 = rsqrtf(vb / C + EPS);
    const float m1a = d1a / C, m1b = d1b / C, m2a = d2a * ro0 / C, m2b = d2b * ro1 / C;

    // ---- do = LN_bwd(dy g_post) per chunk: dg_post, db_out, dattn += do
    // W_out (wgmma, w_out as MN-major B), dW_out += do^T attn (split TF32)
    float dat[2][32];
#pragma unroll 1
    for (int j = 0; j < nq; ++j) {
      float o[32];
      const int slot = o_chunk(j, o);
      const uint32_t wa = w_off + slot * CHUNK;
      float vg[16];
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const int c8 = 64 * j + 8 * i8;
        const bool in = c8 < C;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gp = in ? __ldg(g_post + c8 + 2 * cq + e) : 0.f;
          const float ya = in && v0 ? K.at(yt, c8, 0, e) : 0.f;
          const float yb = in && v1 ? K.at(yt, c8, 1, e) : 0.f;
          const float ha = (o[4 * i8 + e] - mo0) * ro0, hb = (o[4 * i8 + 2 + e] - mo1) * ro1;
          vg[2 * i8 + e] = ya * ha + yb * hb;
          o[4 * i8 + e] = in && v0 ? (ya * gp - m1a - ha * m2a) * ro0 : 0.f;
          o[4 * i8 + 2 + e] = in && v1 ? (yb * gp - m1b - hb * m2b) * ro1 : 0.f;
        }
      }
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        *reinterpret_cast<float2*>(Ds + r0 * DP + 8 * i8 + 2 * cq) = make_float2(o[4 * i8], o[4 * i8 + 1]);
        *reinterpret_cast<float2*>(Ds + r1 * DP + 8 * i8 + 2 * cq) =
            make_float2(o[4 * i8 + 2], o[4 * i8 + 3]);
      }
      uint32_t pd[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pd[kk][r] = pack_bf16(o[8 * kk + 2 * r], o[8 * kk + 2 * r + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t sc = j > 0 || kk > 0;
        wgmma_n64_rs_mn(dat[0], pd[kk], desc_sw128(wa + kk * 2048, 4096, 1024), sc);
        wgmma_n64_rs_mn(dat[1], pd[kk], desc_sw128(wa + CHUNK / 2 + kk * 2048, 4096, 1024), sc);
      }
      wgmma_commit();
      wgmma_wait0();
      a_fence(pd);
      K.release(slot);
      float r[2];
      warp_cols16<false>(vg, r);
#pragma unroll
      for (int k = 0; k < 2; ++k) colb[w * 128 + 8 * g8 + 2 * cq + k] = r[k];
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
        for (int e = 0; e < 2; ++e) vg[2 * i8 + e] = o[4 * i8 + e] + o[4 * i8 + 2 + e];
      warp_cols16<false>(vg, r);
#pragma unroll
      for (int k = 0; k < 2; ++k) colb[w * 128 + 64 + 8 * g8 + 2 * cq + k] = r[k];
      bar_sync(1, 128);
      {  // fold the 4 warps' sums: thread (quantity tid / 64, channel)
        const int qn = tid >> 6, col = tid & 63, c = 64 * j + col;
        if (c < C) {
          const float v = colb[qn * 64 + col] + colb[128 + qn * 64 + col] + colb[256 + qn * 64 + col] +
                          colb[384 + qn * 64 + col];
          float* dst = cols + (qn == 0 ? 2 * C : 0) + c;  // dg_post | db_out
          *dst = (load ? *dst : 0.f) + v;
        }
      }
      // dW_out rows c = 64 j + 16 w + g8 (+ 8), all 128 columns in quarters
      const int cm = 64 * j + 16 * w;
      if (cm < C)
#pragma unroll 1
        for (int qt = 0; qt < 4; ++qt) {
          float d[4][4];
          float* row = dW_out + (size_t)(cm + g8) * HD + 32 * qt + 2 * cq;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float2 a = make_float2(0.f, 0.f), c2 = a;
            if (load) {
              a = *reinterpret_cast<const float2*>(row + 8 * n);
              c2 = *reinterpret_cast<const float2*>(row + 8 * HD + 8 * n);
            }
            d[n][0] = a.x;
            d[n][1] = a.y;
            d[n][2] = c2.x;
            d[n][3] = c2.y;
          }
#pragma unroll 2
          for (int kb = 0; kb < TN / 8; ++kb) {
            uint32_t ah[4], al[4];
            frag_a(Ds, DP, 16 * w, 8 * kb, ah, al);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              uint32_t bh[2], bl[2];
              frag_b(As, AP, 32 * qt + 8 * n, 8 * kb, bh, bl);
              mma3(d[n], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            *reinterpret_cast<float2*>(row + 8 * n) = make_float2(d[n][0], d[n][1]);
            *reinterpret_cast<float2*>(row + 8 * HD + 8 * n) = make_float2(d[n][2], d[n][3]);
          }
        }
      bar_sync(1, 128);  // Ds and colb are free again
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      reg_fence(dat[0][k]);
      reg_fence(dat[1][k]);
    }

    // ---- per head: dq' = dattn (ctx / N)^T, dq = sq (dq' s - sum_d sq dq' s),
    // then dctx += q'^T dattn and dW_q += dq^T ln.  sq (recomputed) goes to
    // As (attn is dead), the head's dattn and dq to Ds.
    {
      float qa[64];
      q_softmax(qa);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(As + r0 * AP + 8 * j + 2 * cq) = make_float2(qa[4 * j], qa[4 * j + 1]);
        *reinterpret_cast<float2*>(As + r1 * AP + 8 * j + 2 * cq) =
            make_float2(qa[4 * j + 2], qa[4 * j + 3]);
      }
    }
    uint32_t pq[8][4];  // dq, bf16: the A of dln
    float* dah = Ds;        // [TN][DP]: columns 0-31 dattn, 32-63 dq of the head
    float* dqh = Ds + 32;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float dh[16];  // the head's 4 column blocks of dattn
#pragma unroll
      for (int k = 0; k < 16; ++k) dh[k] = dat[h >> 1][16 * (h & 1) + k];
      float dqp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) dqp[n][k] = 0.f;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        uint32_t ah[4], al[4];
        frag_acc(dh[4 * ii], dh[4 * ii + 1], dh[4 * ii + 2], dh[4 * ii + 3], 1.f, ah, al);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float2 cv = __ldg(reinterpret_cast<const float2*>(
              ctxb + h * DH * DH + (8 * n + g8) * DH + 8 * ii + 2 * cq));
          uint32_t bh[2], bl[2];
          split_tf32(cv.x * inv_n, bh[0], bl[0]);
          split_tf32(cv.y * inv_n, bh[1], bl[1]);
          mma3(dqp[n], ah, al, bh, bl);
        }
      }
      float sq[16];  // this thread's sq of the head, as dqp
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 a = *reinterpret_cast<const float2*>(As + r0 * AP + 32 * h + 8 * n + 2 * cq);
        const float2 c2 = *reinterpret_cast<const float2*>(As + r1 * AP + 32 * h + 8 * n + 2 * cq);
        sq[4 * n] = a.x;
        sq[4 * n + 1] = a.y;
        sq[4 * n + 2] = c2.x;
        sq[4 * n + 3] = c2.y;
      }
      float ra = 0.f, rb = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ra += sq[4 * n + e] * (dqp[n][e] * Q_SCALE);
          rb += sq[4 * n + 2 + e] * (dqp[n][2 + e] * Q_SCALE);
        }
      quad_sum2(ra, rb);
      float dq[16];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dq[4 * n + e] = sq[4 * n + e] * (dqp[n][e] * Q_SCALE - ra);
          dq[4 * n + 2 + e] = sq[4 * n + 2 + e] * (dqp[n][2 + e] * Q_SCALE - rb);
        }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 8 * n + 2 * cq;
        *reinterpret_cast<float2*>(dah + r0 * DP + col) = make_float2(dh[4 * n], dh[4 * n + 1]);
        *reinterpret_cast<float2*>(dah + r1 * DP + col) = make_float2(dh[4 * n + 2], dh[4 * n + 3]);
        *reinterpret_cast<float2*>(dqh + r0 * DP + col) = make_float2(dq[4 * n], dq[4 * n + 1]);
        *reinterpret_cast<float2*>(dqh + r1 * DP + col) = make_float2(dq[4 * n + 2], dq[4 * n + 3]);
      }
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pq[2 * h + s2][r] = pack_bf16(dq[8 * s2 + 2 * r], dq[8 * s2 + 2 * r + 1]);
      bar_sync(1, 128);
      {  // dctx_h += q'^T dattn: rows d = 16 (w & 1) + g8 (+ 8), columns e = 16 (w >> 1) + 8 n + 2 cq
        float d[2][4];
        float* row = dctx_p + h * DH * DH + (16 * (w & 1) + g8) * DH + 16 * (w >> 1) + 2 * cq;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float2 a = make_float2(0.f, 0.f), c2 = a;
          if (load) {
            a = *reinterpret_cast<const float2*>(row + 8 * n);
            c2 = *reinterpret_cast<const float2*>(row + 8 * DH + 8 * n);
          }
          d[n][0] = a.x;
          d[n][1] = a.y;
          d[n][2] = c2.x;
          d[n][3] = c2.y;
        }
#pragma unroll 2
        for (int kb = 0; kb < TN / 8; ++kb) {
          uint32_t ah[4], al[4];
          frag_a(As, AP, 32 * h + 16 * (w & 1), 8 * kb, ah, al, Q_SCALE);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint32_t bh[2], bl[2];
            frag_b(dah, DP, 16 * (w >> 1) + 8 * n, 8 * kb, bh, bl);
            mma3(d[n], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          *reinterpret_cast<float2*>(row + 8 * n) = make_float2(d[n][0], d[n][1]);
          *reinterpret_cast<float2*>(row + 8 * DH + 8 * n) = make_float2(d[n][2], d[n][3]);
        }
      }
      wgrad_ln<LNT>(K, dqh, DP, 0, dW_q, 32 * h, xt, la_off, stat, g_pre, C, w, 4, load);
      bar_sync(1, 128);
    }

    // ---- dln = dq W_q (w_q chunk cc as MN-major B) and the LayerNorm
    // backward: dg_pre, dxq = dy + rstd (dln g - mean(dln g) - xhat mean(dln g xhat))
    auto dln_chunk = [&](int cc, float (&dl)[32]) {
      const int slot = K.acquire(i, u, cc);
      const uint32_t wa = w_off + slot * CHUNK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_n64_rs_mn(dl, pq[kk], desc_sw128(wa + kk * 2048, 4096, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int k = 0; k < 32; ++k) reg_fence(dl[k]);
      K.release(slot);
    };
    float s1a = 0.f, s1b = 0.f, s2a = 0.f, s2b = 0.f;
    float* cw = Ds + w * C;  // this warp's sums of dln xhat per channel ([4][C] over Ds)
    for (int cc = 0; cc < nq; ++cc) {
      float dl[32], vg[16];
      dln_chunk(cc, dl);
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const int c8 = 64 * cc + 8 * i8;
        const bool in = c8 < C;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float g = in ? __ldg(g_pre + c8 + 2 * cq + e) : 0.f;
          const float xa = in ? (K.at(xt, c8, 0, e) - mu0) * rs0 : 0.f;
          const float xb = in ? (K.at(xt, c8, 1, e) - mu1) * rs1 : 0.f;
          const float da = dl[4 * i8 + e] * g, db = dl[4 * i8 + 2 + e] * g;
          s1a += da;
          s1b += db;
          s2a += da * xa;
          s2b += db * xb;
          vg[2 * i8 + e] = dl[4 * i8 + e] * xa + dl[4 * i8 + 2 + e] * xb;
        }
      }
      float r[2];
      warp_cols16<false>(vg, r);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = 64 * cc + 8 * g8 + 2 * cq + k;
        if (c < C) cw[c] = r[k];
      }
    }
    quad_sum2(s1a, s1b);
    quad_sum2(s2a, s2b);
    s1a /= C;
    s1b /= C;
    s2a /= C;
    s2b /= C;
    bar_sync(1, 128);
    for (int c = tid; c < C; c += 128) {
      const float v = Ds[c] + Ds[C + c] + Ds[2 * C + c] + Ds[3 * C + c];
      cols[C + c] = (load ? cols[C + c] : 0.f) + v;
    }
    for (int cc = 0; cc < nq; ++cc) {
      float dl[32];
      dln_chunk(cc, dl);
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const int c8 = 64 * cc + 8 * i8;
        if (c8 >= C) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float g = __ldg(g_pre + c8 + 2 * cq + e);
          const float xa = (K.at(xt, c8, 0, e) - mu0) * rs0, xb = (K.at(xt, c8, 1, e) - mu1) * rs1;
          K.put(yt, c8, 0, e, K.at(yt, c8, 0, e) + (dl[4 * i8 + e] * g - s1a - xa * s2a) * rs0);
          K.put(yt, c8, 1, e, K.at(yt, c8, 1, e) + (dl[4 * i8 + 2 + e] * g - s1b - xb * s2b) * rs1);
        }
      }
    }
    fence_async_smem();
    bar_sync(1, 128);
    if (tid == 0) {
      for (int bx = 0; bx < nbox; ++bx) tma_store_3d(&tdo, yt + bx * cb * XROW, n0, bx * cb, b);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(xempty + 8 * s);
    }
  }

  // ---- the record, where the sums were kept in shared memory
  if (ACC) {
    bar_sync(1, 128);
    for (int k = tid; k < (int)bwdq_record(C) / 4; k += 128)
      reinterpret_cast<float4*>(rec)[k] = reinterpret_cast<const float4*>(accS)[k];
  }
}

// Pass A'2, bf16 x.  grid (P, B), BW_THREADS threads, kv2_bf16_smem bytes.
// tx, tq, tdx map x, dxq and dx as (ld, C, B) with [64][C / nbox] boxes; tw
// maps w_kv (256, C) with [128][64] boxes.  ACC and LNT as for pass B'.
// sdot (B, HD) complete; part (B * P, kv2_record(C)).
template <bool ACC, bool LNT>
__global__ void __launch_bounds__(BW_THREADS, 1)
la_bwd_kv2_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdx, const __grid_constant__ CUtensorMap tw,
                  const float* __restrict__ g_pre, const float* __restrict__ m,
                  const float* __restrict__ s, const float* __restrict__ dctx,
                  const float* __restrict__ sdot, float* __restrict__ part, BwdPlan pl) {
  extern __shared__ unsigned char la_smem_raw[];
  unsigned char* sm = align1024(la_smem_raw);
  const int C = pl.C, N = pl.N, S = pl.S, slots = pl.slots;
  const bool resident = pl.resident != 0;
  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int ntiles = (N + TN - 1) / TN;
  const int my = (ntiles - 1 - p) / P + 1;
  const int nq = (C + 63) / 64;  // 64-channel chunks; each has a k half and a v half of w_kv
  const int L = 8 * nq;          // chunks a tile uses: k, v of heads 0-1, of heads 2-3, dln x 2
  const int nbox = C > 256 ? 2 : 1, cb = C / nbox;
  const uint32_t xsz = (uint32_t)C * XROW;

  const uint32_t base = smem_u32(sm);
  const uint32_t x_off = base, q_off = x_off + S * xsz, la_off = q_off + S * xsz;
  const uint32_t w_off = la_off + (LNT ? xsz : 0);
  float* dS = reinterpret_cast<float*>(sm + (w_off - base) + (size_t)slots * CHUNK);  // [NH][DH][CP]
  float* KV = dS + NH * DH * CP;  // [TN][AP]: dk | dv of two heads; per-warp channel sums [4][C]
  float* stat = KV + TN * AP;     // mean [TN] | rstd [TN]
  float* ms = stat + 2 * TN;      // m | 1 / s | sdot
  float* accS = ms + 3 * HD;      // ACC: dW_kv (2HD, C) | dg_pre (C)
  const uint32_t xfull = smem_u32(accS + (ACC ? 2 * HD * C + C : 0)), xempty = xfull + 8 * S;
  const uint32_t wfull = xempty + 8 * S, wempty = wfull + 8 * slots;
  float* rec = part + ((size_t)b * P + p) * kv2_record(C);
  float* acc = ACC ? accS : rec;
  float* dW_kv = acc;
  float* cols = acc + (size_t)2 * HD * C;

  if (threadIdx.x == 0) {
    for (int q = 0; q < S; ++q) {
      mbar_init(xfull + 8 * q, 1);
      mbar_init(xempty + 8 * q, 1);
    }
    for (int q = 0; q < slots; ++q) {
      mbar_init(wfull + 8 * q, 1);
      mbar_init(wempty + 8 * q, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ACC)
    for (int k = threadIdx.x; k < 2 * HD * C + C; k += blockDim.x) accS[k] = 0.f;
  for (int k = threadIdx.x; k < NH * DH * DH; k += blockDim.x)
    dS[(k / DH) * CP + k % DH] = dctx[(size_t)b * NH * DH * DH + k];
  for (int k = threadIdx.x; k < HD; k += blockDim.x) {
    ms[k] = m[(size_t)b * HD + k];
    ms[HD + k] = 1.f / s[(size_t)b * HD + k];
    ms[2 * HD + k] = sdot[(size_t)b * HD + k];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4) {
    // ---- producer: x and dxq tiles, and the w_kv chunks (once, or per tile)
    if (lane == 0) {
      auto load_w = [&](int h, int cc, int slot) {  // one [128][64] box: rows 128 h .., channels 64 cc ..
        mbar_expect_tx(wfull + 8 * slot, CHUNK);
        tma_load_2d(w_off + slot * CHUNK, &tw, wfull + 8 * slot, 64 * cc, 128 * h);
      };
      if (resident)
        for (int cc = 0; cc < nq; ++cc)
          for (int h = 0; h < 2; ++h) load_w(h, cc, 2 * cc + h);
      int wit = 0;
      for (int i = 0; i < my; ++i) {
        const int q = i % S;
        if (i >= S) mbar_wait(xempty + 8 * q, (i / S - 1) & 1);
        mbar_expect_tx(xfull + 8 * q, 2 * xsz);
        for (int bx = 0; bx < nbox; ++bx) {
          tma_load_3d(x_off + q * xsz + bx * cb * XROW, &tx, xfull + 8 * q, (p + i * P) * TN,
                      bx * cb, b);
          tma_load_3d(q_off + q * xsz + bx * cb * XROW, &tq, xfull + 8 * q, (p + i * P) * TN,
                      bx * cb, b);
        }
        if (!resident)
          for (int u = 0; u < L; ++u, ++wit) {
            const int slot = wit % slots;
            if (wit >= slots) mbar_wait(wempty + 8 * slot, (wit / slots - 1) & 1);
            load_w(u & 1, (u >> 1) % nq, slot);
          }
      }
    }
    return;
  }

  // ---- the consumer warp group
  const BwdCtx K(sm, base, w_off, wfull, wempty, slots, L, resident);
  const int tid = K.tid, w = K.w, g8 = K.g8, cq = K.cq, r0 = K.r0, r1 = K.r1;
  const int ksteps = C / 16;
  const float inv_n = 1.f / (float)N;

  for (int i = 0; i < my; ++i) {
    const bool load = ACC || i > 0;
    const int n0 = (p + i * P) * TN, nvalid = min(TN, N - n0);
    const int q = i % S;
    const uint32_t xt = x_off + q * xsz, qt = q_off + q * xsz;
    mbar_wait_warp(xfull + 8 * q, (i / S) & 1);
    tile_stats<LNT>(sm, xt - base, la_off - base, C, w, stat, g_pre);
    bar_sync(1, 128);
    const float mu0 = stat[r0], rs0 = stat[TN + r0], mu1 = stat[r1], rs1 = stat[TN + r1];
    const bool v0 = r0 < nvalid, v1 = r1 < nvalid;
    int u = 0;

    uint32_t pk[16][4];  // dkv, bf16: the A of dln; k-step 8 h + 4 g + s is j = 128 h + 64 g + 16 s
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      // [k | v] of heads 2 g, 2 g + 1 = LN(x) W_kv^T (rows 64 g .. of each half)
      float ka[32], va[32];
      for (int cc = 0; cc < nq; ++cc) {
        const int sk = K.acquire(i, u, 2 * cc), sv = K.acquire(i, u, 2 * cc + 1);
        const uint32_t wk = w_off + sk * CHUNK + 64 * g * XROW, wv = w_off + sv * CHUNK + 64 * g * XROW;
        uint32_t a[4][4];
        if (!LNT)
#pragma unroll
          for (int sub = 0; sub < 4; ++sub)
            if (4 * cc + sub < ksteps) ln_frag(K, xt, 4 * cc + sub, g_pre, mu0, rs0, mu1, rs1, a[sub]);
        wgmma_fence();
#pragma unroll
        for (int sub = 0; sub < 4; ++sub) {
          const int kk = 4 * cc + sub;
          if (kk >= ksteps) continue;
          if (LNT) {
            const uint64_t da = desc_sw128(la_off + kk * 2048, 4096, 1024);
            wgmma_n64(ka, da, desc_sw128(wk + sub * 32, 16, 1024), kk > 0);
            wgmma_n64(va, da, desc_sw128(wv + sub * 32, 16, 1024), kk > 0);
          } else {
            wgmma_n64_rs(ka, a[sub], desc_sw128(wk + sub * 32, 16, 1024), kk > 0);
            wgmma_n64_rs(va, a[sub], desc_sw128(wv + sub * 32, 16, 1024), kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait0();
        if (!LNT) a_fence(a);
        K.release(sk);
        K.release(sv);
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        reg_fence(ka[k]);
        reg_fence(va[k]);
      }
      // k' = exp(k - m) / s (0 past N)
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 64 * g + 8 * i8 + 2 * cq + e;
          const float mm = ms[c] * L2E, rs = ms[HD + c];
          ka[4 * i8 + e] = v0 ? ex2(fmaf(ka[4 * i8 + e], L2E, -mm)) * rs : 0.f;
          ka[4 * i8 + 2 + e] = v1 ? ex2(fmaf(ka[4 * i8 + 2 + e], L2E, -mm)) * rs : 0.f;
        }
      // per head: dk' = (v / N) dctx^T, dv = k' dctx / N (A: the accumulators);
      // dk = k' (dk' - sdot) and dv replace k' and v
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const int h = 2 * g + hl;
        const float* dh = dS + h * DH * CP;
        float dkp[4][4], dvv[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k) dkp[n][k] = dvv[n][k] = 0.f;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          uint32_t avh[4], avl[4], akh[4], akl[4];
          const int i4 = 4 * (4 * hl + ii);
          frag_acc(va[i4], va[i4 + 1], va[i4 + 2], va[i4 + 3], inv_n, avh, avl);
          frag_acc(ka[i4], ka[i4 + 1], ka[i4 + 2], ka[i4 + 3], 1.f, akh, akl);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            uint32_t bh[2], bl[2];
            const float2 c2 = *reinterpret_cast<const float2*>(dh + (8 * n + g8) * CP + 8 * ii + 2 * cq);
            split_tf32(c2.x, bh[0], bl[0]);
            split_tf32(c2.y, bh[1], bl[1]);
            mma3(dkp[n], avh, avl, bh, bl);
            split_tf32(dh[(8 * ii + 2 * cq) * CP + 8 * n + g8], bh[0], bl[0]);
            split_tf32(dh[(8 * ii + 2 * cq + 1) * CP + 8 * n + g8], bh[1], bl[1]);
            mma3(dvv[n], akh, akl, bh, bl);
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sd = ms[2 * HD + 32 * h + 8 * n + 2 * cq + e];
            const int k0 = 4 * (4 * hl + n) + e;
            ka[k0] *= dkp[n][e] - sd;
            ka[k0 + 2] *= dkp[n][2 + e] - sd;
            va[k0] = dvv[n][e] * inv_n;
            va[k0 + 2] = dvv[n][2 + e] * inv_n;
          }
      }
      // stage dk | dv (f32) for dW_kv; pack them for dln
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const int col = 8 * i8 + 2 * cq;
        *reinterpret_cast<float2*>(KV + r0 * AP + col) = make_float2(ka[4 * i8], ka[4 * i8 + 1]);
        *reinterpret_cast<float2*>(KV + r1 * AP + col) = make_float2(ka[4 * i8 + 2], ka[4 * i8 + 3]);
        *reinterpret_cast<float2*>(KV + r0 * AP + 64 + col) = make_float2(va[4 * i8], va[4 * i8 + 1]);
        *reinterpret_cast<float2*>(KV + r1 * AP + 64 + col) = make_float2(va[4 * i8 + 2], va[4 * i8 + 3]);
      }
#pragma unroll
      for (int s2 = 0; s2 < 4; ++s2)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pk[4 * g + s2][r] = pack_bf16(ka[8 * s2 + 2 * r], ka[8 * s2 + 2 * r + 1]);
          pk[8 + 4 * g + s2][r] = pack_bf16(va[8 * s2 + 2 * r], va[8 * s2 + 2 * r + 1]);
        }
      bar_sync(1, 128);
      // dW_kv rows += dkv^T ln: warp w takes staged columns 32 w .. 32 w + 31
      // (k rows 64 g + .. for w < 2, v rows 128 + 64 g + .. for w >= 2)
      const int jl = 32 * w, jrow = jl < 64 ? 64 * g + jl : HD + 64 * g + jl - 64;
      wgrad_ln<LNT>(K, KV, AP, jl, dW_kv, jrow, xt, la_off, stat, g_pre, C, 0, 1, load);
      bar_sync(1, 128);
    }

    // ---- dln = dkv W_kv (the chunks as MN-major B) and the LayerNorm
    // backward: dg_pre, dx = dxq + bf16(rstd (dln g - mean(dln g) - xhat mean(dln g xhat)))
    auto dln_chunk = [&](int cc, float (&dl)[32]) {
      const int sk = K.acquire(i, u, 2 * cc), sv = K.acquire(i, u, 2 * cc + 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        wgmma_n64_rs_mn(dl, pk[kk], desc_sw128(w_off + (kk < 8 ? sk : sv) * CHUNK + (kk & 7) * 2048,
                                               4096, 1024),
                        kk > 0);
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int k = 0; k < 32; ++k) reg_fence(dl[k]);
      K.release(sk);
      K.release(sv);
    };
    float s1a = 0.f, s1b = 0.f, s2a = 0.f, s2b = 0.f;
    float* cw = KV + w * C;  // this warp's sums of dln xhat per channel ([4][C] over KV)
    for (int cc = 0; cc < nq; ++cc) {
      float dl[32], vg[16];
      dln_chunk(cc, dl);
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const int c8 = 64 * cc + 8 * i8;
        const bool in = c8 < C;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float g = in ? __ldg(g_pre + c8 + 2 * cq + e) : 0.f;
          const float xa = in ? (K.at(xt, c8, 0, e) - mu0) * rs0 : 0.f;
          const float xb = in ? (K.at(xt, c8, 1, e) - mu1) * rs1 : 0.f;
          const float da = dl[4 * i8 + e] * g, db = dl[4 * i8 + 2 + e] * g;
          s1a += da;
          s1b += db;
          s2a += da * xa;
          s2b += db * xb;
          vg[2 * i8 + e] = dl[4 * i8 + e] * xa + dl[4 * i8 + 2 + e] * xb;
        }
      }
      float r[2];
      warp_cols16<false>(vg, r);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = 64 * cc + 8 * g8 + 2 * cq + k;
        if (c < C) cw[c] = r[k];
      }
    }
    quad_sum2(s1a, s1b);
    quad_sum2(s2a, s2b);
    s1a /= C;
    s1b /= C;
    s2a /= C;
    s2b /= C;
    bar_sync(1, 128);
    for (int c = tid; c < C; c += 128) {
      const float v = KV[c] + KV[C + c] + KV[2 * C + c] + KV[3 * C + c];
      cols[c] = (load ? cols[c] : 0.f) + v;
    }
    for (int cc = 0; cc < nq; ++cc) {
      float dl[32];
      dln_chunk(cc, dl);
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const int c8 = 64 * cc + 8 * i8;
        if (c8 >= C) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float g = __ldg(g_pre + c8 + 2 * cq + e);
          const float xa = (K.at(xt, c8, 0, e) - mu0) * rs0, xb = (K.at(xt, c8, 1, e) - mu1) * rs1;
          const float ka = round_to((dl[4 * i8 + e] * g - s1a - xa * s2a) * rs0, bf16());
          const float kb = round_to((dl[4 * i8 + 2 + e] * g - s1b - xb * s2b) * rs1, bf16());
          K.put(qt, c8, 0, e, K.at(qt, c8, 0, e) + ka);
          K.put(qt, c8, 1, e, K.at(qt, c8, 1, e) + kb);
        }
      }
    }
    fence_async_smem();
    bar_sync(1, 128);  // also: the channel sums in KV are folded
    if (tid == 0) {
      for (int bx = 0; bx < nbox; ++bx) tma_store_3d(&tdx, qt + bx * cb * XROW, n0, bx * cb, b);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(xempty + 8 * q);
    }
  }

  if (ACC) {
    bar_sync(1, 128);
    for (int k = tid; k < (2 * HD * C + C) / 4; k += 128)
      reinterpret_cast<float4*>(rec)[k] = reinterpret_cast<const float4*>(accS)[k];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// x or y as (ld, C, B) bf16, [64 positions][C / nbox channels] boxes with the
// 128-byte swizzle (nbox = 2 above 256 channels, a box's limit); zero past ld
bool map_x(CUtensorMap* map, const void* base, int ld, int C, int B) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int nbox = C > 256 ? 2 : 1;
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)ld * C * 2};
  const cuuint32_t box[3] = {TN, (cuuint32_t)(C / nbox), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major bf16 weight (rows, cols) with [box_rows][64] boxes under the
// 128-byte swizzle: K-major wgmma operands, 64 columns (128 bytes) a row;
// zero past the matrix
bool map_w(CUtensorMap* map, const void* base, int cols, int rows, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

int combine(const float* part, int P, float* ctx, float* m, float* s, int B, cudaStream_t st) {
  la_ctx_combine_kernel<<<dim3(NH * DH * DH / THREADS, B), THREADS, 0, st>>>(part, P, ctx, m, s);
  return (int)cudaGetLastError();
}

// Pass A and its combine.  The plan (P, S, slots, resident, smem) is the
// wrapper's la_plan; it is checked against what the body needs here.
int launch_ctx(const void* x, int x_bf16, int ld, const float* g_pre, const bf16* w_kv,
               float* part, float* ctx, float* m, float* s, int B, int C, int N, int P, int S,
               int slots, int resident, int smem, cudaStream_t st) {
  if (!x_bf16) {
    if (ld != N || P < 1 || P > (N + T - 1) / T || (size_t)smem != ctx_smem(C))
      return (int)cudaErrorInvalidValue;
    int err = set_smem(la_ctx_f32_kernel, smem);
    if (err) return err;
    la_ctx_f32_kernel<<<dim3(P, B), THREADS, smem, st>>>(static_cast<const float*>(x), g_pre, w_kv,
                                                         part, C, N);
    err = (int)cudaGetLastError();
    return err ? err : combine(part, P, ctx, m, s, B, st);
  }
  const int nch = (C + 63) / 64;
  if (ld < N || ld % 8 || !aligned16(x) || !aligned16(w_kv) || P < 1 || P > (N + TN - 1) / TN ||
      S < 1 || (resident ? slots != nch : slots < 2) || smem > SMEM_LIMIT ||
      (size_t)smem != ctx_bf16_smem(C, S, slots))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!map_x(&tx, x, ld, C, B) || !map_w(&tw, w_kv, C, 2 * HD, 2 * HD))
    return (int)cudaErrorInvalidValue;
  int err = set_smem(la_ctx_kernel, smem);
  if (err) return err;
  const CtxPlan pl{C, N, S, slots, resident};
  la_ctx_kernel<<<dim3(P, B), A_THREADS, smem, st>>>(tx, tw, g_pre, part, pl);
  err = (int)cudaGetLastError();
  return err ? err : combine(part, P, ctx, m, s, B, st);
}

template <int OG, bool RECOMPUTE, int NW>
int launch_out_og(const CUtensorMap& tx, const CUtensorMap& ty, const CUtensorMap& twq,
                  const CUtensorMap& two, const float* g_pre, const float* ctx,
                  const float* b_out, const float* g_post, const OutPlan& pl, int B, int P,
                  int smem, cudaStream_t st) {
  int err = set_smem(la_out_kernel<OG, RECOMPUTE, NW>, smem);
  if (err) return err;
  la_out_kernel<OG, RECOMPUTE, NW><<<dim3(P, B), 128 * NW + 32, smem, st>>>(tx, ty, twq, two, g_pre, ctx,
                                                                 b_out, g_post, pl);
  return (int)cudaGetLastError();
}

// Pass B.  The plan (P, S, slots, resident, nw, smem) is the wrapper's la_plan.
int launch_out(const void* x, int x_bf16, int ld, const float* g_pre, const bf16* w_q,
               const float* ctx, const bf16* w_out, const float* b_out, const float* g_post,
               void* y, int B, int C, int N, int P, int S, int slots, int resident, int nw,
               int smem, cudaStream_t st) {
  if (!x_bf16) {
    if (ld != N || P != (N + T - 1) / T || (size_t)smem != out_smem(C))
      return (int)cudaErrorInvalidValue;
    int err = set_smem(la_out_f32_kernel, smem);
    if (err) return err;
    la_out_f32_kernel<<<dim3(P, B), THREADS, smem, st>>>(static_cast<const float*>(x), g_pre,
                                                         w_q, ctx, w_out, b_out, g_post,
                                                         static_cast<float*>(y), C, N);
    return (int)cudaGetLastError();
  }
  const int nq = (C + 63) / 64;
  if (ld < N || ld % 8 || !aligned16(x) || !aligned16(y) || !aligned16(w_q) ||
      !aligned16(w_out) || P < 1 || P > (N + TN - 1) / TN || S < 1 || nw != (C <= 128 ? 2 : 1) ||
      (resident ? slots != 2 * nq : slots < 4) || smem > SMEM_LIMIT ||
      (size_t)smem != out_bf16_smem(C, S, slots, nw))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, ty, twq, two;
  if (!map_x(&tx, x, ld, C, B) || !map_x(&ty, y, ld, C, B) || !map_w(&twq, w_q, C, HD, HD) ||
      !map_w(&two, w_out, HD, C, 64))
    return (int)cudaErrorInvalidValue;
  const OutPlan pl{C, N, S, slots, resident, nw};
#define LA_OUT_LAUNCH(OG, RE, NW) \
  launch_out_og<OG, RE, NW>(tx, ty, twq, two, g_pre, ctx, b_out, g_post, pl, B, P, smem, st)
  if (C <= 64) return LA_OUT_LAUNCH(1, false, 2);
  if (C <= 128) return LA_OUT_LAUNCH(2, false, 2);
  return C <= 256 ? LA_OUT_LAUNCH(4, false, 1) : LA_OUT_LAUNCH(4, true, 1);
#undef LA_OUT_LAUNCH
}

// the largest dynamic shared memory a block may opt in to on this device
int max_smem(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return v;
}

int reduce_records(const float* part, size_t rec, size_t off, int P, int M, int S, float* out,
           cudaStream_t st) {
  la_reduce_kernel<<<dim3((M + THREADS - 1) / THREADS, S), THREADS, 0, st>>>(part, rec, off, P,
                                                                           M, out);
  return (int)cudaGetLastError();
}

template <bool ACC, bool LNT>
int launch_bwd_q_tma(const CUtensorMap (&m)[5], const float* g_pre, const float* ctx,
                     const float* b_out, const float* g_post, float* part, const BwdPlan& pl, int B,
                     int P, int smem, cudaStream_t st) {
  int err = set_smem(la_bwd_q_kernel<ACC, LNT>, smem);
  if (err) return err;
  la_bwd_q_kernel<ACC, LNT><<<dim3(P, B), BW_THREADS, smem, st>>>(m[0], m[1], m[2], m[3], m[4], g_pre,
                                                                  ctx, b_out, g_post, part, pl);
  return (int)cudaGetLastError();
}

// Pass B' and the fold of its records.  The plan (P, S, slots, resident,
// flush, smem) is the wrapper's la_bwd_plan; it is checked here against what
// the body needs (the f32 body takes P, flush and smem only).
int launch_bwd_q(const void* x, const void* dy, int x_bf16, int ld, const float* g_pre,
                 const bf16* w_q, const float* ctx, const bf16* w_out, const float* b_out,
                 const float* g_post, void* dxq, float* part, float* out_w, float* dctx, int B,
                 int C, int N, int P, int S, int slots, int resident, int flush, int ln_tile,
                 int smem, int device, cudaStream_t st) {
  int err;
  if (!x_bf16) {
    const bool acc = flush == 0;
    if (ld != N || P < 1 || P > (N + T - 1) / T || (size_t)smem != bwdq_smem(C, acc) ||
        smem > max_smem(device))
      return (int)cudaErrorInvalidValue;
    err = set_smem(la_bwd_q_f32_kernel<float>, smem);
    if (err) return err;
    la_bwd_q_f32_kernel<float><<<dim3(P, B), THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), g_pre, w_q, ctx, w_out, b_out,
        g_post, static_cast<float*>(dxq), part, acc, C, N);
    err = (int)cudaGetLastError();
  } else {
    const int nq = (C + 63) / 64;
    if (ld < N || ld % 8 || !aligned16(x) || !aligned16(dy) || !aligned16(dxq) || !aligned16(w_q) ||
        !aligned16(w_out) || P < 1 || P > (N + TN - 1) / TN || S < 1 ||
        (resident ? slots != 2 * nq : slots < 2) || flush < 0 || flush > 1 || ln_tile < 0 ||
        ln_tile > 1 || (flush == 0 && !ln_tile) || smem > SMEM_LIMIT ||
        (size_t)smem != bwdq_bf16_smem(C, S, slots, flush == 0, ln_tile))
      return (int)cudaErrorInvalidValue;
    CUtensorMap m[5];
    if (!map_x(&m[0], x, ld, C, B) || !map_x(&m[1], dy, ld, C, B) || !map_x(&m[2], dxq, ld, C, B) ||
        !map_w(&m[3], w_q, C, HD, HD) || !map_w(&m[4], w_out, HD, C, 64))
      return (int)cudaErrorInvalidValue;
    const BwdPlan pl{C, N, S, slots, resident};
#define LA_BWD_Q(ACC, LNT) \
  launch_bwd_q_tma<ACC, LNT>(m, g_pre, ctx, b_out, g_post, part, pl, B, P, smem, st)
    err = flush == 0 ? LA_BWD_Q(true, true) : ln_tile ? LA_BWD_Q(false, true) : LA_BWD_Q(false, false);
#undef LA_BWD_Q
  }
  if (err) return err;
  const size_t rec = bwdq_record(C), mw = (size_t)2 * C * HD + 3 * C;
  err = reduce_records(part, rec, 0, B * P, (int)mw, 1, out_w, st);
  if (err) return err;
  return reduce_records(part, rec, mw, P, NH * DH * DH, B, dctx, st);
}

template <bool ACC, bool LNT>
int launch_bwd_kv2_tma(const CUtensorMap (&mp)[4], const float* g_pre, const float* m,
                       const float* s, const float* dctx, const float* sdot, float* part,
                       const BwdPlan& pl, int B, int P, int smem, cudaStream_t st) {
  int err = set_smem(la_bwd_kv2_kernel<ACC, LNT>, smem);
  if (err) return err;
  la_bwd_kv2_kernel<ACC, LNT><<<dim3(P, B), BW_THREADS, smem, st>>>(mp[0], mp[1], mp[2], mp[3], g_pre, m,
                                                                    s, dctx, sdot, part, pl);
  return (int)cudaGetLastError();
}

// Pass A'2 and the fold of its records; the plan as for pass B'.
int launch_bwd_kv2(const void* x, int x_bf16, int ld, const float* g_pre, const bf16* w_kv,
                   const float* m, const float* s, const float* dctx, const float* sdot,
                   const void* dxq, void* dx, float* part, float* out_w, int B, int C, int N,
                   int P, int S, int slots, int resident, int flush, int ln_tile, int smem,
                   int device, cudaStream_t st) {
  int err;
  if (!x_bf16) {
    const bool acc = flush == 0;
    if (ld != N || P < 1 || P > (N + T - 1) / T || (size_t)smem != kv2_smem(C, acc) ||
        smem > max_smem(device))
      return (int)cudaErrorInvalidValue;
    err = set_smem(la_bwd_kv2_f32_kernel<float>, smem);
    if (err) return err;
    la_bwd_kv2_f32_kernel<float><<<dim3(P, B), THREADS, smem, st>>>(
        static_cast<const float*>(x), g_pre, w_kv, m, s, dctx, sdot, static_cast<const float*>(dxq),
        static_cast<float*>(dx), part, acc, C, N);
    err = (int)cudaGetLastError();
  } else {
    const int nq = (C + 63) / 64;
    if (ld < N || ld % 8 || !aligned16(x) || !aligned16(dxq) || !aligned16(dx) || !aligned16(w_kv) ||
        P < 1 || P > (N + TN - 1) / TN || S < 1 || (resident ? slots != 2 * nq : slots < 2) ||
        flush < 0 || flush > 1 || ln_tile < 0 || ln_tile > 1 || (flush == 0 && !ln_tile) ||
        smem > SMEM_LIMIT || (size_t)smem != kv2_bf16_smem(C, S, slots, flush == 0, ln_tile))
      return (int)cudaErrorInvalidValue;
    CUtensorMap mp[4];
    if (!map_x(&mp[0], x, ld, C, B) || !map_x(&mp[1], dxq, ld, C, B) || !map_x(&mp[2], dx, ld, C, B) ||
        !map_w(&mp[3], w_kv, C, 2 * HD, HD))
      return (int)cudaErrorInvalidValue;
    const BwdPlan pl{C, N, S, slots, resident};
#define LA_BWD_KV2(ACC, LNT) \
  launch_bwd_kv2_tma<ACC, LNT>(mp, g_pre, m, s, dctx, sdot, part, pl, B, P, smem, st)
    err = flush == 0 ? LA_BWD_KV2(true, true)
                     : ln_tile ? LA_BWD_KV2(false, true) : LA_BWD_KV2(false, false);
#undef LA_BWD_KV2
  }
  if (err) return err;
  return reduce_records(part, kv2_record(C), 0, B * P, (int)kv2_record(C), 1, out_w, st);
}

// rows channels of qkv (or of an output) from p, as (n, rows, B) in TX with
// row stride ld and batch stride bstride (elements), [box_rows][128 bytes]
// boxes under the 128-byte swizzle; zero past n (loads), dropped (stores)
template <typename TX>
bool map_rows(CUtensorMap* map, const void* p, int n, int ld, int rows, long long bstride, int B,
              int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(TX), (cuuint64_t)bstride * sizeof(TX)};
  const cuuint32_t box[3] = {(cuuint32_t)(MID_ROW / sizeof(TX)), (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, sizeof(TX) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            3, const_cast<void*>(p), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A kernel's shared-memory limit, raised to the most a CTA may have once per
// kernel and device (the CUDA call would otherwise cost every launch).
template <auto K>
int smem_once(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit && (done.load() & bit)) return 0;
  const int err = set_smem(K, SMEM_LIMIT);
  if (err == 0) done.fetch_or(bit);
  return err;
}

// Pass A of the unfused middle and its combine.  P, the CTAs per batch
// element, is the wrapper's mid_plan (1 <= P <= tiles).
template <typename TX>
int launch_mid_ctx(const void* kv, int ld, long long bstride, float* part, float* ctx, int B,
                   int N, int P, int device, cudaStream_t st) {
  const int q = 16 / sizeof(TX), tn = MID_ROW / sizeof(TX);
  if (B < 1 || B > 65535 || N < 1 || ld < N || ld % q || bstride % q || bstride < 2LL * HD * ld ||
      !aligned16(kv) || P < 1 || P > (N + tn - 1) / tn)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tkv;
  if (!map_rows<TX>(&tkv, kv, ld, ld, 2 * HD, bstride, B, 2 * HD)) return (int)cudaErrorInvalidValue;
  int err = smem_once<la_mid_ctx_kernel<TX>>(device);
  if (err) return err;
  la_mid_ctx_kernel<TX><<<dim3(P, B), MID_THREADS, MID_SMEM, st>>>(tkv, part, N);
  err = (int)cudaGetLastError();
  return err ? err : combine(part, P, ctx, nullptr, nullptr, B, st);
}

// Pass B of the unfused middle.  P, the CTAs per batch element, is the
// wrapper's mid_out_plan (1 <= P <= tiles).
template <typename TX>
int launch_mid_out(const void* q, int ld, long long bstride, const float* ctx, void* out, int ldo,
                   int B, int N, int P, int device, cudaStream_t st) {
  const int qn = 16 / sizeof(TX), tn = MID_ROW / sizeof(TX);
  if (B < 1 || B > 65535 || N < 1 || ld < N || ld % qn || bstride % qn ||
      bstride < (long long)HD * ld || ldo < N || ldo % qn || !aligned16(q) || !aligned16(out) ||
      P < 1 || P > (N + tn - 1) / tn)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tout;
  if (!map_rows<TX>(&tq, q, N, ld, HD, bstride, B, HD) ||
      !map_rows<TX>(&tout, out, N, ldo, HD, (long long)HD * ldo, B, DH))
    return (int)cudaErrorInvalidValue;
  int err = smem_once<la_mid_out_kernel<TX>>(device);
  if (err) return err;
  la_mid_out_kernel<TX><<<dim3(P, B), MO_THREADS, MO_SMEM, st>>>(tq, tout, ctx, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launchers return a cudaError_t (0 = launched).  x_bf16 selects the
// dtype of x (and y): 1 = bfloat16, 0 = float32.  Weights are bf16, row-major
// in the torch layout: w_kv = W_qkv[HD:3HD] (2HD, C), w_q = W_qkv[:HD]
// (HD, C), w_out (C, HD).  Gains and bias are f32 (C,).  x (and y) are
// (B, C, ld) with ld >= N (bf16: ld a multiple of 8 and 16-byte aligned
// tensors, the tensor maps' needs; f32: ld = N); positions past N are
// ignored and their y is unspecified.  The rest of the arguments are the
// plan of ops/attention_fused.py::la_plan: P CTAs per batch element, S x
// stages, slots weight chunk slots, resident weights or streamed, nw
// consumer warp groups, smem bytes (the f32 bodies take P and smem only).
// Pass A: part (B, P, PART) f32 scratch; ctx (B, NH, DH, DH), m, s (B, HD).
int ofd_la_ctx(const void* x, int x_bf16, int ld, const float* g_pre, const void* w_kv,
               float* part, float* ctx, float* m, float* s, int B, int C, int N, int P, int S,
               int slots, int resident, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_ctx(x, x_bf16, ld, g_pre, static_cast<const bf16*>(w_kv), part, ctx, m, s, B, C,
                    N, P, S, slots, resident, smem, static_cast<cudaStream_t>(stream));
}

int ofd_la_out(const void* x, int x_bf16, int ld, const float* g_pre, const void* w_q,
               const float* ctx, const void* w_out, const float* b_out, const float* g_post,
               void* y, int B, int C, int N, int P, int S, int slots, int resident, int nw,
               int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_out(x, x_bf16, ld, g_pre, static_cast<const bf16*>(w_q), ctx,
                    static_cast<const bf16*>(w_out), b_out, g_post, y, B, C, N, P, S, slots,
                    resident, nw, smem, static_cast<cudaStream_t>(stream));
}

// The backward launchers.  Each runs its pass over grid (P, B) and then sums
// the per-CTA records in a fixed order.  Scratch part: (B * P, record) f32
// with record = ofd_la_bwd_record(pass, C) (pass 0: B', 1: A'2); pass A'1
// needs no scratch.
// Passes B' and A'2 take x (and dy, dxq, dx) as (B, C, ld) with ld as for
// the forward, and the rest of their plan from ops/attention_fused.py::
// la_bwd_plan: P, S x stages, slots weight chunks of 16 KB, resident or
// streamed, flush (0: the partials kept in shared memory and written once,
// 1: kept in the record, added to every tile), ln_tile (the normalised
// tile in shared memory), smem bytes; the f32 bodies take P, flush and smem.
// Outputs are f32 unless they are dx: out_w of B' is dW_out (C, HD) | dW_q
// (HD, C) | db_out | dg_pre | dg_post, with dctx (B, NH, DH, DH); A'1 gives
// sdot (B, HD) from ctx and dctx; out_w of A'2 is dW_kv (2HD, C) | dg_pre.  dxq (B' output,
// with the residual dy) and dx = dxq + dx_kv (A'2 output) are in x's dtype.
long long ofd_la_bwd_record(int pass, int C) {
  return pass == 0 ? (long long)bwdq_record(C) : (long long)kv2_record(C);
}

int ofd_la_bwd_q(const void* x, const void* dy, int x_bf16, int ld, const float* g_pre,
                 const void* w_q, const float* ctx, const void* w_out, const float* b_out,
                 const float* g_post, void* dxq, float* part, float* out_w, float* dctx, int B,
                 int C, int N, int P, int S, int slots, int resident, int flush, int ln_tile,
                 int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_bwd_q(x, dy, x_bf16, ld, g_pre, static_cast<const bf16*>(w_q), ctx,
                      static_cast<const bf16*>(w_out), b_out, g_post, dxq, part, out_w, dctx, B, C,
                      N, P, S, slots, resident, flush, ln_tile, smem, device,
                      static_cast<cudaStream_t>(stream));
}

// Pass A'1: sdot (B, HD) = sum_e ctx * dctx / N per (b, h, d) row; ctx
// (pass A's) and dctx (pass B''s) are (B, NH, DH, DH) float32, contiguous.
int ofd_la_bwd_kv1(const float* ctx, const float* dctx, float* sdot, int B, int N, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int rows = B * HD;
  la_bwd_sdot_kernel<<<(rows + WARPS - 1) / WARPS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(ctx, dctx, sdot, rows, (float)N);
  return (int)cudaGetLastError();
}

// One launch of an empty kernel (the launch floor; measurement only).
int ofd_la_empty(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  la_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

int ofd_la_bwd_kv2(const void* x, int x_bf16, int ld, const float* g_pre, const void* w_kv,
                   const float* m, const float* s, const float* dctx, const float* sdot,
                   const void* dxq, void* dx, float* part, float* out_w, int B, int C, int N,
                   int P, int S, int slots, int resident, int flush, int ln_tile, int smem,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_bwd_kv2(x, x_bf16, ld, g_pre, static_cast<const bf16*>(w_kv), m, s, dctx, sdot, dxq,
                        dx, part, out_w, B, C, N, P, S, slots, resident, flush, ln_tile, smem,
                        device, static_cast<cudaStream_t>(stream));
}

// The unfused middle's launchers, qkv_bf16 selecting bf16 (1) or f32 (0).
// Both read rows of qkv (B, 3 HD, .) that are ld >= N long (ld and
// batch_stride in elements, multiples of 16 bytes, the pointer 16-byte
// aligned; positions past N are ignored); P is their CTAs per batch element,
// ops/attention_pallas.py::mid_plan for pass A and mid_out_plan for pass B.
// Pass A: kv points at the k rows
// (channel HD); part (B, P, PART) f32 scratch; ctx (B, NH, DH, DH) f32.
// Pass B: q points at the q rows (channel 0); out (B, HD, ldo) in qkv's
// dtype, ldo >= N a multiple of 16 bytes (positions past N are not written).
int ofd_la_mid_ctx(const void* kv, int qkv_bf16, int ld, long long batch_stride, float* part,
                   float* ctx, int B, int N, int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return qkv_bf16
             ? launch_mid_ctx<bf16>(kv, ld, batch_stride, part, ctx, B, N, P, device, st)
             : launch_mid_ctx<float>(kv, ld, batch_stride, part, ctx, B, N, P, device, st);
}

int ofd_la_mid_out(const void* q, int qkv_bf16, int ld, long long batch_stride, const float* ctx,
                   void* out, int ldo, int B, int N, int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return qkv_bf16
             ? launch_mid_out<bf16>(q, ld, batch_stride, ctx, out, ldo, B, N, P, device, st)
             : launch_mid_out<float>(q, ld, batch_stride, ctx, out, ldo, B, N, P, device, st);
}

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
