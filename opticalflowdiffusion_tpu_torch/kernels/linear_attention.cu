// Fused pre-LN linear-attention block, forward, for Hopper (sm_90a).
//
//   y = x + postLN(W_out @ middle(W_qkv @ preLN(x)) + b_out)
//
// on x of shape (B, C, N) (a flattened NCHW map), heads * dim_head = 4 * 32.
// Replaces the two Pallas TPU kernels of the JAX package's
// ops/attention_fused.py::_fused_block_pallas:
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
  __shared__ int is_last;

  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int tid = threadIdx.x;
  const int ntiles = (N + T - 1) / T;
  // this thread's context entries: head h, k-channel row d, v columns e0..e0+15
  const int h = tid / 64, d = (tid % 64) / 2, e0 = (tid % 2) * 16;
  const int kj = h * DH + d;
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
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
    for (int t = 0; t < nvalid; ++t) {
      const float ek = kvS[t * LDK + kj];
      const float* vrow = kvS + t * LDK + HD + h * DH + e0;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += ek * vrow[i];
    }
    __syncthreads();
  }

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

  // combine the P partials of batch element b
  const float* base = part + (size_t)b * P * PART;
  if (tid < HD) {
    float m = -INFINITY;
    for (int q = 0; q < P; ++q) m = fmaxf(m, __ldcg(base + q * PART + tid));
    float s = 0.f;
    for (int q = 0; q < P; ++q)
      s += __ldcg(base + q * PART + HD + tid) * expf(__ldcg(base + q * PART + tid) - m);
    m_out[b * HD + tid] = m;
    s_out[b * HD + tid] = s;
    chS[tid] = m;
    red[tid] = s;
  }
  __syncthreads();
  const float m = chS[kj], s = red[kj];
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

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
