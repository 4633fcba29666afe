// Flash (online-softmax) attention for the UNet bottleneck, for Hopper (sm_90a).
//
//   out = softmax(q k^T) v      over (B, heads, N, d = 32), q pre-scaled
//
// Replaces the Pallas TPU kernel opticalflowdiffusion_tpu/ops/flash_attention.py
// ::_flash_kernel (pallas_call in _flash_middle_pallas), which carries the
// running max m, normaliser l and accumulator acc in VMEM scratch across a
// sequential grid axis over key blocks.  Here one CTA owns a tile of queries
// of one (batch, head) and walks all key tiles itself, with m, l and acc in
// registers; nothing of size N^2 reaches device memory.
//
// Layout: q, k and v are (B, heads, d, N) with N fastest, which is how the
// UNet's to_qkv output lies; each tensor has its own batch stride (k and v
// are read inside the packed (B, 3, heads, d, N) tensor).  The output is a
// contiguous (B, heads, d, N) tensor.
//
// Numerics follow the TPU kernel: scores accumulate in f32, keys past N get
// -1e30 (not -inf), p = exp(s - m) in f32 is summed into l in f32 and cast to
// the operand dtype before p @ v (f32 accumulation), and acc / l is taken at
// the end and cast once.
//
// bf16 (the flagship): 4 warps, 16 query rows each (64 per CTA); key tiles of
// 64 go through shared memory as [d][key] bf16 tiles.  Tensor cores through
// mma.sync m16n8k16 (bf16 in, f32 accumulate); the operand fragments come from
// ldmatrix (.trans for q and k, whose d axis is the slow one).  The score
// accumulators are turned into the A operand of p @ v in registers.
// f32 (precision fp32): one query row per thread on CUDA cores, key tiles of
// 64 in shared memory.
//
// Bound on the H100: with d = 32 a key costs 2 x 32 MACs per query on the
// tensor cores but one exponential, so the exponentials (16 per clock per SM
// on the SFU) set the least time, not the 4 B h N^2 d FLOPs.  Bytes are
// small (q, k, v read once, out written once).  No TMA, wgmma or pipelining
// of the tile loads yet; several CTAs per SM hide the load latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 32;          // head dim
constexpr int BQ = 64;         // queries per CTA (bf16 kernel)
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 128;   // 4 warps
constexpr int LDS = BK + 8;    // row pitch of the [d][n] bf16 tiles: 144 B, conflict-free ldmatrix
constexpr int FQ = 128;        // queries per CTA (f32 kernel), one per thread
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(BQ == BK, "one tile loader for q, k and v");

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// dst[r][c] = src[r * N + n0 + c] for the D rows and 64 columns of a tile,
// zero past N.  vec: N, the batch strides and the base pointers allow 16-byte
// loads (then a chunk of 8 columns is wholly inside or outside N).
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int N, int n0,
                                          bf16* dst, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < D * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + c < N)
        val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * N + n0 + c));
      *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < D * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      dst[r * LDS + c] = n0 + c < N ? src[(size_t)r * N + n0 + c] : __float2bfloat16(0.f);
    }
  }
}

// grid (ceil(N / BQ), B * H), 128 threads.
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, long long sq, long long sk, long long sv,
                  bf16* __restrict__ out, int H, int N, int vec) {
  __shared__ __align__(16) bf16 qs[D * LDS];  // q tile [d][query], then the output tile
  __shared__ __align__(16) bf16 ks[D * LDS];  // [d][key]
  __shared__ __align__(16) bf16 vs[D * LDS];  // [d][key]

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;      // fragment row group, column pair
  const int mi = lane >> 3, r8 = lane & 7;    // ldmatrix: matrix and row this lane addresses
  const size_t head = (size_t)hh * D * N;
  const bf16* qp = q + b * sq + head;
  const bf16* kp = k + b * sk + head;
  const bf16* vp = v + b * sv + head;

  load_tile(qp, N, q0, qs, vec != 0);
  __syncthreads();
  // A fragments of this warp's 16 queries x 32 d, two k-steps of 16 d
  uint32_t qa[2][4];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
    ldsm_x4_t(qa[kc][0], qa[kc][1], qa[kc][2], qa[kc][3],
              qs + (kc * 16 + (mi >> 1) * 8 + r8) * LDS + warp * 16 + (mi & 1) * 8);

  float o[4][4];  // 16 queries x 32 d: 4 n-tiles of 8 d
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = NEG, m1 = NEG;   // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;   // this thread's share of the row sums

  const int ntiles = (N + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * BK;
    __syncthreads();
    load_tile(kp, N, n0, ks, vec != 0);
    load_tile(vp, N, n0, vs, vec != 0);
    __syncthreads();

    // s = q k^T: 16 queries x 64 keys, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3,
                  ks + (kc * 16 + (mi & 1) * 8 + r8) * LDS + np * 16 + (mi >> 1) * 8);
        mma_bf16(s[2 * np], qa[kc], b0, b1);
        mma_bf16(s[2 * np + 1], qa[kc], b2, b3);
      }
    if (n0 + BK > N) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + 8 * j + 2 * c + (e & 1) >= N) s[j][e] = NEG;
    }

    // online softmax; a row's 64 scores lie on the 4 lanes of a quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float a0 = __expf(m0 - mx0), a1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pa[4][4];  // A fragments of p: 4 k-steps of 16 keys
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = __expf(s[j][0] - mx0), p1 = __expf(s[j][1] - mx0);
      const float p2 = __expf(s[j][2] - mx1), p3 = __expf(s[j][3] - mx1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }
    // o += p v: v tile [d][key] gives the col-major B operand without .trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                vs + (dp * 16 + (mi >> 1) * 8 + r8) * LDS + kk * 16 + (mi & 1) * 8);
        mma_bf16(o[2 * dp], pa[kk], b0, b1);
        mma_bf16(o[2 * dp + 1], pa[kk], b2, b3);
      }
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  // stage the output tile as [d][query] in qs (no longer read), then store
  // rows of d with queries contiguous
  const int row = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int dd = i * 8 + 2 * c;
    qs[dd * LDS + row] = __float2bfloat16(o[i][0] / l0);
    qs[(dd + 1) * LDS + row] = __float2bfloat16(o[i][1] / l0);
    qs[dd * LDS + row + 8] = __float2bfloat16(o[i][2] / l1);
    qs[(dd + 1) * LDS + row + 8] = __float2bfloat16(o[i][3] / l1);
  }
  __syncthreads();
  bf16* op = out + (size_t)bh * D * N;
  for (int i = threadIdx.x; i < D * BQ; i += THREADS) {
    const int r = i / BQ, cc = i % BQ;
    if (q0 + cc < N) op[(size_t)r * N + q0 + cc] = qs[r * LDS + cc];
  }
}

// grid (ceil(N / FQ), B * H), FQ threads: one query row per thread.
__global__ void __launch_bounds__(FQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, long long sq, long long sk, long long sv,
                 float* __restrict__ out, int H, int N) {
  __shared__ float ks[D][BK];
  __shared__ float vs[D][BK];
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int n = blockIdx.x * FQ + threadIdx.x;
  const bool valid = n < N;
  const size_t head = (size_t)hh * D * N;
  const float* qp = q + b * sq + head;
  const float* kp = k + b * sk + head;
  const float* vp = v + b * sv + head;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? qp[(size_t)d * N + n] : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG, l = 0.f;
  const int ntiles = (N + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * BK;
    __syncthreads();
    for (int i = threadIdx.x; i < D * BK; i += FQ) {
      const int r = i / BK, cc = i % BK;
      const bool in = n0 + cc < N;
      ks[r][cc] = in ? kp[(size_t)r * N + n0 + cc] : 0.f;
      vs[r][cc] = in ? vp[(size_t)r * N + n0 + cc] : 0.f;
    }
    __syncthreads();
    float s[BK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], ks[d][j], a);
      s[j] = n0 + j < N ? a : NEG;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - mx);
      ps += s[j];
    }
    l = l * alpha + ps;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a = acc[d] * alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) a = fmaf(s[j], vs[d][j], a);
      acc[d] = a;
    }
    m = mx;
  }
  if (valid) {
    float* op = out + (size_t)bh * D * N;
#pragma unroll
    for (int d = 0; d < D; ++d) op[(size_t)d * N + n] = acc[d] / l;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// q, k, v: (B, H, 32, N) with the last three axes contiguous and batch
// strides sq, sk, sv (elements); out: contiguous (B, H, 32, N).  is_bf16
// selects bf16 (1) or f32 (0) for all four.  Returns a cudaError_t (0 = launched).
int ofd_flash(const void* q, const void* k, const void* v, long long sq, long long sk,
              long long sv, void* out, int is_bf16, int B, int H, int N, int device,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int vec = N % 8 == 0 && sq % 8 == 0 && sk % 8 == 0 && sv % 8 == 0 &&
                    aligned16(q) && aligned16(k) && aligned16(v);
    flash_bf16_kernel<<<dim3((N + BQ - 1) / BQ, B * H), THREADS, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), sq, sk, sv, static_cast<bf16*>(out), H, N, vec);
  } else {
    flash_f32_kernel<<<dim3((N + FQ - 1) / FQ, B * H), FQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), sq, sk, sv, static_cast<float*>(out), H, N);
  }
  return (int)cudaGetLastError();
}

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
