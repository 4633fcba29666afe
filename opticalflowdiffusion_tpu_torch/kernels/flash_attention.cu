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
// Bound on the H100: with d = 32 a key costs 2 x 32 MACs per query on the
// tensor cores but one exponential, so the exponentials (16 per clock per SM
// on the SFU: 0.098 ms at the native b2 bottleneck) set the least time, not
// the 4 B h N^2 d FLOPs; bytes are small (q, k, v read once, out written once).
//
// bf16 (the flagship), a warp-specialised pipeline:
// - CTA = 3 warp groups, 128 queries of one (batch, head).  Warp group 0 is
//   the producer: one thread issues TMA loads (cp.async.bulk.tensor, 3-d
//   tensor maps over q, k and v with their own batch strides, 128-byte
//   swizzle) of the two [d][64 query] q boxes once and of the [d][64 key] k
//   and v tiles into a ring of STAGES stages, each with a full mbarrier
//   (transaction bytes) and an empty one (one arrival per consumer warp).
//   Warp groups 1 and 2 are consumers, 64 queries each; setmaxnreg moves the
//   producer's registers to them (24 / 104 of the 80 a thread is launched
//   with), and two CTAs fit on an SM, so four consumer warp groups share its
//   SFU: one's exponentials run while another's wgmmas do.
// - S = q k^T: two wgmma m64n64k16 (k = d) with both operands MN-major in
//   shared memory (the [d][query] and [d][key] boxes, transpose bits set), so
//   nothing is transposed by hand.  O += P V: four wgmma m64n32k16 with P
//   from registers (the S accumulator's layout is the A fragment's, so p is
//   packed to bf16 in place) and V K-major from its [d][key] box.
// - One exponential per score: p = ex2(s log2e - m log2e), one FFMA and one
//   ex2.approx.  Keys past N (TMA zero-fills them) are set to -1e30 first.
// - A stage is released one tile late, after the wait on the next S, when
//   the P V wgmma that read its v tile has completed.
// - Ragged N: the tensor maps need rows and batch strides of 16 bytes and
//   16-byte aligned bases; the wrapper copies other inputs once into a
//   zero-padded buffer of row length ld (the kernel still masks keys past N
//   and writes only the N queries).
// - Grid: one CTA per 128 queries and (batch, head), 448 at the native b2
//   bottleneck for 2 x 132 resident CTAs (1.7 waves); a persistent grid
//   would keep the same tail, since every CTA does the same work.
// Measured (chip_smoke.py, CUDA events, warm L2; NVIDIA H100 80GB HBM3,
// 700.00 W): 0.218 ms at (2, 7168, 4, 32), 45% of the bound, against 0.273
// ms for one scaled_dot_product_attention call; 0.727 ms at (8, 7168).
// f32 (precision fp32): one query row per thread on CUDA cores, key tiles of
// 64 in shared memory.
//
// Tensor maps are encoded with cuTensorMapEncodeTiled, obtained through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 32;            // head dim
constexpr int BQ = 128;          // queries per CTA: 64 per consumer warp group
constexpr int BK = 64;           // keys per tile (and the f32 kernel's key tile)
constexpr int STAGES = 4;        // k/v ring
constexpr int THREADS = 384;     // producer + 2 consumer warp groups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 104;  // setmaxnreg; 2 CTAs per SM
constexpr int BOX = D * 64 * 2;  // one [32][64] bf16 box: 4 KB
constexpr int OPITCH = 64 + 8;   // bf16 row pitch of the staged [d][query] output
constexpr int Q_OFF = 0, K_OFF = 2 * BOX, V_OFF = K_OFF + STAGES * BOX;
constexpr int STG_OFF = V_OFF + STAGES * BOX;
constexpr int BAR_OFF = STG_OFF + 2 * D * OPITCH * 2;
constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
constexpr int FQ = 128;          // queries per CTA (f32 kernel), one per thread
constexpr float NEG = -1e30f;
constexpr float L2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the completion of the barrier's phase of the given parity.  A
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

// mbar_wait by every lane of a warp, which leaves the warp converged: the
// polling loop may let lanes leave it at different times, and the
// .sync.aligned instructions after it (wgmma, shuffles) need all lanes.
__device__ __forceinline__ void mbar_wait_warp(uint32_t bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (bytes, multiples of 16)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
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

// S (64 x 64) = A (64 x 16) B (16 x 64), both MN-major in shared memory
__device__ __forceinline__ void wgmma_s(float (&d)[32], uint64_t da, uint64_t db,
                                        uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
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

// O (64 x 32) += P (64 x 16, registers) V (16 x 32, K-major in shared memory)
__device__ __forceinline__ void wgmma_o(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid (ceil(N / BQ), B * H), THREADS threads, SMEM bytes of dynamic shared
// memory; the tensor maps cover q, k, v as (ld, H * 32, B) with [64][32]
// boxes.
__global__ void __launch_bounds__(THREADS, 2)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int H, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sb = smem_u32(smem);
  const uint32_t full0 = sb + BAR_OFF, empty0 = full0 + 8 * STAGES, qbar = empty0 + 8 * STAGES;
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (N + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warp group, warp-uniform as the compiler sees it (setmaxnreg needs
  // the roles' branches to be)
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, 2 * BOX);
      tma_load_3d(sb + Q_OFF, &tq, qbar, q0, hh * D, b);
      tma_load_3d(sb + Q_OFF + BOX, &tq, qbar, q0 + 64, hh * D, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES, k = t / STAGES;
        if (k > 0) mbar_wait(empty0 + 8 * st, (k - 1) & 1);
        mbar_expect_tx(full0 + 8 * st, 2 * BOX);
        tma_load_3d(sb + K_OFF + st * BOX, &tk, full0 + 8 * st, t * BK, hh * D, b);
        tma_load_3d(sb + V_OFF + st * BOX, &tv, full0 + 8 * st, t * BK, hh * D, b);
      }
    }
  } else {
    // ---- consumers: warp group cw owns queries q0 + 64 cw .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;  // accumulator row group, column pair
    // q box of this warp group, [d][query]: MN-major A; a k-step of 16 d
    // is 16 rows of 128 B, a group of 8 rows 1024 B
    const uint32_t qa = sb + Q_OFF + cw * BOX;
    float o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.f;
    float m0 = NEG, m1 = NEG;  // running max of rows g and g + 8
    float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums
    mbar_wait_warp(qbar, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES;
      mbar_wait_warp(full0 + 8 * st, (t / STAGES) & 1);
      const uint32_t ka = sb + K_OFF + st * BOX, va = sb + V_OFF + st * BOX;
      float s[32];
      wgmma_fence();
      wgmma_s(s, desc_sw128(qa, BOX, 1024), desc_sw128(ka, BOX, 1024), 0);
      wgmma_s(s, desc_sw128(qa + 2048, BOX, 1024), desc_sw128(ka + 2048, BOX, 1024), 1);
      wgmma_commit();
      wgmma_wait0();  // this S, and the previous tile's P V
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(s[i]);
#pragma unroll
      for (int i = 0; i < 16; ++i) reg_fence(o[i]);
      if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((t - 1) % STAGES));

      const int n0 = t * BK;
      if (n0 + BK > N) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n0 + 8 * j + 2 * c + (e & 1) >= N) s[4 * j + e] = NEG;
      }
      // online softmax; a row's 64 scores lie on the 4 lanes of a quad
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float ms0 = mx0 * L2E, ms1 = mx1 * L2E;
      const float a0 = ex2(fmaf(m0, L2E, -ms0)), a1 = ex2(fmaf(m1, L2E, -ms1));
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
      uint32_t pa[4][4];  // A fragments of p: 4 k-steps of 16 keys
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = ex2(fmaf(s[4 * j], L2E, -ms0));
        const float p1 = ex2(fmaf(s[4 * j + 1], L2E, -ms0));
        const float p2 = ex2(fmaf(s[4 * j + 2], L2E, -ms1));
        const float p3 = ex2(fmaf(s[4 * j + 3], L2E, -ms1));
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      // o += p v; the v box [d][key] is K-major: a k-step of 16 keys is 32 B
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_o(o, pa[kk], desc_sw128(va + 32 * kk, 16, 1024), 1);
      wgmma_commit();
    }
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 16; ++i) reg_fence(o[i]);

    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    // stage the warp group's output as [d][query], then store rows of d
    // with queries contiguous
    bf16* os = reinterpret_cast<bf16*>(smem + STG_OFF) + cw * D * OPITCH;
    const int row = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = j * 8 + 2 * c;
      os[dd * OPITCH + row] = __float2bfloat16(o[4 * j] / l0);
      os[(dd + 1) * OPITCH + row] = __float2bfloat16(o[4 * j + 1] / l0);
      os[dd * OPITCH + row + 8] = __float2bfloat16(o[4 * j + 2] / l1);
      os[(dd + 1) * OPITCH + row + 8] = __float2bfloat16(o[4 * j + 3] / l1);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    const int qb = q0 + cw * 64;
    bf16* op = out + (size_t)bh * D * N;
    const bool vec = (N % 8) == 0;
    for (int i = tid; i < D * 8; i += 128) {
      const int r = i >> 3, cc = (i & 7) * 8;
      const int n = qb + cc;
      if (n >= N) continue;
      if (vec) {
        *reinterpret_cast<uint4*>(op + (size_t)r * N + n) =
            *reinterpret_cast<const uint4*>(os + r * OPITCH + cc);
      } else {
        for (int e = 0; e < 8 && n + e < N; ++e)
          op[(size_t)r * N + n + e] = os[r * OPITCH + cc + e];
      }
    }
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

// (ld, H * 32, B) bf16 with row stride ld and batch stride sbatch (elements),
// [64 keys][32 d] boxes with the 128-byte swizzle; out-of-range keys read 0
bool make_map(CUtensorMap* map, const void* base, int B, int H, int ld, long long sbatch) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)H * D, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)sbatch * 2};
  const cuuint32_t box[3] = {64, D, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// q, k, v: (B, H, 32, N) with the last three axes contiguous, rows of ld >= N
// elements, and batch strides sq, sk, sv (elements); out: contiguous
// (B, H, 32, N).  is_bf16 selects bf16 (1) or f32 (0) for all four.  bf16
// needs ld, sq, sk and sv multiples of 8 and 16-byte aligned q, k, v (the
// tensor maps); f32 needs ld = N.  Returns a cudaError_t (0 = launched).
int ofd_flash(const void* q, const void* k, const void* v, long long sq, long long sk,
              long long sv, void* out, int is_bf16, int B, int H, int N, int ld, int device,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (ld < N || ld % 8 != 0 || sq % 8 != 0 || sk % 8 != 0 || sv % 8 != 0 || !aligned16(q) ||
        !aligned16(k) || !aligned16(v))
      return (int)cudaErrorInvalidValue;
    // setmaxnreg hands registers between the warp groups of one CTA: the
    // counts after it must fit in what the CTA was launched with
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, flash_bf16_kernel);
    if (err != cudaSuccess) return (int)err;
    if (fa.numRegs * THREADS < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS)
      return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(flash_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap tq, tk, tv;
    if (!make_map(&tq, q, B, H, ld, sq) || !make_map(&tk, k, B, H, ld, sk) ||
        !make_map(&tv, v, B, H, ld, sv))
      return (int)cudaErrorInvalidValue;
    flash_bf16_kernel<<<dim3((N + BQ - 1) / BQ, B * H), THREADS, SMEM, st>>>(
        tq, tk, tv, static_cast<bf16*>(out), H, N);
  } else {
    if (ld != N) return (int)cudaErrorInvalidValue;
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
