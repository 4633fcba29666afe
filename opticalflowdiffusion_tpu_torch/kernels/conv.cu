// Stride-1 'same' convolution with an odd kernel, NCHW in and out, for
// Hopper (sm_90a): an implicit GEMM on the tensor cores.
//
//   out[b, n, y, x] = sum_{c, dy, dx} z[b, c, y + dy - kh/2, x + dx - kw/2] * w[n, c, dy, dx]
//
// with z = x, or, with the fold entry's prologue on, z = silu(x * a[b, c] + b[b, c])
// (f32, rounded to the compute dtype), and z = 0 outside the image: the zero
// padding is zero after the transform, not silu(b).
//
// Replaces two Pallas TPU kernels of opticalflowdiffusion_tpu/ops/conv_pallas.py:
//   ofd_conv_rows: _kernel (pallas_call in _conv_pallas), row slabs with halos;
//   ofd_conv_fold: _fold_kernel (pallas_call in _conv_fold), the width-folded
//                  flat slab with the optional silu(x * a + b) on load.
// Both compute the same function, and here they share one templated body;
// each has its own entry point and launch count.  The TPU mechanics (width
// folding to fill 128 lanes, the flat slab, sublane rotations, the folded
// tap matrices) are not carried over.
//
// Design (bf16, the flagship): GEMM rows M are output pixels, columns N
// output channels, depth K = Cin * kh * kw.  A CTA (8 warps) owns an R x Wt
// rectangle of 128 pixels of one image (Wt = the power of two >= W, 16 to
// 128; R = 128 / Wt, so narrow levels waste no rows) and 64 output channels.
// K is walked in slices of 16 input channels: the CTA loads the slice's
// input patch with its halo ((R + kh - 1) x (Wt + kw - 1) pixels) once,
// straight from NCHW (loads coalesce along W; no layout conversion; each
// thread has the loads of four 8-channel items in flight before it waits
// on any, since the load phase is latency-bound), applies the prologue, and
// stores it pixel-major with 16 channels (32 B) a pixel, the two 16-byte
// halves swapped on every other group of four pixels, so that ldmatrix
// reads the A fragments of any tap shift without bank conflicts.  The
// slice's kh * kw weight tiles [16][64] arrive by cp.async meanwhile.  Then
// each tap is one k16 step: every warp (32 pixels x 32 channels) takes two
// A and two B ldmatrix.x4 and eight mma.sync m16n8k16 (bf16 in, f32
// accumulate).  The stem's 9 input channels are zero-filled to 16.  The
// output tile is staged in shared memory and written as rows of pixels in
// x's dtype.  No atomics: two launches give the same bits.
//
// f32 (precision fp32): the same tiling on CUDA cores with f32 FMA (never
// TF32), 8 input channels a slice, each thread 8 pixels x 4 channels.
//
// Bound on the H100: the operations, 2 B H W Cin Cout kh kw over the bf16
// tensor peak (989 TFLOP/s), against the bytes (x and out once, weights
// once) over 3.35 TB/s; for the UNet's 3x3 convs at Cin >= 64 the two are
// close (a 64 -> 64 conv at 448x1024 b2: 67.6 GFLOP, 0.068 ms, vs ~0.07 ms
// of bytes).  This kernel runs at ~115 TFLOP/s on an H100 at 700 W
// (chip_smoke.py's conv phase): one slice's loads are not overlapped with
// the previous slice's products (CTAs on the same SM overlap each
// other's); wgmma, TMA and a pipelined schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;          // 8 warps
constexpr int BM = 128;               // output pixels per CTA
constexpr int BN = 64;                // output channels per CTA
constexpr int CB = 16;                // input channels per K slice (bf16)
constexpr int FCB = 8;                // input channels per K slice (f32)
constexpr int BPITCH = BN + 8;        // bf16 row pitch of a weight tile: 144 B
constexpr int OPITCH = BM + 8;        // bf16 row pitch of the staged output tile
constexpr int PF = 4;                 // patch items a thread loads before it stores any
constexpr int MAX_SMEM = 227 * 1024;  // dynamic shared memory a block may use

struct Geo {
  int B, Cin, H, W, Cout, kh, kw, cin_pad, cout_pad;
  int R, Wt, tiles_x, tiles_y;        // tile rows and columns, tiles per image along x, y
  int PH, PW;                         // patch rows and columns: R + kh - 1, Wt + kw - 1
};

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// 16 bytes global -> shared, asynchronous (L2 only), and the wait for all
// of this thread's copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ unsigned short float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The prologue's activation: u = x * a + b rounded after the product and
// after the sum (no FMA), as the plain version computes it, then
// u / (1 + e^-u): exactly as there for f32; for bf16 with the fast
// exponential and division, whose error (~1e-6 relative) is far below the
// rounding of z to bf16.
__device__ __forceinline__ float silu(float u) { return u / (1.f + expf(-u)); }
__device__ __forceinline__ float silu_fast(float u) { return __fdividef(u, 1.f + __expf(-u)); }

// Copies this image's prologue vectors a[b, :Cin], b[b, :Cin] to shared
// memory (read by the patch loads after the next barrier).
__device__ __forceinline__ void stage_affine(const float* __restrict__ sa,
                                             const float* __restrict__ sb, int b, int Cin,
                                             float* aff) {
  for (int c = threadIdx.x; c < Cin; c += blockDim.x) {
    aff[c] = __ldg(sa + b * Cin + c);
    aff[Cin + c] = __ldg(sb + b * Cin + c);
  }
}

// The tile of CTA blockIdx.x: image b, first output row y0 and column x0.
__device__ __forceinline__ void tile_origin(const Geo& g, int& b, int& y0, int& x0) {
  int t = blockIdx.x;
  const int tx = t % g.tiles_x;
  t /= g.tiles_x;
  const int ty = t % g.tiles_y;
  b = t / g.tiles_y;
  y0 = ty * g.R;
  x0 = tx * g.Wt;
}

// grid (B * tiles_y * tiles_x, cout_pad / BN), THREADS threads; dynamic
// shared memory: max(patch + weight tiles, staged output).
template <bool AFFINE>
__global__ void __launch_bounds__(THREADS, 2)
conv_bf16_kernel(const unsigned short* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ sa, const float* __restrict__ sb,
                 bf16* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KK = g.kh * g.kw;
  const int npix = g.PH * g.PW;
  unsigned char* patch = smem;                               // [PH * PW][2][8] bf16
  bf16* ws = reinterpret_cast<bf16*>(smem + npix * 32);      // [KK * CB][BPITCH]
  float* aff = reinterpret_cast<float*>(ws + KK * CB * BPITCH);  // a[:Cin], b[:Cin]

  int b, y0, x0;
  tile_origin(g, b, y0, x0);
  if (AFFINE) stage_affine(sa, sb, b, g.Cin, aff);
  const int n0 = blockIdx.y * BN;
  const int ph = g.kh / 2, pw = g.kw / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;        // 4 x 32 pixels, 2 x 32 channels
  const int mi = lane >> 3, r8 = lane & 7;        // ldmatrix: matrix and row of this lane
  const size_t HW = (size_t)g.H * g.W;
  const unsigned short* xb = x + (size_t)b * g.Cin * HW;

  // the patch pixel (row, column) at tap (0, 0) of the A row this lane
  // addresses, for the warp's two m16 tiles; its 16-byte half is mi >> 1
  int a_row[2], a_col[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = wm * 32 + mt * 16 + (mi & 1) * 8 + r8;
    a_row[mt] = m / g.Wt;
    a_col[mt] = m % g.Wt;
  }
  const int a_half = mi >> 1;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c0 = 0; c0 < g.cin_pad; c0 += CB) {
    __syncthreads();
    // the slice's weight tiles, [tap][16 channels][64 outputs], copied
    // asynchronously while the patch loads
    for (int i = threadIdx.x; i < KK * CB * (BN / 8); i += THREADS) {
      const int kr = i / (BN / 8), v = i % (BN / 8);
      const int t = kr / CB, k = kr % CB;
      cp_async16(ws + kr * BPITCH + v * 8,
                 w + ((size_t)(t * g.cin_pad + c0 + k) * g.cout_pad + n0 + v * 8));
    }
    cp_async_commit();
    // the input patch of channels c0 .. c0 + 15; an item is 8 channels of one
    // pixel, and a thread has the loads of PF items in flight before it uses any
    for (int i0 = 0; i0 < 2 * npix; i0 += PF * THREADS) {
      unsigned short v[PF][8];
      int dst[PF], cb[PF];
      bool in[PF];
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int i = i0 + u * THREADS + threadIdx.x;
        dst[u] = -1;
        cb[u] = 0;
        in[u] = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) v[u][j] = 0;
        if (i < 2 * npix) {
          const int h = i / npix, p = i - h * npix;
          const int py = p / g.PW, px = p - py * g.PW;
          const int iy = y0 + py - ph, ix = x0 + px - pw;
          dst[u] = p * 32 + ((h ^ ((px >> 2) & 1)) << 4);
          cb[u] = c0 + h * 8;
          in[u] = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
          if (in[u]) {
            const unsigned short* src = xb + (size_t)cb[u] * HW + (size_t)iy * g.W + ix;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (cb[u] + j < g.Cin) v[u][j] = __ldg(src + j * HW);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        if (dst[u] < 0) continue;
        if (AFFINE && in[u]) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = cb[u] + j;
            if (c < g.Cin) {
              const float z = __fadd_rn(__fmul_rn(bf16_bits_to_float(v[u][j]), aff[c]),
                                        aff[g.Cin + c]);
              v[u][j] = float_to_bf16_bits(silu_fast(z));
            }
          }
        }
        uint32_t packed[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          packed[j] = static_cast<uint32_t>(v[u][2 * j]) |
                      (static_cast<uint32_t>(v[u][2 * j + 1]) << 16);
        *reinterpret_cast<uint4*>(patch + dst[u]) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    for (int t = 0; t < KK; ++t) {
      const int dy = t / g.kw, dx = t - dy * g.kw;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int px = a_col[mt] + dx;
        const int p = (a_row[mt] + dy) * g.PW + px;
        ldsm_x4(a[mt], patch + p * 32 + ((a_half ^ ((px >> 2) & 1)) << 4));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, ws + (t * CB + (mi & 1) * 8 + r8) * BPITCH + wn * 32 + np * 16 +
                          (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], bb[0], bb[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
        }
      }
    }
  }

  // stage the tile as [channel][pixel] and write rows of pixels
  __syncthreads();
  bf16* os = reinterpret_cast<bf16*>(smem);
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm * 32 + mt * 16 + gq + (e >> 1) * 8;
        const int n = wn * 32 + nt * 8 + 2 * cq + (e & 1);
        os[n * OPITCH + m] = __float2bfloat16_rn(acc[mt][nt][e]);
      }
  __syncthreads();
  const bool vec = (g.W % 8) == 0;
  for (int i = threadIdx.x; i < BN * (BM / 8); i += THREADS) {
    const int n = i / (BM / 8), m = (i % (BM / 8)) * 8;
    const int y = y0 + m / g.Wt, xx = x0 + m % g.Wt;
    if (n0 + n >= g.Cout || y >= g.H || xx >= g.W) continue;
    bf16* dst = out + (((size_t)b * g.Cout + n0 + n) * g.H + y) * g.W + xx;
    if (vec && xx + 8 <= g.W) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(os + n * OPITCH + m);
    } else {
      for (int j = 0; j < 8 && xx + j < g.W; ++j) dst[j] = os[n * OPITCH + m + j];
    }
  }
}

// grid as the bf16 kernel; dynamic shared memory: patch [FCB][PH * PW] and
// weight tiles [KK][FCB][BN], f32.  Thread: pixels mg + 16 i (i < 8) and
// channels 4 ng .. 4 ng + 3.
template <bool AFFINE>
__global__ void __launch_bounds__(THREADS)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ sa, const float* __restrict__ sb,
                float* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KK = g.kh * g.kw;
  const int npix = g.PH * g.PW;
  float* patch = reinterpret_cast<float*>(smem);             // [FCB][npix]
  float* ws = patch + ((FCB * npix + 3) & ~3);               // [KK * FCB][BN]
  float* aff = ws + KK * FCB * BN;                           // a[:Cin], b[:Cin]

  int b, y0, x0;
  tile_origin(g, b, y0, x0);
  if (AFFINE) stage_affine(sa, sb, b, g.Cin, aff);
  const int n0 = blockIdx.y * BN;
  const int ph = g.kh / 2, pw = g.kw / 2;
  const int mg = threadIdx.x & 15, ng = threadIdx.x >> 4;
  const size_t HW = (size_t)g.H * g.W;
  const float* xb = x + (size_t)b * g.Cin * HW;

  int poff[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = mg + 16 * i;
    poff[i] = (m / g.Wt) * g.PW + m % g.Wt;
  }
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < g.cin_pad; c0 += FCB) {
    __syncthreads();
    for (int i = threadIdx.x; i < FCB * npix; i += THREADS) {
      const int k = i / npix, p = i - k * npix;
      const int py = p / g.PW, px = p - py * g.PW;
      const int iy = y0 + py - ph, ix = x0 + px - pw;
      const int c = c0 + k;
      float v = 0.f;
      if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W && c < g.Cin) {
        v = __ldg(xb + c * HW + (size_t)iy * g.W + ix);
        if (AFFINE) {
          v = silu(__fadd_rn(__fmul_rn(v, aff[c]), aff[g.Cin + c]));
        }
      }
      patch[i] = v;
    }
    for (int i = threadIdx.x; i < KK * FCB * (BN / 4); i += THREADS) {
      const int kr = i / (BN / 4), v = i % (BN / 4);
      const int t = kr / FCB, k = kr % FCB;
      *reinterpret_cast<float4*>(ws + kr * BN + v * 4) = __ldg(reinterpret_cast<const float4*>(
          w + ((size_t)(t * g.cin_pad + c0 + k) * g.cout_pad + n0 + v * 4)));
    }
    __syncthreads();
    for (int k = 0; k < FCB; ++k) {
      const float* pk = patch + k * npix;
      for (int t = 0; t < KK; ++t) {
        const int dy = t / g.kw, dx = t - dy * g.kw;
        const int shift = dy * g.PW + dx;
        const float4 wv = *reinterpret_cast<const float4*>(ws + (t * FCB + k) * BN + ng * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pv = pk[poff[i] + shift];
          acc[i][0] = fmaf(pv, wv.x, acc[i][0]);
          acc[i][1] = fmaf(pv, wv.y, acc[i][1]);
          acc[i][2] = fmaf(pv, wv.z, acc[i][2]);
          acc[i][3] = fmaf(pv, wv.w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = mg + 16 * i;
    const int y = y0 + m / g.Wt, xx = x0 + m % g.Wt;
    if (y >= g.H || xx >= g.W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ng * 4 + j;
      if (n < g.Cout) out[(((size_t)b * g.Cout + n) * g.H + y) * g.W + xx] = acc[i][j];
    }
  }
}

// Lets ``kernel`` take ``smem`` bytes of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int conv(const void* x, const void* w, const float* a, const float* b, void* out, int is_bf16,
         int affine, int B, int Cin, int H, int W, int Cout, int kh, int kw, int cin_pad,
         int cout_pad, int device, void* stream) {
  if (B < 1 || Cin < 1 || H < 1 || W < 1 || Cout < 1 || kh % 2 == 0 || kw % 2 == 0 ||
      cin_pad % (is_bf16 ? CB : FCB) != 0 || cin_pad < Cin || cout_pad % BN != 0 ||
      cout_pad < Cout || (affine && (a == nullptr || b == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Geo g;
  g.B = B; g.Cin = Cin; g.H = H; g.W = W; g.Cout = Cout; g.kh = kh; g.kw = kw;
  g.cin_pad = cin_pad; g.cout_pad = cout_pad;
  g.Wt = 16;
  while (g.Wt < W && g.Wt < BM) g.Wt *= 2;
  g.R = BM / g.Wt;
  g.tiles_x = (W + g.Wt - 1) / g.Wt;
  g.tiles_y = (H + g.R - 1) / g.R;
  g.PH = g.R + kh - 1;
  g.PW = g.Wt + kw - 1;
  const long long ctas = (long long)B * g.tiles_x * g.tiles_y;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, cout_pad / BN);
  const int KK = kh * kw, npix = g.PH * g.PW;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sa = affine ? a : nullptr;
  const float* sb = affine ? b : nullptr;
  if (is_bf16) {
    size_t smem = (size_t)npix * 32 + (size_t)KK * CB * BPITCH * 2 + (affine ? 8 * Cin : 0);
    if (smem < (size_t)BN * OPITCH * 2) smem = (size_t)BN * OPITCH * 2;
    auto kernel = affine ? conv_bf16_kernel<true> : conv_bf16_kernel<false>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, st>>>(static_cast<const unsigned short*>(x),
                                        static_cast<const bf16*>(w), sa, sb,
                                        static_cast<bf16*>(out), g);
  } else {
    const size_t smem = (size_t)((FCB * npix + 3) & ~3) * 4 + (size_t)KK * FCB * BN * 4 +
                        (affine ? 8 * Cin : 0);
    auto kernel = affine ? conv_f32_kernel<true> : conv_f32_kernel<false>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, st>>>(static_cast<const float*>(x),
                                        static_cast<const float*>(w), sa, sb,
                                        static_cast<float*>(out), g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous (B, Cin, H, W); w: [kh * kw][cin_pad][cout_pad] in x's dtype
// (zero past Cin and Cout; cin_pad a multiple of 16 for bf16 and 8 for f32,
// cout_pad of 64); out: contiguous (B, Cout, H, W).  is_bf16 selects bf16 (1)
// or f32 (0).  Returns a cudaError_t (0 = launched).
int ofd_conv_rows(const void* x, const void* w, void* out, int is_bf16, int B, int Cin, int H,
                  int W, int Cout, int kh, int kw, int cin_pad, int cout_pad, int device,
                  void* stream) {
  return conv(x, w, nullptr, nullptr, out, is_bf16, 0, B, Cin, H, W, Cout, kh, kw, cin_pad,
              cout_pad, device, stream);
}

// As ofd_conv_rows; with affine = 1 the input is silu(x * a + b) with a, b
// contiguous f32 (B, Cin).
int ofd_conv_fold(const void* x, const void* w, const float* a, const float* b, void* out,
                  int is_bf16, int affine, int B, int Cin, int H, int W, int Cout, int kh,
                  int kw, int cin_pad, int cout_pad, int device, void* stream) {
  return conv(x, w, a, b, out, is_bf16, affine, B, Cin, H, W, Cout, kh, kw, cin_pad, cout_pad,
              device, stream);
}

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
