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
// each has its own entry point and launch count.  The TPU's lane folding and
// sublane rotations are not carried over; its flat slab is.
//
// Bound on the H100: the operations, 2 B H W Cin Cout kh kw over the bf16
// tensor peak (989 TFLOP/s), against the bytes (x and out once, weights
// once) over 3.35 TB/s; for the UNet's 3x3 convs at Cin >= 64 the two are
// close (a 64 -> 64 conv at 448x1024 b2: 67.6 GFLOP, 0.068 ms, vs 0.070 ms
// of bytes), so loads, products and stores have to overlap.
//
// bf16 (the flagship): a warp-specialised implicit GEMM on wgmma.
// - Flat slab.  The image is cut into column strips of wt <= 64 columns (a
//   multiple of 8 where there is more than one), each laid out as rows of
//   pitch pw = wt + kw - 1 with its halo; output position m = y pw + x (x <
//   wt kept, the kw - 1 columns beyond are computed and dropped), so tap
//   (dy, dx) reads the same run of positions shifted by dy pw + dx.  A tile
//   is 512 consecutive positions of one strip (two consumer warp groups of
//   256) and 64 output channels; its patch is the np = 512 + (kh - 1) pw +
//   kw - 1 positions from the tile's first.  Tiles are walked by a
//   persistent grid (one CTA per SM), the 64-channel blocks of one place
//   adjacent so that they share its input in L2.
// - Operands.  The GEMM is out^T = W (64 channels x K) . Z (K x positions):
//   A = the weights, B = the patch, both K-major in shared memory without
//   swizzle, as 8-channel planes of 16 bytes a row (a position, or an output
//   channel).  A shifted run of positions is then a plain descriptor start
//   (16-byte aligned), LBO the plane stride and SBO 128 bytes.  Each consumer
//   warp group runs wgmma m64n256k16: 64 channels x 256 positions, 128 f32
//   accumulators a thread, two k-steps per tap of a 32-channel slice.
// - Three rings under mbarriers, filled by warp group 0 (setmaxnreg gives
//   the consumers the registers): (1) raw: one thread issues a TMA load
//   (cp.async.bulk.tensor, a 4-d map over x) of each 32-channel slice's
//   [32][rh][rw] box of NCHW rows, from the multiple of 8 at or below the
//   strip's first halo column (a box's innermost start must be 16-byte
//   aligned; TMA zero-fills outside the image and past Cin); (2) patch:
//   three warps turn a raw slice into the planes, a thread 8 channels x 8
//   columns at a time: eight 16-byte loads, the prologue where the entry
//   asks for it, an 8 x 8 transpose by byte permutes, and eight 16-byte
//   stores rotated by the lane so that a warp's stores hit distinct banks
//   (few memory-pipe instructions: a first version that loaded with
//   cp.async and transposed with shuffles saturated that pipe); each patch
//   stage is consumed by all kh kw taps; (3)
//   weights: warp 0 streams the (slice, tap) weight tiles ([4 planes][64][8],
//   4 KB, laid out so by the wrapper) with 1-d bulk TMA copies.  The
//   consumers release a stage when the wgmma group that read it has
//   completed (one group stays in flight).
// - Prologue: u = x a + b (rounded after the product and the sum, as the
//   plain version), silu(u) = h + h tanh(h) with h = u / 2 and one
//   tanh.approx on the SFU, rounded to bf16 in pairs; pixels outside the
//   image stay 0.  (With an exp, a divide and a bf16 conversion per element
//   the prologue more than tripled the launch's time.)
// - Epilogue: the consumers keep the tile's last patch stage and stage
//   their accumulators there as bf16 [channel][position], 64 positions at a
//   time, then write NCHW rows as bf16 pairs, a warp one channel's 64
//   positions (coalesced), dropping the junk columns.  No atomics: two
//   launches give the same bits.
// Measured (chip_smoke.py, CUDA events, warm L2; NVIDIA H100 80GB HBM3,
// 700.00 W), the native level-0 3x3 64->64 at b2: 0.239 ms (conv_rows) and
// 0.298 ms with the prologue (conv_fold), against 0.387 ms for one
// F.conv2d; the 44 convs of a native b2 UNet eval under fold 9.80 ms
// (profile_step.py), cuDNN's 11.26 ms with its layout conversions.
//
// f32 (precision fp32): a 128-pixel x 64-channel tile on CUDA cores with f32
// FMA (never TF32), 8 input channels a slice, each thread 8 pixels x 4
// channels, weights [kh * kw][cin_pad][cout_pad].

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---- bf16 kernel
constexpr int THREADS = 384;          // producer + 2 consumer warp groups
constexpr int MT = 512;               // output positions per tile, 256 per consumer
constexpr int NB = 64;                // output channels per tile
constexpr int CK = 32;                // input channels per K slice: 4 planes of 8
constexpr int PSTAGES = 2;            // patch ring
constexpr int WSTAGES = 6;            // weight ring
constexpr int WTILE = NB * CK * 2;    // bytes of one (slice, tap) weight tile
constexpr int TWARPS = 3;             // producer warps that turn raw slices into patches
constexpr int EPITCH = 36;            // 32-bit words per staged output channel row (64 + 8 bf16)
constexpr int PRODUCER_REGS = 120, CONSUMER_REGS = 192;  // setmaxnreg, one CTA per SM
// ---- f32 kernel
constexpr int FTHREADS = 256;         // 8 warps
constexpr int FBM = 128;              // output pixels per CTA
constexpr int FBN = 64;               // output channels per CTA
constexpr int FCB = 8;                // input channels per K slice
constexpr int MAX_SMEM = 227 * 1024;  // dynamic shared memory a block may use
constexpr unsigned FULL = 0xffffffffu;

// The bf16 kernel's tiling (the wrapper's conv_plan computes the same).
struct Plan {
  int B, Cin, H, W, Cout, kh, kw;
  int wt, pw, strips, runs, nblk, nsl, np, tiles;
  int rw, rh, rstages;                // raw slice columns and rows, raw ring stages
};

// The f32 kernel's tiling.
struct Geo {
  int B, Cin, H, W, Cout, kh, kw, cin_pad, cout_pad;
  int R, Wt, tiles_x, tiles_y;        // tile rows and columns, tiles per image along x, y
  int PH, PW;                         // patch rows and columns: R + kh - 1, Wt + kw - 1
};

size_t plan_smem(const Plan& p, int rstages) {
  return (size_t)PSTAGES * p.np * 64 + (size_t)rstages * (CK * p.rh * p.rw * 2 + 256) +
         (size_t)WSTAGES * WTILE + 2 * (PSTAGES + WSTAGES + rstages) * 8;
}

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

// a box of the 4-d tensor map at (c0, c1, c2, c3) -> shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// global -> shared bulk copy on the TMA unit, completing on ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor without swizzle: start address, LBO
// (the stride between core matrices along K) and SBO (along M or N), bytes
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across a wgmma wait
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// D (64 x 256) += A (64 x 16) B (16 x 256), both K-major in shared memory
__device__ __forceinline__ void wgmma_conv(float (&d)[128], uint64_t da, uint64_t db,
                                           uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// The f32 prologue's activation, u / (1 + e^-u), exactly as the plain
// version computes it (the bf16 one is affine2's).
__device__ __forceinline__ float silu(float u) { return u / (1.f + expf(-u)); }

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

// The f32 kernel's tile of CTA blockIdx.x: image b, first output row y0 and column x0.
__device__ __forceinline__ void tile_origin(const Geo& g, int& b, int& y0, int& x0) {
  int t = blockIdx.x;
  const int tx = t % g.tiles_x;
  t /= g.tiles_x;
  const int ty = t % g.tiles_y;
  b = t / g.tiles_y;
  y0 = ty * g.R;
  x0 = tx * g.Wt;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The tile's image b, strip origin x0, first flat position m0 and channel block nb.
__device__ __forceinline__ void tile_coords(const Plan& p, int tile, int& b, int& x0, int& m0,
                                            int& nb) {
  nb = tile % p.nblk;
  int r = tile / p.nblk;
  const int run = r % p.runs;
  r /= p.runs;
  x0 = (r % p.strips) * p.wt;
  b = r / p.strips;
  m0 = run * MT;
}

// The image column of raw column 0 of a strip: the multiple of 8 at or
// below x0 - kw/2 (a TMA box's innermost start has to be 16-byte aligned).
__device__ __forceinline__ int raw_x(const Plan& p, int x0) {
  return (x0 - p.kw / 2 + 8) / 8 * 8 - 8;
}

// Issues the TMA load of raw slice k of this CTA (tile blockIdx.x + (k / nsl)
// gridDim.x, channels 32 (k % nsl) ..): the [32][rh][rw] box of x from
// column raw_x and row m0 / pw - kh/2, zero outside x.
__device__ __forceinline__ void load_raw(const CUtensorMap* tx, const Plan& p, int k,
                                         uint32_t dst, uint32_t bar) {
  int b, x0, m0, nb;
  tile_coords(p, blockIdx.x + (k / p.nsl) * gridDim.x, b, x0, m0, nb);
  mbar_expect_tx(bar, CK * p.rh * p.rw * 2);
  tma_load_4d(dst, tx, bar, raw_x(p, x0), m0 / p.pw - p.kh / 2, (k % p.nsl) * CK, b);
}

// silu(x * a + b) on a bf16 pair whose pixels are inside the image (in0,
// in1); those outside stay zero.  u = x a + b rounded after the product and
// after the sum (no FMA), as the plain version computes it; silu(u) =
// h + h tanh(h) with h = u / 2, one tanh.approx (the SFU's only operation
// here; its error, ~2^-11 relative, is below the rounding of z to bf16); the
// pair is rounded to bf16 by one conversion.
__device__ __forceinline__ uint32_t affine2(uint32_t v, float a, float b, bool in0, bool in1) {
  const float h0 = 0.5f * __fadd_rn(__fmul_rn(bf16_bits_to_float(v & 0xffff), a), b);
  const float h1 = 0.5f * __fadd_rn(__fmul_rn(bf16_bits_to_float(v >> 16), a), b);
  float t0, t1;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t0) : "f"(h0));
  asm("tanh.approx.f32 %0, %1;" : "=f"(t1) : "f"(h1));
  __nv_bfloat162 z = __floats2bfloat162_rn(fmaf(h0, t0, h0), fmaf(h1, t1, h1));
  const uint32_t zz = *reinterpret_cast<uint32_t*>(&z);
  return (in0 ? zz & 0xffffu : 0u) | (in1 ? zz & 0xffff0000u : 0u);
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t a, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z),
               "r"(v.w)
               : "memory");
}

// o[i] = o[(i + s) % 8] where ``on``: a rotation by a compile-time s under a
// runtime condition (selects, no indexing of the register array)
template <int S>
__device__ __forceinline__ void rotate_if(uint4 (&o)[8], bool on) {
  uint4 t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = o[(i + S) & 7];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[i].x = on ? t[i].x : o[i].x;
    o[i].y = on ? t[i].y : o[i].y;
    o[i].z = on ? t[i].z : o[i].z;
    o[i].w = on ? t[i].w : o[i].w;
  }
}

// grid min(tiles, SMs) (persistent), THREADS threads, plan_smem(p,
// p.rstages) bytes of dynamic shared memory; tx maps x as (ldx, H, Cin, B)
// with [32][rh][rw] boxes; w laid out [nblk][nsl][kh * kw][4][64][8].
template <bool AFFINE>
__global__ void __launch_bounds__(THREADS, 1)
conv_bf16_kernel(const __grid_constant__ CUtensorMap tx, const bf16* __restrict__ w,
                 const float* __restrict__ sa, const float* __restrict__ sb,
                 bf16* __restrict__ out, Plan p) {
  extern __shared__ __align__(128) unsigned char conv_smem[];
  const uint32_t base = smem_u32(conv_smem);
  const uint32_t pstage = p.np * 64;                  // 4 planes of np positions x 16 B
  const uint32_t rstage = CK * p.rh * p.rw * 2;       // [32][rh][rw] bf16
  const uint32_t p_off = base, r_off = p_off + PSTAGES * pstage;
  const uint32_t a_off = r_off + p.rstages * rstage;  // per raw stage: a[32], b[32] f32
  const uint32_t w_off = a_off + p.rstages * 256;
  const uint32_t pfull = w_off + WSTAGES * WTILE, pempty = pfull + 8 * PSTAGES;
  const uint32_t wfull = pempty + 8 * PSTAGES, wempty = wfull + 8 * WSTAGES;
  const uint32_t rfull = wempty + 8 * WSTAGES, rempty = rfull + 8 * p.rstages;
  const int KK = p.kh * p.kw, ry = p.kh / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nslices = (p.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x * p.nsl + p.nsl;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(pfull + 8 * s, TWARPS * 32);
      mbar_init(pempty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 8);
    }
    for (int s = 0; s < p.rstages; ++s) {
      mbar_init(rfull + 8 * s, 1);
      mbar_init(rempty + 8 * s, TWARPS);  // lane 0 of each transposing warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warp group, warp-uniform as the compiler sees it (setmaxnreg needs
  // the roles' branches to be)
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 0) {
      // ---- weight tiles, in the consumers' order: tile, slice, tap
      if (lane == 0) {
        const int per_tile = p.nsl * KK;
        int it = 0;
        for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
          const bf16* wn = w + (size_t)(tile % p.nblk) * per_tile * (WTILE / 2);
          for (int j = 0; j < per_tile; ++j, ++it) {
            const int st = it % WSTAGES, k = it / WSTAGES;
            if (k > 0) mbar_wait(wempty + 8 * st, (k - 1) & 1);
            mbar_expect_tx(wfull + 8 * st, WTILE);
            bulk_load(w_off + st * WTILE, wn + (size_t)j * (WTILE / 2), WTILE, wfull + 8 * st);
          }
        }
      }
    } else {
      // ---- raw slices -> patch planes.  An item is one chunk of 8 raw
      // columns of one row and 8 channels (one plane): 8 16-byte loads,
      // the prologue, an 8 x 8 transpose in registers (byte permutes) and
      // 8 16-byte stores of one position each, rotated by the lane so that
      // a warp's stores fall on distinct banks.  Warp 1's lane 0 also
      // issues the raw slices' TMA loads.
      const int tid = threadIdx.x - 32;
      const int nch = p.rw >> 3;
      if (tid == 0)
        for (int k = 0; k < p.rstages && k < nslices; ++k)
          load_raw(&tx, p, k, r_off + k * rstage, rfull + 8 * k);
      for (int k = 0; k < nslices; ++k) {
        int b, x0, m0, nb;
        tile_coords(p, blockIdx.x + (k / p.nsl) * gridDim.x, b, x0, m0, nb);
        const int c0 = (k % p.nsl) * CK;
        const int xa = raw_x(p, x0);           // image column of raw column 0
        const int sh = x0 - p.kw / 2 - xa;     // raw column of padded column 0
        const int rs = k % p.rstages, pst = k % PSTAGES;
        const uint32_t rb = r_off + rs * rstage, ab = a_off + rs * 256;
        const uint32_t pb = p_off + pst * pstage;
        mbar_wait_warp(rfull + 8 * rs, (k / p.rstages) & 1);
        if (AFFINE) {
          if (tid < CK) {
            const int c = c0 + tid;
            const float av = c < p.Cin ? __ldg(sa + b * p.Cin + c) : 0.f;
            const float bv = c < p.Cin ? __ldg(sb + b * p.Cin + c) : 0.f;
            asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(ab + 4 * tid), "f"(av) : "memory");
            asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(ab + 128 + 4 * tid), "f"(bv)
                         : "memory");
          }
          asm volatile("bar.sync 1, %0;\n" ::"n"(TWARPS * 32) : "memory");
        }
        if (k >= PSTAGES) mbar_wait_warp(pempty + 8 * pst, (k / PSTAGES - 1) & 1);
        const int py_a = m0 / p.pw;
        const int nrows = (m0 + p.np - 1) / p.pw - py_a + 1;
        const int items = 4 * nrows * nch;
        for (int item = tid; item < items; item += TWARPS * 32) {
          const int q = item % nch, gr = item / nch;
          const int g = gr / nrows, row = gr - g * nrows;
          uint4 v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[i] = lds128(rb + (((8 * g + i) * p.rh + row) * p.rw + 8 * q) * 2);
          const int iy = py_a + row - ry;
          if (AFFINE && iy >= 0 && iy < p.H) {
            const int ix = xa + 8 * q;
            unsigned in = 0;  // bit e: pixel e of the chunk lies inside the image
#pragma unroll
            for (int e = 0; e < 8; ++e) in |= (ix + e >= 0 && ix + e < p.W) ? 1u << e : 0u;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint4 a4 = lds128(ab + 32 * g + 16 * h);
              const uint4 b4 = lds128(ab + 128 + 32 * g + 16 * h);
              const uint32_t av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float a = __uint_as_float(av[i]), bb = __uint_as_float(bv[i]);
                uint4& r = v[4 * h + i];
                r.x = affine2(r.x, a, bb, in & 1, in & 2);
                r.y = affine2(r.y, a, bb, in & 4, in & 8);
                r.z = affine2(r.z, a, bb, in & 16, in & 32);
                r.w = affine2(r.w, a, bb, in & 64, in & 128);
              }
            }
          }
          // v[i] holds channel i, pixels 0-7 as pairs; o[e] gets pixel e, channels 0-7
          uint4 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const uint32_t sel = (e & 1) ? 0x7632 : 0x5410;
            const int wsel = e >> 1;
            auto word = [&](int i) {
              return wsel == 0 ? v[i].x : wsel == 1 ? v[i].y : wsel == 2 ? v[i].z : v[i].w;
            };
            o[e].x = __byte_perm(word(0), word(1), sel);
            o[e].y = __byte_perm(word(2), word(3), sel);
            o[e].z = __byte_perm(word(4), word(5), sel);
            o[e].w = __byte_perm(word(6), word(7), sel);
          }
          // rotate by lane % 8, so that step e stores pixel (e + lane) % 8
          rotate_if<1>(o, lane & 1);
          rotate_if<2>(o, lane & 2);
          rotate_if<4>(o, lane & 4);
          const int slot0 = (py_a + row) * p.pw - m0 + 8 * q - sh;  // slot of raw column 8 q
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int pe = (e + lane) & 7;
            const int px = 8 * q + pe - sh, slot = slot0 + pe;
            if (px >= 0 && px < p.pw && slot >= 0 && slot < p.np)
              sts128(pb + g * p.np * 16 + slot * 16, o[e]);
          }
        }
        // the stores are read by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(pfull + 8 * pst);
        __syncwarp();
        if (lane == 0) mbar_arrive(rempty + 8 * rs);
        if (tid == 0 && k + p.rstages < nslices) {
          mbar_wait(rempty + 8 * rs, (k / p.rstages) & 1);
          load_raw(&tx, p, k + p.rstages, rb, rfull + 8 * rs);
        }
      }
    }
  } else {
    // ---- consumers: warp group cw owns positions 256 cw .. + 255 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127, cwarp = tid >> 5;
    const int g = lane >> 2, cq = lane & 3;
    const uint32_t plane = p.np * 16;  // bytes between the patch's 8-channel planes
    float acc[128];
    int it = 0, pit = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      int b, x0, m0, nb;
      tile_coords(p, tile, b, x0, m0, nb);
      const int off = cw * 256;
      int prev_w = -1, prev_p = -1, pst = 0;
      for (int s = 0; s < p.nsl; ++s, ++pit) {
        pst = pit % PSTAGES;
        mbar_wait_warp(pfull + 8 * pst, (pit / PSTAGES) & 1);
        const uint32_t pa = p_off + pst * pstage + off * 16;
        for (int t = 0; t < KK; ++t, ++it) {
          const int dy = t / p.kw, dx = t - dy * p.kw;
          const int wst = it % WSTAGES;
          mbar_wait_warp(wfull + 8 * wst, (it / WSTAGES) & 1);
          const uint32_t wa = w_off + wst * WTILE;
          const uint32_t pb = pa + (dy * p.pw + dx) * 16;
          wgmma_fence();
          // k-steps of 16 channels: planes 0-1, then 2-3
          wgmma_conv(acc, desc_plain(wa, NB * 16, 128), desc_plain(pb, plane, 128),
                     (s | t) != 0);
          wgmma_conv(acc, desc_plain(wa + 2 * NB * 16, NB * 16, 128),
                     desc_plain(pb + 2 * plane, plane, 128), 1);
          wgmma_commit();
          wgmma_wait<1>();  // the previous group has read its stages
          if (prev_w >= 0 && lane == 0) {
            mbar_arrive(wempty + 8 * prev_w);
            if (prev_p >= 0) mbar_arrive(pempty + 8 * prev_p);
          }
          prev_w = wst;
          prev_p = t == KK - 1 && s < p.nsl - 1 ? pst : -1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
      if (lane == 0) mbar_arrive(wempty + 8 * prev_w);

      // epilogue, staged in the last patch stage (held until the stores are
      // done): 4 rounds of 64 positions; acc[4 j + 2 h + e] is channel
      // 16 cwarp + g + 8 h at position 8 j + 2 cq + e of the warp group's 256.
      // Each round is staged as bf16 [channel][position] and written as bf16
      // pairs, a warp one channel's 64 positions (row segments of NCHW).
      asm volatile("bar.sync 2, 256;\n" ::: "memory");  // both groups done with the stage
      const uint32_t stg = p_off + pst * pstage + cw * (NB * EPITCH * 4);
      const int n0 = nb * NB;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 8 * r + jj;
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             stg + ((16 * cwarp + g + 8 * h) * EPITCH + 4 * jj + cq) * 4),
                         "r"(pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]))
                         : "memory");
          }
        asm volatile("bar.sync %0, 128;\n" ::"r"(3 + cw) : "memory");
        // this lane's pair: positions 2 lane, 2 lane + 1 of the round
        const int m = m0 + off + 64 * r + 2 * lane;
        const int y = m / p.pw, xx = m - y * p.pw;
        const int y1 = xx + 1 < p.pw ? y : y + 1, xx1 = xx + 1 < p.pw ? xx + 1 : 0;
        const bool in0 = y < p.H && xx < p.wt && x0 + xx < p.W;
        const bool in1 = y1 < p.H && xx1 < p.wt && x0 + xx1 < p.W;
        const bool pair = in0 && in1 && y1 == y && ((x0 + xx) & 1) == 0 && (p.W & 1) == 0;
#pragma unroll 4
        for (int i = 0; i < 16; ++i) {
          const int ch = cwarp + 4 * i;
          if (n0 + ch >= p.Cout || !(in0 || in1)) continue;
          uint32_t v;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(stg + (ch * EPITCH + lane) * 4));
          bf16* plane_n = out + ((size_t)b * p.Cout + n0 + ch) * p.H * p.W + x0;
          if (pair) {
            *reinterpret_cast<uint32_t*>(plane_n + (size_t)y * p.W + xx) = v;
          } else {
            if (in0)
              plane_n[(size_t)y * p.W + xx] = __ushort_as_bfloat16((unsigned short)(v & 0xffff));
            if (in1)
              plane_n[(size_t)y1 * p.W + xx1] = __ushort_as_bfloat16((unsigned short)(v >> 16));
          }
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(3 + cw) : "memory");
      }
      asm volatile("bar.sync 2, 256;\n" ::: "memory");  // both groups done staging
      if (lane == 0) mbar_arrive(pempty + 8 * pst);
    }
  }
}

// grid (B * tiles_y * tiles_x, cout_pad / FBN), FTHREADS threads; dynamic
// shared memory: patch [FCB][PH * PW] and weight tiles [KK][FCB][FBN],
// f32.  Thread: pixels mg + 16 i (i < 8) and channels 4 ng .. 4 ng + 3.
template <bool AFFINE>
__global__ void __launch_bounds__(FTHREADS)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ sa, const float* __restrict__ sb,
                float* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KK = g.kh * g.kw;
  const int npix = g.PH * g.PW;
  float* patch = reinterpret_cast<float*>(smem);             // [FCB][npix]
  float* ws = patch + ((FCB * npix + 3) & ~3);               // [KK * FCB][FBN]
  float* aff = ws + KK * FCB * FBN;                           // a[:Cin], b[:Cin]

  int b, y0, x0;
  tile_origin(g, b, y0, x0);
  if (AFFINE) stage_affine(sa, sb, b, g.Cin, aff);
  const int n0 = blockIdx.y * FBN;
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
    for (int i = threadIdx.x; i < FCB * npix; i += FTHREADS) {
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
    for (int i = threadIdx.x; i < KK * FCB * (FBN / 4); i += FTHREADS) {
      const int kr = i / (FBN / 4), v = i % (FBN / 4);
      const int t = kr / FCB, k = kr % FCB;
      *reinterpret_cast<float4*>(ws + kr * FBN + v * 4) = __ldg(reinterpret_cast<const float4*>(
          w + ((size_t)(t * g.cin_pad + c0 + k) * g.cout_pad + n0 + v * 4)));
    }
    __syncthreads();
    for (int k = 0; k < FCB; ++k) {
      const float* pk = patch + k * npix;
      for (int t = 0; t < KK; ++t) {
        const int dy = t / g.kw, dx = t - dy * g.kw;
        const int shift = dy * g.PW + dx;
        const float4 wv = *reinterpret_cast<const float4*>(ws + (t * FCB + k) * FBN + ng * 4);
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

int conv_bf16(const void* x, const void* w, const float* a, const float* b, void* out,
              int affine, int B, int Cin, int H, int W, int Cout, int kh, int kw, int cin_pad,
              int cout_pad, int wt, int ldx, cudaStream_t st) {
  Plan p;
  p.B = B; p.Cin = Cin; p.H = H; p.W = W; p.Cout = Cout; p.kh = kh; p.kw = kw;
  p.wt = wt;
  p.pw = wt + kw - 1;
  p.strips = (W + wt - 1) / wt;
  p.runs = (int)(((long long)H * p.pw + MT - 1) / MT);
  p.nblk = (Cout + NB - 1) / NB;
  p.nsl = (Cin + CK - 1) / CK;
  p.np = MT + (kh - 1) * p.pw + kw - 1;
  p.rw = (p.pw + 14) & ~7;  // pw columns from any of 8 offsets into a chunk
  p.rh = (p.np + p.pw - 2) / p.pw + 1;
  const long long tiles = (long long)B * p.strips * p.runs * p.nblk;
  if (wt < 1 || wt > W || cin_pad != p.nsl * CK || cout_pad != p.nblk * NB || p.rw > 256 ||
      p.rh > 256 || tiles > 0x7fffffffLL || ldx < W || ldx % 8 != 0 || !aligned16(x) ||
      !aligned16(w))
    return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.rstages = plan_smem(p, 2) <= (size_t)MAX_SMEM ? 2 : 1;
  const size_t smem = plan_smem(p, p.rstages);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // x as (ldx, H, Cin, B) bf16 with [32][rh][rw] boxes, zero outside
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tx;
  const cuuint64_t dims[4] = {(cuuint64_t)ldx, (cuuint64_t)H, (cuuint64_t)Cin, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ldx * 2, (cuuint64_t)ldx * H * 2,
                                 (cuuint64_t)ldx * H * Cin * 2};
  const cuuint32_t box[4] = {(cuuint32_t)p.rw, (cuuint32_t)p.rh, CK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kernel = affine ? conv_bf16_kernel<true> : conv_bf16_kernel<false>;
  // setmaxnreg hands registers between the warp groups of one CTA: the
  // counts after it must fit in what the CTA was launched with
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  if (fa.numRegs * THREADS < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS)
    return (int)cudaErrorInvalidConfiguration;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  kernel<<<grid, THREADS, smem, st>>>(tx, static_cast<const bf16*>(w), affine ? a : nullptr,
                                      affine ? b : nullptr, static_cast<bf16*>(out), p);
  return (int)cudaGetLastError();
}

int conv_f32(const void* x, const void* w, const float* a, const float* b, void* out,
             int affine, int B, int Cin, int H, int W, int Cout, int kh, int kw, int cin_pad,
             int cout_pad, cudaStream_t st) {
  if (cin_pad % FCB != 0 || cin_pad < Cin || cout_pad % FBN != 0 || cout_pad < Cout)
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.B = B; g.Cin = Cin; g.H = H; g.W = W; g.Cout = Cout; g.kh = kh; g.kw = kw;
  g.cin_pad = cin_pad; g.cout_pad = cout_pad;
  g.Wt = 16;
  while (g.Wt < W && g.Wt < FBM) g.Wt *= 2;
  g.R = FBM / g.Wt;
  g.tiles_x = (W + g.Wt - 1) / g.Wt;
  g.tiles_y = (H + g.R - 1) / g.R;
  g.PH = g.R + kh - 1;
  g.PW = g.Wt + kw - 1;
  const long long ctas = (long long)B * g.tiles_x * g.tiles_y;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, cout_pad / FBN);
  const int KK = kh * kw, npix = g.PH * g.PW;
  const size_t smem = (size_t)((FCB * npix + 3) & ~3) * 4 + (size_t)KK * FCB * FBN * 4 +
                      (affine ? 8 * Cin : 0);
  auto kernel = affine ? conv_f32_kernel<true> : conv_f32_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, FTHREADS, smem, st>>>(static_cast<const float*>(x),
                                       static_cast<const float*>(w), affine ? a : nullptr,
                                       affine ? b : nullptr, static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

int conv(const void* x, const void* w, const float* a, const float* b, void* out, int is_bf16,
         int affine, int B, int Cin, int H, int W, int Cout, int kh, int kw, int cin_pad,
         int cout_pad, int wt, int ldx, int device, void* stream) {
  if (B < 1 || Cin < 1 || H < 1 || W < 1 || Cout < 1 || kh % 2 == 0 || kw % 2 == 0 ||
      (affine && (a == nullptr || b == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return conv_bf16(x, w, a, b, out, affine, B, Cin, H, W, Cout, kh, kw, cin_pad, cout_pad, wt,
                     ldx, st);
  if (ldx != W) return (int)cudaErrorInvalidValue;
  return conv_f32(x, w, a, b, out, affine, B, Cin, H, W, Cout, kh, kw, cin_pad, cout_pad, st);
}

}  // namespace

extern "C" {

// x: (B, Cin, H, W) with rows of ldx >= W elements (f32: ldx = W), the rest
// contiguous; out: contiguous (B, Cout, H, W); is_bf16 selects bf16 (1) or
// f32 (0).  bf16: w laid out [cout_pad / 64][cin_pad / 32][kh * kw][4][64][8]
// (8-channel planes of each 64 x 32 (slice, tap) tile, zero past Cin and
// Cout), strips of wt columns (the wrapper's conv_plan), ldx a multiple of 8
// and x 16-byte aligned (the tensor map).  f32: w [kh * kw][cin_pad][cout_pad]
// (cin_pad a multiple of 8, cout_pad of 64), wt unused.  Returns a
// cudaError_t (0 = launched).
int ofd_conv_rows(const void* x, const void* w, void* out, int is_bf16, int B, int Cin, int H,
                  int W, int Cout, int kh, int kw, int cin_pad, int cout_pad, int wt, int ldx,
                  int device, void* stream) {
  return conv(x, w, nullptr, nullptr, out, is_bf16, 0, B, Cin, H, W, Cout, kh, kw, cin_pad,
              cout_pad, wt, ldx, device, stream);
}

// As ofd_conv_rows; with affine = 1 the input is silu(x * a + b) with a, b
// contiguous f32 (B, Cin).
int ofd_conv_fold(const void* x, const void* w, const float* a, const float* b, void* out,
                  int is_bf16, int affine, int B, int Cin, int H, int W, int Cout, int kh,
                  int kw, int cin_pad, int cout_pad, int wt, int ldx, int device, void* stream) {
  return conv(x, w, a, b, out, is_bf16, affine, B, Cin, H, W, Cout, kh, kw, cin_pad, cout_pad,
              wt, ldx, device, stream);
}

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
