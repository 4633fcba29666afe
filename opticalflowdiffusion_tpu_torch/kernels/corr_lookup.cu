// RAFT's windowed lookup in the all-pairs correlation pyramid, and its
// cotangent (Hopper, sm_90a).
//
// For each query pixel n (of N = B * H * W) and each level l of L, the
// level is a row corr_l[n] of Hl x Wl float32 values (the correlation of
// pixel n with every pixel of the second frame, average-pooled l times).
// With (cx, cy) = coords[n] / 2^l the lookup reads the (2r + 1)^2 taps
//
//   out[n, l * K + i * (2r + 1) + j] = bilinear(corr_l[n], cx + (j - r), cy + (i - r))
//
// (K = (2r + 1)^2; dy = i - r, dx = j - r: JAX's meshgrid(ij) then
// stack([ddx, ddy]) order, the levels concatenated last), where bilinear
// reads the four pixels around the point, each index clamped to the frame
// (the border pixel repeats), and mixes them as
//   top = v00 (1 - wx) + v01 wx,  bot = v10 (1 - wx) + v11 wx,
//   out = top (1 - wy) + bot wy.
// Replaces the JAX package's opticalflowdiffusion_tpu/models/raft.py
// corr_lookup (:95) over ops/warp.py's bilinear_gather, which is XLA there
// (a gather), not Pallas.  Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn: no contraction), in the plain version's order, so
// the forward gives the plain version's bits where its elementwise ops do.
//
// - Forward (lookup_fwd_kernel): a thread a (query, level, tap), the taps of
//   a query adjacent, so the (N, L * K) output (channels-last) is written
//   coalesced; the four reads of a tap fall in the query's own row, within
//   a (2r + 2)^2 window that the neighbouring taps share in L1.  One launch
//   for every level.
// - Backward (lookup_bwd_kernel): the cotangent of each level is dense,
//   (N, Hl, Wl), and is written whole, once.  A CTA owns up to BWD_ROWS
//   consecutive query rows of one level.  First, one thread a row adds the
//   4 K corner terms of its taps, tap by tap (corners 00, 01, 10, 11), into
//   a (2r + 4)^2 window of cells in shared memory, unclamped, anchored at
//   floor(coords / 2^l) - r (a tap's own floor lies 0 or 1 cell past its
//   offset, where the sum rounds up to the next integer).  Then every
//   thread of the CTA streams the rows out: a pixel outside the row's
//   window lines is 0, one inside sums the cells that clamp onto it (one,
//   or several at a border) in cell order.  Each sum has one owner and a
//   fixed order, so there is no atomic and a repeat gives the same bits.
//   The coords carry no cotangent (RAFT stops their gradient).  One launch
//   for every level.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 256;
constexpr int BWD_ROWS = 32;           // query rows of a backward CTA, at most
constexpr int BWD_SMEM = 48 * 1024;    // its windows' shared memory, at most
constexpr float FAR = 4194304.f;       // 2^22: coordinates clamped to this for the window

struct Levels {
  const float* corr[MAX_LEVELS];   // forward: the levels; backward: unused
  float* grad[MAX_LEVELS];         // backward: the levels' cotangents
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

// The float index of a tap coordinate as an int, clamped to [0, n - 1]; the
// float is clamped first so that a far point cannot overflow the int.
__device__ __forceinline__ int clamp_index(float v, int n) {
  v = fminf(fmaxf(v, -1.f), (float)n);
  int i = (int)v;
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

struct Tap {
  int i00, i01, i10, i11;   // offsets in the level's row of the four corners
  float wx, wy;
};

// The corners and weights of tap (dy, dx) at level l (scale = 2^-l), as
// the plain version computes them: c = coords * 2^-l (exact), p = c + d,
// p0 = floor(p), w = p - p0, the corner indices p0 and p0 + 1 clamped.
__device__ __forceinline__ Tap make_tap(float cx, float cy, float scale, int dx, int dy,
                                        int H, int W) {
  const float px = __fadd_rn(__fmul_rn(cx, scale), (float)dx);
  const float py = __fadd_rn(__fmul_rn(cy, scale), (float)dy);
  const float x0 = floorf(px), y0 = floorf(py);
  Tap t;
  t.wx = __fsub_rn(px, x0);
  t.wy = __fsub_rn(py, y0);
  const int xa = clamp_index(x0, W), xb = clamp_index(__fadd_rn(x0, 1.f), W);
  const int ya = clamp_index(y0, H), yb = clamp_index(__fadd_rn(y0, 1.f), H);
  t.i00 = ya * W + xa;
  t.i01 = ya * W + xb;
  t.i10 = yb * W + xa;
  t.i11 = yb * W + xb;
  return t;
}

__global__ void __launch_bounds__(FWD_THREADS)
lookup_fwd_kernel(Levels lv, const float* __restrict__ coords, float* __restrict__ out,
                  int64_t N, int L, int r) {
  const int side = 2 * r + 1, K = side * side, LK = L * K;
  const int64_t t = (int64_t)blockIdx.x * FWD_THREADS + threadIdx.x;
  if (t >= N * LK) return;
  const int64_t n = t / LK;
  const int rem = (int)(t - n * LK), l = rem / K, k = rem - l * K;
  const int H = lv.h[l], W = lv.w[l];
  const float* row = lv.corr[l] + (size_t)n * H * W;
  const Tap tp = make_tap(__ldg(coords + 2 * n), __ldg(coords + 2 * n + 1), 1.f / (float)(1 << l),
                          k % side - r, k / side - r, H, W);
  const float v00 = __ldg(row + tp.i00), v01 = __ldg(row + tp.i01);
  const float v10 = __ldg(row + tp.i10), v11 = __ldg(row + tp.i11);
  const float ux = __fsub_rn(1.f, tp.wx), uy = __fsub_rn(1.f, tp.wy);
  const float top = __fadd_rn(__fmul_rn(v00, ux), __fmul_rn(v01, tp.wx));
  const float bot = __fadd_rn(__fmul_rn(v10, ux), __fmul_rn(v11, tp.wx));
  out[t] = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, tp.wy));
}

// The rows of a backward CTA at radius r: as many as the windows fit.
__host__ __device__ __forceinline__ int bwd_rows(int r) {
  const int side = 2 * r + 4;
  const int rows = BWD_SMEM / (side * side * 4 + 8);
  return rows < BWD_ROWS ? rows : BWD_ROWS;
}

// The window cells that clamp onto pixel coordinate p of a side of n, from
// a window anchored at o with `side` cells: [lo, hi] (lo > hi: none).
__device__ __forceinline__ void cell_range(int p, int o, int n, int side, int& lo, int& hi) {
  lo = p == 0 ? 0 : p - o;
  hi = p == n - 1 ? side - 1 : p - o;
  lo = lo < 0 ? 0 : lo;
  hi = hi > side - 1 ? side - 1 : hi;
}

__global__ void __launch_bounds__(BWD_THREADS)
lookup_bwd_kernel(Levels lv, const float* __restrict__ coords, const float* __restrict__ g,
                  int64_t N, int L, int r) {
  extern __shared__ float smem[];
  const int l = blockIdx.y;
  const int H = lv.h[l], W = lv.w[l], HW = H * W;
  const int side = 2 * r + 1, K = side * side, S = side + 3, S2 = S * S;
  const int R = bwd_rows(r);
  const int64_t n0 = (int64_t)blockIdx.x * R;
  const int rows = N - n0 < R ? (int)(N - n0) : R;
  float* win = smem;                                   // [R][S2]
  int* org = reinterpret_cast<int*>(smem + R * S2);    // [R][2]: the window's x, y anchor
  for (int i = threadIdx.x; i < R * S2; i += BWD_THREADS) win[i] = 0.f;
  __syncthreads();
  const float scale = 1.f / (float)(1 << l);
  if (threadIdx.x < rows) {
    const int64_t n = n0 + threadIdx.x;
    const float cx = coords[2 * n], cy = coords[2 * n + 1];
    const float ox = floorf(fminf(fmaxf(__fmul_rn(cx, scale), -FAR), FAR)) - r;
    const float oy = floorf(fminf(fmaxf(__fmul_rn(cy, scale), -FAR), FAR)) - r;
    org[2 * threadIdx.x] = (int)ox;
    org[2 * threadIdx.x + 1] = (int)oy;
    float* w = win + threadIdx.x * S2;
    const float* gn = g + (size_t)n * L * K + (size_t)l * K;
    for (int k = 0; k < K; ++k) {
      const float px = __fadd_rn(__fmul_rn(cx, scale), (float)(k % side - r));
      const float py = __fadd_rn(__fmul_rn(cy, scale), (float)(k / side - r));
      const float x0 = floorf(px), y0 = floorf(py);
      const float wx = __fsub_rn(px, x0), wy = __fsub_rn(py, y0);
      // the tap's cell: its offset, or one more where the sum rounded up
      // (a point beyond FAR lands on the window's edge: every cell there
      // clamps onto the same border pixel)
      int ux = (int)fminf(fmaxf(x0 - ox, 0.f), (float)(S - 2));
      int uy = (int)fminf(fmaxf(y0 - oy, 0.f), (float)(S - 2));
      const float gk = gn[k];
      // the plain version's chain rule: d top = g (1 - wy), d bot = g wy, then
      // d v00 = d top (1 - wx), d v01 = d top wx, ...
      const float gt = __fmul_rn(gk, __fsub_rn(1.f, wy)), gb = __fmul_rn(gk, wy);
      const float u = __fsub_rn(1.f, wx);
      float* c = w + uy * S + ux;
      c[0] = __fadd_rn(c[0], __fmul_rn(gt, u));
      c[1] = __fadd_rn(c[1], __fmul_rn(gt, wx));
      c[S] = __fadd_rn(c[S], __fmul_rn(gb, u));
      c[S + 1] = __fadd_rn(c[S + 1], __fmul_rn(gb, wx));
    }
  }
  __syncthreads();
  for (int i = 0; i < rows; ++i) {
    const int ox = org[2 * i], oy = org[2 * i + 1];
    const float* w = win + i * S2;
    // the row's lines that some cell clamps onto
    const int ylo = oy < 0 ? 0 : (oy > H - 1 ? H - 1 : oy);
    const int yhi = oy + S - 1 < 0 ? 0 : (oy + S - 1 > H - 1 ? H - 1 : oy + S - 1);
    const int elo = ylo * W, ehi = (yhi + 1) * W;
    float* row = lv.grad[l] + (n0 + i) * HW;
    for (int e = threadIdx.x; e < HW; e += BWD_THREADS) {
      float v = 0.f;
      if (e >= elo && e < ehi) {
        const int y = e / W, x = e - y * W;
        int ylo_c, yhi_c, xlo_c, xhi_c;
        cell_range(y, oy, H, S, ylo_c, yhi_c);
        cell_range(x, ox, W, S, xlo_c, xhi_c);
        for (int cy = ylo_c; cy <= yhi_c; ++cy)
          for (int cx = xlo_c; cx <= xhi_c; ++cx) v = __fadd_rn(v, w[cy * S + cx]);
      }
      row[e] = v;
    }
  }
}

int bad_args(int64_t N, int L, int r, const int* h, const int* w) {
  if (N <= 0 || L <= 0 || L > MAX_LEVELS || r < 0 || r > 15) return 1;
  for (int l = 0; l < L; ++l)
    if (h[l] <= 0 || w[l] <= 0) return 1;
  return 0;
}

}  // namespace

extern "C" {

// Forward.  levels[l]: (N, h[l], w[l]) float32 contiguous, l < L <= 8;
// coords (N, 2) float32 (x, y in pixels of level 0); out (N, L * (2r + 1)^2)
// float32.  One launch.  Returns a cudaError_t (0 = launched).
int ofd_corr_lookup_fwd(const void* const* levels, const int* h, const int* w, int L,
                        const void* coords, void* out, long long N, int r, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_args(N, L, r, h, w)) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < L; ++l) {
    lv.corr[l] = static_cast<const float*>(levels[l]);
    lv.h[l] = h[l];
    lv.w[l] = w[l];
  }
  const int64_t total = (int64_t)N * L * (2 * r + 1) * (2 * r + 1);
  const int64_t blocks = (total + FWD_THREADS - 1) / FWD_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  lookup_fwd_kernel<<<(unsigned)blocks, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(coords), static_cast<float*>(out), N, L, r);
  return (int)cudaGetLastError();
}

// Backward.  grads[l]: (N, h[l], w[l]) float32, written whole (zeros where
// no tap lands); coords as above; g (N, L * (2r + 1)^2) float32, the
// cotangent of the forward's out.  One launch.
int ofd_corr_lookup_bwd(void* const* grads, const int* h, const int* w, int L,
                        const void* coords, const void* g, long long N, int r, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_args(N, L, r, h, w)) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < L; ++l) {
    lv.grad[l] = static_cast<float*>(grads[l]);
    lv.h[l] = h[l];
    lv.w[l] = w[l];
  }
  const int rows = bwd_rows(r), S = 2 * r + 4;
  const int64_t blocks = (N + rows - 1) / rows;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * (S * S * 4 + 8);
  lookup_bwd_kernel<<<dim3((unsigned)blocks, L), BWD_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(coords), static_cast<const float*>(g), N, L, r);
  return (int)cudaGetLastError();
}

const char* ofd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
