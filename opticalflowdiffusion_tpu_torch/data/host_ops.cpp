// Host helpers of the data readers: the two steps that are sequential by
// nature and too slow in numpy, and the bilinear resize, whose numpy gathers
// hold the GIL against the training loop's thread.
//
//   ofd_png_unfilter   undo the five PNG row filters (None, Sub, Up, Average,
//                      Paeth) of a decompressed image stream; Average and
//                      Paeth need each byte's left neighbour after its own
//                      reconstruction.
//   ofd_inpaint_ns     cv2.inpaint(..., INPAINT_NS) of one float32 channel:
//                      a fast-marching front over the masked pixels, each
//                      filled from the known pixels within the radius with
//                      OpenCV's isophote weights (photo/src/inpaint.cpp,
//                      icvNSInpaintFMM), in the same order of visits.
//   ofd_resize_u8,     cv2.resize(INTER_LINEAR) of a uint8 (OpenCV's 11-bit
//   ofd_resize_f32     fixed point) or float32 image, as data/resize.py's
//                      numpy versions compute it.
//
// Plain C interface, bound with ctypes (data/host.py); the numpy versions of
// both live in data/png.py and data/kitti_single.py.  Built without
// floating-point contraction: the inpaint's float sums and products round
// one at a time, as OpenCV's do, so it gives cv2's values bit for bit.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <vector>

extern "C" int ofd_png_unfilter(const uint8_t* raw, int64_t height, int64_t stride, int bpp,
                                uint8_t* out) {
    const uint8_t* prior = nullptr;
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* in = raw + y * (stride + 1);
        uint8_t* row = out + y * stride;
        const int kind = in[0];
        ++in;
        switch (kind) {
        case 0:
            std::memcpy(row, in, stride);
            break;
        case 1:
            for (int64_t i = 0; i < stride; ++i)
                row[i] = uint8_t(in[i] + (i >= bpp ? row[i - bpp] : 0));
            break;
        case 2:
            for (int64_t i = 0; i < stride; ++i)
                row[i] = uint8_t(in[i] + (prior ? prior[i] : 0));
            break;
        case 3:
            for (int64_t i = 0; i < stride; ++i) {
                const int a = i >= bpp ? row[i - bpp] : 0;
                const int b = prior ? prior[i] : 0;
                row[i] = uint8_t(in[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int64_t i = 0; i < stride; ++i) {
                const int a = i >= bpp ? row[i - bpp] : 0;
                const int b = prior ? prior[i] : 0;
                const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
                const int p = a + b - c;
                const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                row[i] = uint8_t(in[i] + pred);
            }
            break;
        default:
            return -1 - int(y);
        }
        prior = row;
    }
    return 0;
}

namespace {

enum : uint8_t { KNOWN = 0, BAND = 1, INSIDE = 2 };

struct Node {
    float t;
    int64_t seq;
    int i, j;
};

// OpenCV's queue is a sorted list that puts a new entry after every entry of
// no greater time: pop order is (time, order of pushes)
struct Later {
    bool operator()(const Node& a, const Node& b) const {
        return a.t > b.t || (a.t == b.t && a.seq > b.seq);
    }
};

float solve(int i1, int j1, int i2, int j2, const std::vector<uint8_t>& f,
            const std::vector<float>& t, int ecols) {
    const double a11 = t[i1 * ecols + j1], a22 = t[i2 * ecols + j2];
    const double m12 = a11 < a22 ? a11 : a22;
    double sol;
    if (f[i1 * ecols + j1] != INSIDE) {
        if (f[i2 * ecols + j2] != INSIDE) {
            if (std::fabs(a11 - a22) >= 1.0)
                sol = 1 + m12;
            else
                sol = (a11 + a22 + std::sqrt(2 - (a11 - a22) * (a11 - a22))) * 0.5;
        } else {
            sol = 1 + a11;
        }
    } else if (f[i2 * ecols + j2] != INSIDE) {
        sol = 1 + a22;
    } else {
        sol = 1 + m12;
    }
    return float(sol);
}

}  // namespace

// src, dst: (channels, rows, cols) float32, each channel filled as
// cv2.inpaint fills it alone (the front's order depends on the mask only, so
// one pass serves every channel); mask: (rows, cols), nonzero = fill.  dst
// starts as a copy of src.  Returns the pixels filled.
extern "C" int64_t ofd_inpaint_ns(const float* src, const uint8_t* mask, int channels, int rows,
                                  int cols, double radius, float* dst) {
    int range = int(std::lrint(radius));
    range = range < 1 ? 1 : (range > 100 ? 100 : range);
    const int erows = rows + 2, ecols = cols + 2;
    const size_t plane = size_t(rows) * cols;
    std::memcpy(dst, src, sizeof(float) * plane * channels);
    // f: the state of each pixel of the frame padded by one on every side
    std::vector<uint8_t> f(size_t(erows) * ecols, KNOWN), inside(size_t(erows) * ecols, 0);
    std::vector<float> t(size_t(erows) * ecols, 1.0e6f);
    for (int i = 0; i < rows; ++i)
        for (int j = 0; j < cols; ++j)
            if (mask[size_t(i) * cols + j]) inside[size_t(i + 1) * ecols + j + 1] = 1;
    std::priority_queue<Node, std::vector<Node>, Later> heap;
    int64_t seq = 0;
    // the narrow band: known pixels 4-adjacent to a masked one, in raster order
    for (int i = 1; i < erows - 1; ++i)
        for (int j = 1; j < ecols - 1; ++j) {
            const size_t p = size_t(i) * ecols + j;
            if (inside[p]) {
                f[p] = INSIDE;
            } else if (inside[p - 1] || inside[p + 1] || inside[p - ecols] || inside[p + ecols]) {
                f[p] = BAND;
                t[p] = 0.0f;
                heap.push({0.0f, seq++, i, j});
            }
        }
    // the disc: for each row offset its column half-width, and the distance
    // weight 1 / (|r|^4 + 1) of each offset
    const int side = 2 * range + 1;
    std::vector<int> half(side);
    std::vector<float> dist_w(size_t(side) * side);
    for (int dk = -range; dk <= range; ++dk) {
        int h = 0;
        while (int64_t(h + 1) * (h + 1) + int64_t(dk) * dk <= int64_t(range) * range) ++h;
        half[dk + range] = h;
        for (int dl = -range; dl <= range; ++dl) {
            const float ry = float(dk), rx = float(dl);
            const float len = rx * rx + ry * ry;
            dist_w[size_t(dk + range) * side + dl + range] = 1.0f / (len * len + 1.0f);
        }
    }
    std::vector<float> Ia(channels), s(channels);
    int64_t filled = 0;
    while (!heap.empty()) {
        const Node top = heap.top();
        heap.pop();
        const int ii = top.i, jj = top.j;
        f[size_t(ii) * ecols + jj] = KNOWN;
        for (int q = 0; q < 4; ++q) {
            int i, j;
            if (q == 0) { i = ii - 1; j = jj; }
            else if (q == 1) { i = ii; j = jj - 1; }
            else if (q == 2) { i = ii + 1; j = jj; }
            else { i = ii; j = jj + 1; }
            if (i <= 0 || j <= 0 || i > erows - 1 || j > ecols - 1) continue;
            if (f[size_t(i) * ecols + j] != INSIDE) continue;
            float d1 = solve(i - 1, j, i, j - 1, f, t, ecols);
            float d2 = solve(i + 1, j, i, j - 1, f, t, ecols);
            float d3 = solve(i - 1, j, i, j + 1, f, t, ecols);
            float d4 = solve(i + 1, j, i, j + 1, f, t, ecols);
            float dist = d1 < d2 ? d1 : d2;
            dist = dist < d3 ? dist : d3;
            dist = dist < d4 ? dist : d4;
            t[size_t(i) * ecols + j] = dist;
            for (int c = 0; c < channels; ++c) {
                Ia[c] = 0.0f;
                s[c] = 1.0e-20f;
            }
            const int k0 = i - range > 1 ? i - range : 1;
            const int k1 = i + range < erows - 2 ? i + range : erows - 2;
            for (int k = k0; k <= k1; ++k) {
                const int km = k - 1 + (k == 1), kp = k - 1 - (k == erows - 2);
                const int h = half[k - i + range];
                const int l0 = j - h > 1 ? j - h : 1;
                const int l1 = j + h < ecols - 2 ? j + h : ecols - 2;
                const uint8_t* frow = f.data() + size_t(k) * ecols;
                const float* wrow = dist_w.data() + size_t(k - i + range) * side + range - j;
                const float ry = float(k - i);
                for (int l = l0; l <= l1; ++l) {
                    if (frow[l] == INSIDE) continue;
                    const int lm = l - 1 + (l == 1), lp = l - 1 - (l == ecols - 2);
                    const float rx = float(l - j);
                    const float len = rx * rx + ry * ry;
                    const bool dn = frow[l + ecols] != INSIDE, up = frow[l - ecols] != INSIDE;
                    const bool rt = frow[l + 1] != INSIDE, lf = frow[l - 1] != INSIDE;
                    for (int c = 0; c < channels; ++c) {
                        const float* o = dst + plane * c;
                        auto out = [&](int y, int x) -> float { return o[size_t(y) * cols + x]; };
                        float gx, gy;
                        if (dn) {
                            if (up)
                                gx = std::fabs(out(kp + 1, lm) - out(kp, lm)) +
                                     std::fabs(out(kp, lm) - out(km - 1, lm));
                            else
                                gx = std::fabs(out(kp + 1, lm) - out(kp, lm)) * 2.0f;
                        } else {
                            gx = up ? std::fabs(out(kp, lm) - out(km - 1, lm)) * 2.0f : 0.0f;
                        }
                        if (rt) {
                            if (lf)
                                gy = std::fabs(out(km, lp + 1) - out(km, lm)) +
                                     std::fabs(out(km, lm) - out(km, lm - 1));
                            else
                                gy = std::fabs(out(km, lp + 1) - out(km, lm)) * 2.0f;
                        } else {
                            gy = lf ? std::fabs(out(km, lm) - out(km, lm - 1)) * 2.0f : 0.0f;
                        }
                        gx = -gx;
                        float dir = rx * gx + ry * gy;
                        if (std::fabs(dir) <= 0.01f) {
                            dir = 0.000001f;
                        } else {
                            const float glen = gx * gx + gy * gy;
                            dir = std::fabs(dir / std::sqrt(len * glen));
                        }
                        const float w = wrow[l] * dir;
                        Ia[c] += w * out(k - 1, l - 1);
                        s[c] += w;
                    }
                }
            }
            for (int c = 0; c < channels; ++c)
                dst[plane * c + size_t(i - 1) * cols + (j - 1)] = float(double(Ia[c]) / s[c]);
            ++filled;
            f[size_t(i) * ecols + j] = BAND;
            heap.push({dist, seq++, i, j});
        }
    }
    return filled;
}

namespace {

// the source index and float32 fraction of each destination pixel along one
// axis, as OpenCV's resize computes them; clamp folds positions past either
// edge onto the edge with fraction 0 (columns; rows clamp their indices only)
void positions(int dst, int src, bool clamp, std::vector<int>& idx, std::vector<float>& frac) {
    const double scale = 1.0 / (double(dst) / double(src));
    idx.resize(dst);
    frac.resize(dst);
    for (int d = 0; d < dst; ++d) {
        float f = float((d + 0.5) * scale - 0.5);
        int i = int(std::floor(f));
        f -= float(i);
        if (clamp && i < 0) { i = 0; f = 0.0f; }
        if (clamp && i >= src - 1) { i = src - 1; f = 0.0f; }
        idx[d] = i;
        frac[d] = f;
    }
}

int fixed(float w) { return int(std::lrint(w * 2048.0f)); }

}  // namespace

// src (h, w, c) -> dst (H, W, c), uint8, cv2's INTER_LINEAR bit for bit.
extern "C" void ofd_resize_u8(const uint8_t* src, int h, int w, int c, uint8_t* dst, int H,
                              int W) {
    std::vector<int> sx, sy;
    std::vector<float> fx, fy;
    positions(W, w, true, sx, fx);
    positions(H, h, false, sy, fy);
    std::vector<int> a0(W), a1(W), x0(W), x1(W);
    for (int x = 0; x < W; ++x) {
        a0[x] = fixed(1.0f - fx[x]);
        a1[x] = fixed(fx[x]);
        x0[x] = sx[x] * c;
        x1[x] = (sx[x] + 1 < w ? sx[x] + 1 : w - 1) * c;
    }
    // the row pass of the two source rows an output row reads, each once
    std::vector<int> buf[2] = {std::vector<int>(size_t(W) * c), std::vector<int>(size_t(W) * c)};
    int held[2] = {-1, -1};
    auto row = [&](int r) -> const int* {
        for (int k = 0; k < 2; ++k)
            if (held[k] == r) return buf[k].data();
        const int k = held[0] == -1 || (held[1] != -1 && held[0] < held[1]) ? 0 : 1;
        const uint8_t* s = src + size_t(r) * w * c;
        int* o = buf[k].data();
        for (int x = 0; x < W; ++x)
            for (int ch = 0; ch < c; ++ch)
                o[size_t(x) * c + ch] = (s[x0[x] + ch] * a0[x] + s[x1[x] + ch] * a1[x]) >> 4;
        held[k] = r;
        return o;
    };
    for (int y = 0; y < H; ++y) {
        const int r0 = sy[y] < 0 ? 0 : (sy[y] > h - 1 ? h - 1 : sy[y]);
        const int r1 = sy[y] + 1 < 0 ? 0 : (sy[y] + 1 > h - 1 ? h - 1 : sy[y] + 1);
        const int b0 = fixed(1.0f - fy[y]), b1 = fixed(fy[y]);
        const int* p0 = row(r0);
        const int* p1 = row(r1);
        uint8_t* o = dst + size_t(y) * W * c;
        for (size_t i = 0; i < size_t(W) * c; ++i)
            o[i] = uint8_t((((b0 * p0[i]) >> 16) + ((b1 * p1[i]) >> 16) + 2) >> 2);
    }
}

// src (h, w, c) -> dst (H, W, c), float32: each pass's two products rounded
// and added in float32.
extern "C" void ofd_resize_f32(const float* src, int h, int w, int c, float* dst, int H,
                               int W) {
    std::vector<int> sx, sy;
    std::vector<float> fx, fy;
    positions(W, w, true, sx, fx);
    positions(H, h, false, sy, fy);
    std::vector<int> x0(W), x1(W);
    for (int x = 0; x < W; ++x) {
        x0[x] = sx[x] * c;
        x1[x] = (sx[x] + 1 < w ? sx[x] + 1 : w - 1) * c;
    }
    std::vector<float> buf[2] = {std::vector<float>(size_t(W) * c),
                                 std::vector<float>(size_t(W) * c)};
    int held[2] = {-1, -1};
    auto row = [&](int r) -> const float* {
        for (int k = 0; k < 2; ++k)
            if (held[k] == r) return buf[k].data();
        const int k = held[0] == -1 || (held[1] != -1 && held[0] < held[1]) ? 0 : 1;
        const float* s = src + size_t(r) * w * c;
        float* o = buf[k].data();
        for (int x = 0; x < W; ++x) {
            const float a0 = 1.0f - fx[x], a1 = fx[x];
            for (int ch = 0; ch < c; ++ch) {
                const float u = s[x0[x] + ch] * a0;
                const float v = s[x1[x] + ch] * a1;
                o[size_t(x) * c + ch] = u + v;
            }
        }
        held[k] = r;
        return o;
    };
    for (int y = 0; y < H; ++y) {
        const int r0 = sy[y] < 0 ? 0 : (sy[y] > h - 1 ? h - 1 : sy[y]);
        const int r1 = sy[y] + 1 < 0 ? 0 : (sy[y] + 1 > h - 1 ? h - 1 : sy[y] + 1);
        const float b0 = 1.0f - fy[y], b1 = fy[y];
        const float* p0 = row(r0);
        const float* p1 = row(r1);
        float* o = dst + size_t(y) * W * c;
        for (size_t i = 0; i < size_t(W) * c; ++i) {
            const float u = p0[i] * b0;
            const float v = p1[i] * b1;
            o[i] = u + v;
        }
    }
}
