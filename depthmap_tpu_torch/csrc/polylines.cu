// Polylines stereo rasterizer for Hopper (sm_90a): one row per warp.
//
// Replaces the Pallas TPU kernel depthmap_tpu/ops/polylines_pallas.py
// (polylines_rasterize_pallas -> _rasterize_rows, body _make_kernel).  The
// specification is the f64 sort-and-sweep of depthmap_tpu/native/
// polylines.cpp:26 (polylines_row), the reference's
// stereoimage_generation.py:162-283, and the output is byte-exact against
// it:
//  * every pixel morphs to x = col + 0.5 + nd^exponent * divergence_px +
//    separation_px (two points at x -+ 0.45 when sharp), with sentinels at
//    -w and 2w; consecutive points form segments;
//  * segments are ordered by their start x with a stable insertion sort
//    (points move at most ~|divergence_px| from their place, so the sort is
//    near linear);
//  * a sweep over the sub-pixel parts of each output pixel keeps the active
//    segment list with the host kernel's swap-with-last removal, so ties of
//    closeness break exactly as there (first best in active-list order);
//  * everything is f64, and the library is built with -fmad=false so no
//    product is fused into an add the host kernel rounds separately.
//
// What bounds it on the H100: the sweep is sequential inside a row and
// branchy, so it is bound by the latency of each row's dependent loads of
// its scratch (points, sort order, active list), not by bandwidth or
// flops.  Rows of one warp would diverge at every branch and run one
// after another, so each row runs as its own one-thread block (a warp of
// its own; a 1080p image puts ~8 rows on each of the 132 SMs), and its
// scratch is contiguous so the row's loads share cache lines.  Measured
// on an H100 at 1080p: 64 threads per block with scratch interleaved
// across rows took ~4.7x longer (random depth) to ~4.2x (smooth depth).
// Splitting a row's sweep across the lanes of its warp is the follow-up.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;

__global__ void polylines_rows(const uint8_t* __restrict__ image,
                               const double* __restrict__ nd,
                               uint8_t* __restrict__ out,
                               double* __restrict__ px,
                               double* __restrict__ pd,
                               double* __restrict__ sx,
                               int* __restrict__ order,
                               int* __restrict__ active, int w, int c,
                               double divergence_px, double separation_px,
                               double exponent, int sharp) {
    const int r = blockIdx.x;
    const size_t stride = 2 * (size_t)w + 2;
#define AT(arr, i) arr[r * stride + (size_t)(i)]
    const double EPS = 1e-7;
    const double HALF = sharp ? 0.45 : 0.0;
    const uint8_t* img = image + (size_t)r * w * c;
    const double* ndr = nd + (size_t)r * w;
    uint8_t* o = out + (size_t)r * w * c;
    const bool single = HALF < EPS;
    const int n_pt = single ? w + 2 : 2 * w + 2;
    const int sg_end = n_pt - 1;

    // points in polyline order
    AT(px, 0) = -1.0 * w;
    AT(pd, 0) = 0.0;
    int p = 1;
    for (int col = 0; col < w; ++col) {
        const double nv = ndr[col];
        const double e = exponent == 1.0 ? nv : pow(nv, exponent);
        const double coord_d = e * divergence_px;
        const double coord_x = col + 0.5 + coord_d + separation_px;
        const double ad = fabs(coord_d);
        if (single) {
            AT(px, p) = coord_x;
            AT(pd, p) = ad;
            ++p;
        } else {
            AT(px, p) = coord_x - HALF;
            AT(pd, p) = ad;
            AT(px, p + 1) = coord_x + HALF;
            AT(pd, p + 1) = ad;
            p += 2;
        }
    }
    AT(px, p) = 2.0 * w;
    AT(pd, p) = 0.0;

    // stable insertion sort of the segment starts (points 0..sg_end-1)
    for (int i = 0; i < sg_end; ++i) {
        const double xv = AT(px, i);
        int u = i - 1;
        while (u >= 0 && AT(sx, u) > xv) {
            AT(sx, u + 1) = AT(sx, u);
            AT(order, u + 1) = AT(order, u);
            --u;
        }
        AT(sx, u + 1) = xv;
        AT(order, u + 1) = i;
    }
    AT(sx, sg_end) = AT(px, sg_end);

    // column of polyline point q
#define PCOL(q) ((q) == 0 ? 0 : ((q) == n_pt - 1 ? w - 1 \
                 : (single ? (q) - 1 : ((q) - 1) >> 1)))

    int n_active = 0;
    int sg_pointer = 0;
    int pt_i = 0;
    double color[kMaxChannels];
    for (int col = 0; col < w; ++col) {
        for (int ch = 0; ch < c; ++ch) color[ch] = 0.5;
        while (AT(sx, pt_i) < col) ++pt_i;
        --pt_i;
        while (AT(sx, pt_i) < col + 1) {
            const double a = AT(sx, pt_i);
            const double bnext = AT(sx, pt_i + 1);
            // std::max / std::min semantics of the host kernel
            const double coord_from = ((double)col < a ? a : (double)col) + EPS;
            const double top = (double)col + 1;
            const double coord_to = (bnext < top ? bnext : top) - EPS;
            const double significance = coord_to - coord_from;
            const double xc = coord_from + 0.5 * significance;

            while (sg_pointer < sg_end && AT(sx, sg_pointer) < xc) {
                AT(active, n_active) = sg_pointer;
                ++n_active;
                ++sg_pointer;
            }
            // drop segments that ended (swap-with-last, as the host kernel)
            for (int i = 0; i < n_active;) {
                const int s = AT(active, i);
                if (AT(px, AT(order, s) + 1) < xc) {
                    AT(active, i) = AT(active, n_active - 1);
                    --n_active;
                } else {
                    ++i;
                }
            }
            int best = n_active == 0 ? -1 : AT(active, 0);
            if (n_active != 1) {
                double best_closeness = -EPS;
                for (int i = 0; i < n_active; ++i) {
                    const int s = AT(active, i);
                    const int o0 = AT(order, s);
                    const double x0 = AT(sx, s);
                    const double x1 = AT(px, o0 + 1);
                    const double ip_k = (xc - x0) / (x1 - x0);
                    const double closeness =
                        (1.0 - ip_k) * AT(pd, o0) + ip_k * AT(pd, o0 + 1);
                    if (best_closeness < closeness && 0.0 < ip_k && ip_k < 1.0) {
                        best_closeness = closeness;
                        best = s;
                    }
                }
            }
            if (best >= 0) {
                const int o0 = AT(order, best);
                const int col_l = PCOL(o0);
                const int col_r = PCOL(o0 + 1);
                if (col_l == col_r) {
                    for (int ch = 0; ch < c; ++ch)
                        color[ch] += img[col_l * c + ch] * significance;
                } else {
                    const double x0 = AT(sx, best);
                    const double x1 = AT(px, o0 + 1);
                    const double ip_k = (xc - x0) / (x1 - x0);
                    for (int ch = 0; ch < c; ++ch)
                        color[ch] += (img[col_l * c + ch] * (1.0 - ip_k)
                                      + img[col_r * c + ch] * ip_k)
                                     * significance;
                }
            }
            ++pt_i;
        }
        for (int ch = 0; ch < c; ++ch) {
            const double v = color[ch];
            o[col * c + ch] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
#undef PCOL
#undef AT
}

}  // namespace

extern "C" {

// image (rows, w, c) uint8, nd (rows, w) f64, out (rows, w, c) uint8.
// Scratch, each (rows, 2w + 2) row-major: px, pd, sx (doubles), order,
// active (ints).  Returns a cudaError_t.
int polylines_forward(const void* image, const void* nd, void* out, void* px,
                      void* pd, void* sx, void* order, void* active, int rows,
                      int w, int c, double divergence_px, double separation_px,
                      double exponent, int sharp, void* stream) {
    if (rows < 1 || w < 1 || c < 1 || c > kMaxChannels)
        return (int)cudaErrorInvalidValue;
    polylines_rows<<<rows, 1, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)image, (const double*)nd, (uint8_t*)out, (double*)px,
        (double*)pd, (double*)sx, (int*)order, (int*)active, w, c,
        divergence_px, separation_px, exponent, sharp);
    return (int)cudaGetLastError();
}

const char* polylines_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
