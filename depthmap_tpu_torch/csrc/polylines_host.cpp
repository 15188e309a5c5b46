// Polylines stereo rasterizer on the host (kernel K2's CPU path).
//
// The f64 sort-and-sweep of depthmap_tpu/native/polylines.cpp, restated
// for the port (it imports nothing of the JAX package): each image row
// becomes a polyline, morphed by the per-pixel disparity, stably sorted,
// and rasterized with closest-segment (max-divergence) selection per
// sub-pixel part.  ops/host_build.py builds it with g++ at first use
// (-ffp-contract=off, no -march=native, so no FMA contraction moves a
// byte) and ops/polylines.py runs it for CPU tensors; polylines_plain is
// its oracle, and csrc/polylines.cu the same function on the card.
//
// Semantics (byte-exact with the reference):
//  * EPSILON = 1e-7, sharp pixels get +-0.45 half-width bodies
//  * insertion-sort tie behavior == stable sort by x
//  * the active-segment set reduces to the predicate x0 < xc <= x1
//  * default segment when no interior-qualifying candidate exists is the
//    earliest-added active segment
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

void polylines_row(const uint8_t* image_row, const double* nd_row,
                   int w, int c, double divergence_px, double separation_px,
                   double exponent, int sharp, uint8_t* out_row) {
    const double EPS = 1e-7;
    const double HALF = sharp ? 0.45 : 0.0;

    struct Pt { double x, d; int col; };
    struct Sg { double x0, d0; int c0; double x1, d1; int c1; };

    std::vector<Pt> pt;
    pt.reserve(2 * w + 3);
    pt.push_back({-1.0 * w, 0.0, 0});
    for (int col = 0; col < w; ++col) {
        double coord_d = std::pow(nd_row[col], exponent) * divergence_px;
        double coord_x = col + 0.5 + coord_d + separation_px;
        if (HALF < EPS) {
            pt.push_back({coord_x, std::fabs(coord_d), col});
        } else {
            pt.push_back({coord_x - HALF, std::fabs(coord_d), col});
            pt.push_back({coord_x + HALF, std::fabs(coord_d), col});
        }
    }
    pt.push_back({2.0 * w, 0.0, w - 1});

    const int n_pt = (int)pt.size();
    const int sg_end = n_pt - 1;
    std::vector<Sg> sg(sg_end);
    for (int i = 0; i < sg_end; ++i)
        sg[i] = {pt[i].x, pt[i].d, pt[i].col,
                 pt[i + 1].x, pt[i + 1].d, pt[i + 1].col};

    // stable sort points (with their outgoing segments) by x
    std::vector<int> order(sg_end);
    for (int i = 0; i < sg_end; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int a, int b) { return pt[a].x < pt[b].x; });
    std::vector<Pt> pts(n_pt);
    std::vector<Sg> sgs(sg_end);
    for (int i = 0; i < sg_end; ++i) { pts[i] = pt[order[i]]; sgs[i] = sg[order[i]]; }
    pts[sg_end] = pt[n_pt - 1];

    // rasterize with an explicit active set (mirrors the reference's csg)
    std::vector<int> active;
    active.reserve(64);
    int sg_pointer = 0;
    int pt_i = 0;
    std::vector<double> color(c);
    for (int col = 0; col < w; ++col) {
        for (int ch = 0; ch < c; ++ch) color[ch] = 0.5;
        while (pts[pt_i].x < col) ++pt_i;
        --pt_i;
        while (pts[pt_i].x < col + 1) {
            double coord_from = std::max((double)col, pts[pt_i].x) + EPS;
            double coord_to = std::min((double)col + 1, pts[pt_i + 1].x) - EPS;
            double significance = coord_to - coord_from;
            double xc = coord_from + 0.5 * significance;

            while (sg_pointer < sg_end && sgs[sg_pointer].x0 < xc) {
                active.push_back(sg_pointer);
                ++sg_pointer;
            }
            // drop segments that ended (swap-with-last, as the reference)
            for (size_t i = 0; i < active.size();) {
                if (sgs[active[i]].x1 < xc) {
                    active[i] = active.back();
                    active.pop_back();
                } else {
                    ++i;
                }
            }
            int best = active.empty() ? -1 : active[0];
            if (active.size() != 1) {
                double best_closeness = -EPS;
                for (int idx : active) {
                    const Sg& s = sgs[idx];
                    double ip_k = (xc - s.x0) / (s.x1 - s.x0);
                    double closeness = (1.0 - ip_k) * s.d0 + ip_k * s.d1;
                    if (best_closeness < closeness && 0.0 < ip_k && ip_k < 1.0) {
                        best_closeness = closeness;
                        best = idx;
                    }
                }
            }
            if (best >= 0) {
                const Sg& s = sgs[best];
                int col_l = (int)(s.c0 + EPS);
                int col_r = (int)(s.c1 + EPS);
                if (col_l == col_r) {
                    for (int ch = 0; ch < c; ++ch)
                        color[ch] += image_row[col_l * c + ch] * significance;
                } else {
                    double ip_k = (xc - s.x0) / (s.x1 - s.x0);
                    for (int ch = 0; ch < c; ++ch)
                        color[ch] += (image_row[col_l * c + ch] * (1.0 - ip_k)
                                      + image_row[col_r * c + ch] * ip_k)
                                     * significance;
                }
            }
            ++pt_i;
        }
        for (int ch = 0; ch < c; ++ch) {
            double v = color[ch];
            out_row[col * c + ch] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
}

void polylines(const uint8_t* image, const double* nd, int h, int w, int c,
               double divergence_px, double separation_px, double exponent,
               int sharp, uint8_t* out) {
    // rows are independent (the reference uses numba prange the same way)
    unsigned n_threads = std::thread::hardware_concurrency();
    if (n_threads == 0) n_threads = 1;
    n_threads = std::min<unsigned>(n_threads, (unsigned)h);
    if (n_threads <= 1) {
        for (int row = 0; row < h; ++row)
            polylines_row(image + (size_t)row * w * c, nd + (size_t)row * w,
                          w, c, divergence_px, separation_px, exponent,
                          sharp, out + (size_t)row * w * c);
        return;
    }
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < n_threads; ++t) {
        threads.emplace_back([=]() {
            for (int row = (int)t; row < h; row += (int)n_threads)
                polylines_row(image + (size_t)row * w * c,
                              nd + (size_t)row * w, w, c, divergence_px,
                              separation_px, exponent, sharp,
                              out + (size_t)row * w * c);
        });
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
