// Polylines stereo rasterizer for Hopper (sm_90a): a parallel stable sort
// per row, then a sweep that decides each sub-pixel part on its own.
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
//  * segments are ordered by their start x, stably;
//  * a sweep over the sub-pixel parts of each output pixel keeps the active
//    segment list with the host kernel's swap-with-last removal, so ties of
//    closeness break exactly as there (first best in active-list order);
//  * everything is f64, and the library is built with -fmad=false so no
//    product is fused into an add the host kernel rounds separately.
//
// The host loop is a chain: each of a 1080p row's ~5,700 parts waits on
// the active list the part before left.  The design breaks it:
//  * polylines_sort (one CTA per row) replaces the serial insertion sort:
//    a bitonic sort in shared memory on (x, point index), a total order and
//    so exactly the stable order, ~80 parallel passes for a 1080p row.  It
//    writes each segment in sorted order with everything the sweep needs:
//    both ends' x and closeness, 1 / length (the sweep's ratio then takes
//    two FMA corrections, not a division) and its end columns' colours, so
//    the sweep follows no index and reads no image.
//  * polylines_sweep (one CTA per row, a thread per column).  Why the
//    choice is exact without the list: pushes take every segment that
//    starts below the part's centre xc, removals every one that ends below
//    it, and xc never falls along a row, so after a part's steps the active
//    set is {x0 < xc <= x1}, whatever came before.  The host loop picks the
//    only active segment, else the first greatest closeness among the
//    candidates in list order, else the first on the list: the list's order
//    matters only at a tie of the greatest closeness, or where two or more
//    are active and none is a candidate.  So a thread finds each part of
//    its column (a binary search for the first), and the part's live set
//    in a window of the sorted starts: down from the last start below xc
//    until top[] (the running maximum of the ends, a warp scan at the
//    row's start, in the row's scratch) falls below xc.  Where the order
//    decides, the thread rebuilds the list by the host loop's pushes and
//    swap-with-last removals on indices, from the nearest earlier part
//    whose live set held at most one segment (its list is that set) or
//    the row's start, in 32 slots of the row's scratch.  A row with a
//    point that is not finite, whose centres fall somewhere, or whose
//    replay outgrows its slots runs the host loop whole on one thread.
//    Each thread sums its column's colours in part order, so every f64
//    operation is the host loop's.  The kernel counts its parts, the
//    parts it replayed and the rows it ran whole.
//
// What bounds it on the H100: not bytes (an eye reads its image and f64
// map and writes the eye once: 8.7 us at 1080p), nor f64 arithmetic.  The
// row's set-up (top[]) takes ~0.07 ms of a ~0.22 ms smooth 1080p sweep;
// the rest is each thread's chain of dependent steps per part (its
// centre, push pointer, window, closeness, colours) with lanes of a warp
// on columns of unequal part counts.  Prefetching the next columns' lines
// into L2 did not help, so HBM latency is not what it waits on.  The
// window holds ~1 entry on smooth maps and ~22 on random ones (every
// pixel a depth of its own), where most of a random map's time goes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr double kEps = 1e-7;
constexpr int kSortThreads = 512;
constexpr int kSweepThreads = 128;   // a CTA of the sweep: one row
constexpr int kListSlots = 32;       // a thread's replay list
constexpr int kSweepBlocks = 9;      // CTAs an SM holds: 1080 rows at once
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScan = 4;              // window entries loaded together

int segments(int w, int sharp) { return sharp ? 2 * w + 1 : w + 1; }

int pow2_at_least(int n) {
    int p = 2;
    while (p < n) p <<= 1;
    return p;
}

long long sort_bytes(int w, int sharp) {   // keys, idx, columns' x and |d|
    const long long p2 = pow2_at_least(segments(w, sharp));
    return (p2 * 12 + 16LL * w + 15) & ~15LL;
}

// the sweep's scratch per row, in ints: top[] (a float a segment), and the
// replay lists (kListSlots a thread, and room for every segment)
int sweep_top_len(int w, int sharp) { return (segments(w, sharp) + 3) & ~3; }
int sweep_list_len(int w, int sharp) {
    const int n = segments(w, sharp), all = kSweepThreads * kListSlots;
    return ((n > all ? n : all) + 3) & ~3;
}

int max_dynamic_smem() {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return v;
}

// source column of polyline point q
__device__ __forceinline__ int pcol(int q, int n_pt, int w, bool single) {
    return q == 0 ? 0
                  : (q == n_pt - 1 ? w - 1 : (single ? q - 1 : (q - 1) >> 1));
}

// order-preserving key of an f64 (larger value, larger key; never 0 for a
// number above -1e-7)
__device__ __forceinline__ unsigned long long okey(double v) {
    const long long b = __double_as_longlong(v);
    return b >= 0 ? (unsigned long long)b | 0x8000000000000000ULL
                  : ~(unsigned long long)b;
}

// The sort key of a point: x ascending with -0.0 equal to 0.0 and NaN
// after every number (torch.sort's order).  With the point index as the
// tie-break the order is total, so sorting by it gives the stable order.
__device__ __forceinline__ unsigned long long sort_key(double x) {
    return isnan(x) ? ~0ULL : okey(x + 0.0);
}

// Stage A: one CTA per row, from ep = nd^exponent.  Outputs, each (rows,
// stride): sx0 (start x,
// and sx0[n_seg] = 2w, the last point), sx1 (end x), sd0, sd1 (closeness
// at start and end), srcp (1 / (end x - start x)), srgb (the colours of
// the start and end columns: byte ch and byte 4 + ch for channel ch),
// sorder (start point index), in sorted order.
__global__ void __launch_bounds__(kSortThreads)
polylines_sort(const uint8_t* __restrict__ image,
               const double* __restrict__ ep, double* __restrict__ sx0,
               double* __restrict__ sx1, double* __restrict__ sd0,
               double* __restrict__ sd1, double* __restrict__ srcp,
               unsigned long long* __restrict__ srgb, int* __restrict__ sorder,
               unsigned char* __restrict__ gscratch, long long row_bytes,
               int w, int c, int p2, int stride, double divergence_px,
               double separation_px, int sharp) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int r = blockIdx.x;
    unsigned char* base = gscratch ? gscratch + r * row_bytes : smem;
    unsigned long long* key = (unsigned long long*)base;   // p2
    double* cx = (double*)(key + p2);   // w: the column's x
    double* ad = cx + w;                // w: its |d|
    int* idx = (int*)(ad + w);          // p2
    const bool single = !sharp;
    const double half = sharp ? 0.45 : 0.0;
    const int n_pt = single ? w + 2 : 2 * w + 2;
    const int n_seg = n_pt - 1;
    const double* epr = ep + (size_t)r * w;
    for (int col = threadIdx.x; col < w; col += blockDim.x) {
        const double coord_d = epr[col] * divergence_px;
        cx[col] = col + 0.5 + coord_d + separation_px;
        ad[col] = fabs(coord_d);
    }
    __syncthreads();
    auto px = [&](int q) -> double {
        if (q == 0) return -1.0 * w;
        if (q == n_pt - 1) return 2.0 * w;
        if (single) return cx[q - 1];
        const double x = cx[(q - 1) >> 1];
        return ((q - 1) & 1) ? x + half : x - half;
    };
    auto pd = [&](int q) -> double {
        return (q == 0 || q == n_pt - 1) ? 0.0
                                         : ad[single ? q - 1 : (q - 1) >> 1];
    };
    for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        key[i] = i < n_seg ? sort_key(px(i)) : ~0ULL;   // pads sort last
        idx[i] = i;
    }
    __syncthreads();
    // bitonic sort of (key, idx)
    for (int k = 2; k <= p2; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int t = threadIdx.x; t < p2 / 2; t += blockDim.x) {
                const int lo = 2 * t - (t & (j - 1));
                const int hi = lo + j;
                const unsigned long long kl = key[lo], kh = key[hi];
                const int il = idx[lo], ih = idx[hi];
                const bool h_first = kh < kl || (kh == kl && ih < il);
                if (h_first == ((lo & k) == 0)) {
                    key[lo] = kh;
                    key[hi] = kl;
                    idx[lo] = ih;
                    idx[hi] = il;
                }
            }
            __syncthreads();
        }
    }
    const size_t rb = (size_t)r * stride;
    const uint8_t* img = image + (size_t)r * w * c;
    for (int s = threadIdx.x; s < n_seg; s += blockDim.x) {
        const int o = idx[s];
        const double x0 = px(o), x1 = px(o + 1);
        const uint8_t* left = img + pcol(o, n_pt, w, single) * c;
        const uint8_t* right = img + pcol(o + 1, n_pt, w, single) * c;
        unsigned long long rgb = 0;
        for (int ch = 0; ch < c; ++ch)
            rgb |= (unsigned long long)left[ch] << (8 * ch) |
                   (unsigned long long)right[ch] << (8 * (4 + ch));
        sx0[rb + s] = x0;
        sx1[rb + s] = x1;
        srcp[rb + s] = 1.0 / (x1 - x0);
        sd0[rb + s] = pd(o);
        sd1[rb + s] = pd(o + 1);
        srgb[rb + s] = rgb;
        sorder[rb + s] = o;
    }
    if (threadIdx.x == 0) sx0[rb + n_seg] = 2.0 * w;
}

// (xc - x0) / (x1 - x0), correctly rounded, from y = RN(1 / (x1 - x0)):
// one correction makes the quotient faithful, a second rounds it correctly
// (Markstein's theorem; no operand here is near under- or overflow).  Two
// FMAs each, against a ~110-cycle division.
__device__ __forceinline__ double ratio(double xc, double x0, double x1,
                                        double y) {
    const double num = xc - x0, den = x1 - x0;
    const double q0 = num * y;
    const double q1 = fma(fma(-den, q0, num), y, q0);
    return fma(fma(-den, q1, num), y, q1);
}

// an image byte as f64 (exact: 2^52 + v - 2^52), one add instead of a
// conversion
__device__ __forceinline__ double byte_f64(uint8_t v) {
    return __hiloint2double(0x43300000, v) - 4503599627370496.0;
}

// One row of polylines_sort's arrays, and the sweep's scratch for it.
struct Row {
    const double *pts, *x1, *d0, *d1, *y;   // pts: the starts, then 2w
    const unsigned long long* rgb;
    const int* o;
    const float* top;   // top[s] >= max(x1[0..s]): f32, rounded up
    int n_seg;
};

// the part of column col between sorted points j and j + 1: its centre,
// and its width in *sig (the host loop's operations)
__device__ __forceinline__ double centre(const Row& R, int col, int j,
                                         double* sig) {
    const double a = R.pts[j], b = R.pts[j + 1];
    const double colf = col, top = colf + 1;
    const double coord_from = (colf < a ? a : colf) + kEps;
    const double coord_to = (b < top ? b : top) - kEps;
    *sig = coord_to - coord_from;
    return coord_from + 0.5 * *sig;
}

// the last sorted point below x, which starts the first part of column x
// (pts[0] = -w lies below every column, pts[n_seg] = 2w above)
__device__ int last_below(const Row& R, double x) {
    int lo = 0, hi = R.n_seg;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (R.pts[mid] < x)
            lo = mid;
        else
            hi = mid;
    }
    return lo;
}

// how many segments start below xc (the host loop's push pointer there),
// searched from part j's end: pts[j] < xc < pts[j + 1] but for ties
__device__ __forceinline__ int pushed(const Row& R, int j, double xc) {
    int p = j + 1 < R.n_seg ? j + 1 : R.n_seg;
    while (p < R.n_seg && R.pts[p] < xc) ++p;
    while (p > 0 && !(R.pts[p - 1] < xc)) --p;
    return p;
}

// segment s's position ip at xc, from the sort's reciprocal
__device__ __forceinline__ double position(const Row& R, int s, double xc) {
    return ratio(xc, R.pts[s], R.x1[s], R.y[s]);
}

// segment s's closeness at position ip
__device__ __forceinline__ double closeness(const Row& R, int s, double ip) {
    return (1.0 - ip) * R.d0[s] + ip * R.d1[s];
}

// The live segments at xc (x0 < xc <= x1): among the first p, scanned
// down from p - 1 until top[] says that no segment below reaches xc, the
// ends and bounds of kScan entries loaded together.  How many are live
// (n_live, one of them in live) and, among the candidates (closeness
// above -kEps, xc strictly inside), the greatest closeness's key, how many
// reach it (n_top) and one that does (best).
struct Window {
    int n_live, live, n_top, best;
};
__device__ Window window(const Row& R, int p, double xc) {
    Window v{0, -1, 0, -1};
    unsigned long long kmax = 0;   // a candidate's key is never 0
    for (int s = p - 1; s >= 0; s -= kScan) {
        float bound[kScan];
        double end[kScan];
#pragma unroll
        for (int k = 0; k < kScan; ++k) {
            const int q = s - k > 0 ? s - k : 0;
            bound[k] = R.top[q];
            end[k] = R.x1[q];
        }
        unsigned live = 0;
        bool done = false;
#pragma unroll
        for (int k = 0; k < kScan; ++k) {
            done = done || s - k < 0 || (double)bound[k] < xc;
            if (!done && !(end[k] < xc)) live |= 1u << k;
        }
        for (; live; live &= live - 1) {
            const int q = s - (__ffs(live) - 1);
            ++v.n_live;
            v.live = q;
            const double ip = position(R, q, xc);
            const double cl = closeness(R, q, ip);
            if (cl > -kEps && 0.0 < ip && ip < 1.0) {
                const unsigned long long key = okey(cl + 0.0);   // -0 as +0
                if (key > kmax) {
                    kmax = key;
                    v.n_top = 1;
                    v.best = q;
                } else if (key == kmax) {
                    ++v.n_top;
                }
            }
        }
        if (done) break;
    }
    return v;
}

// the host loop's choice on its active list: the only segment, else the
// first greatest closeness among the candidates in list order, else the
// first on the list (-1: an empty list)
__device__ int list_choice(const Row& R, const int* list, int n, double xc) {
    int best = n > 0 ? list[0] : -1;
    if (n != 1) {
        double top = -kEps;
        for (int i = 0; i < n; ++i) {
            const double ip = position(R, list[i], xc);
            const double cl = closeness(R, list[i], ip);
            if (top < cl && 0.0 < ip && ip < 1.0) {
                top = cl;
                best = list[i];
            }
        }
    }
    return best;
}

// the host loop's push (segments starting below xc, in sorted order) and
// swap-with-last removal (segments ending below xc), on indices alone;
// false when the list would outgrow cap
__device__ __forceinline__ bool step_list(const Row& R, int* list, int& n,
                                          int& ptr, int cap, double xc) {
    while (ptr < R.n_seg && R.pts[ptr] < xc) {
        if (n == cap) return false;
        list[n++] = ptr++;
    }
    for (int i = 0; i < n;) {
        if (R.x1[list[i]] < xc)
            list[i] = list[--n];
        else
            ++i;
    }
    return true;
}

constexpr int kOverflow = -2;

// The choice at part (col, j) whose window left it to the list's order (a
// tie at the top, or two or more live and no candidate).  The list is
// rebuilt from the nearest earlier part whose live set held at most one
// segment, whose list is that set, or from the row's start, by the host
// loop's steps on indices; then the host's choice.  kOverflow when the
// list would outgrow cap.
__device__ int replay(const Row& R, int col, int j, double xc, int* list,
                      int cap) {
    int qc = col, qj = j, n = 0, ptr = 0;
    double sig;
    for (;;) {   // the previous part, until an anchor or the row's start
        if (!(R.pts[qj] < qc) && qj > 0)
            --qj;
        else if (--qc < 0)
            break;
        const double xq = centre(R, qc, qj, &sig);
        const int pq = pushed(R, qj, xq);
        const Window v = window(R, pq, xq);
        if (v.n_live <= 1) {
            n = v.n_live;
            list[0] = v.live;
            ptr = pq;
            break;
        }
    }
    bool at_start = qc < 0;
    if (at_start) {
        qc = 0;
        qj = last_below(R, 0.0);
    }
    for (;;) {   // forward to (col, j), as the host loop steps
        if (!at_start) {
            if (R.pts[qj + 1] < qc + 1.0)
                ++qj;
            else
                ++qc;
        }
        at_start = false;
        if (qc > col) return kOverflow;   // not on the walk: redo the row
        if (!step_list(R, list, n, ptr, cap, centre(R, qc, qj, &sig)))
            return kOverflow;
        if (qc == col && qj == j) break;
    }
    return list_choice(R, list, n, xc);
}

// the chosen segment's colour over a part of width sig, added to the
// column's channels
__device__ __forceinline__ void add_part(const Row& R, int best, double xc,
                                         double sig, int c, int n_pt,
                                         bool single, double* color) {
    const unsigned long long rgb = R.rgb[best];
    const int o = R.o[best];
    // the start and end columns are the same one for the sentinels'
    // segments and (sharp) a pixel's own segment
    if (o == 0 || o == n_pt - 2 || (!single && (o & 1))) {
#pragma unroll
        for (int ch = 0; ch < kMaxChannels; ++ch)
            if (ch < c)
                color[ch] += byte_f64((uint8_t)(rgb >> (8 * ch))) * sig;
    } else {
        const double ip = position(R, best, xc);
#pragma unroll
        for (int ch = 0; ch < kMaxChannels; ++ch)
            if (ch < c) {
                const double vl = byte_f64((uint8_t)(rgb >> (8 * ch)));
                const double vr = byte_f64((uint8_t)(rgb >> (8 * ch + 32)));
                color[ch] += (vl * (1.0 - ip) + vr * ip) * sig;
            }
    }
}

__device__ __forceinline__ void put_column(uint8_t* orow, int col, int c,
                                           const double* color) {
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch)
        if (ch < c) {
            const double v = color[ch];
            orow[col * c + ch] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
}

// The host loop itself, on one thread, the active list in the row's list
// area (room for every segment): for a row with a point that is not
// finite, whose part centres fall somewhere (the window's rule holds where
// they never fall), or where a replay outgrew its slots.  Returns the
// row's parts.
__device__ unsigned long long whole_row(const Row& R, uint8_t* orow,
                                        int* list, int w, int c, int n_pt,
                                        bool single) {
    unsigned long long parts = 0;
    int pt = 0, ptr = 0, n = 0;
    for (int col = 0; col < w; ++col) {
        double color[kMaxChannels] = {0.5, 0.5, 0.5, 0.5};
        while (pt < R.n_seg && R.pts[pt] < col) ++pt;
        if (pt > 0) --pt;
        while (pt < R.n_seg && R.pts[pt] < col + 1.0) {
            double sig;
            const double xc = centre(R, col, pt, &sig);
            ++parts;
            step_list(R, list, n, ptr, R.n_seg, xc);
            const int best = list_choice(R, list, n, xc);
            if (best >= 0)
                add_part(R, best, xc, sig, c, n_pt, single, color);
            ++pt;
        }
        put_column(orow, col, c, color);
    }
    return parts;
}

// The sweep's counters on each card, in the module's own device memory
// (not an allocation of the caller's): parts swept, parts whose choice was
// replayed from the list's order, rows run whole by whole_row.
__device__ unsigned long long g_sweep_counts[3];

// Stage B: one CTA per row, a thread per column (col = thread, + the CTA's
// width, ...).  scratch (rows, top_len + list_len) ints: the running
// maximum of the ends (f32) and the replay lists (kListSlots a thread, or
// the whole area for a whole row).  g_sweep_counts += (parts, parts
// replayed, rows replayed whole).
__global__ void __launch_bounds__(kSweepThreads, kSweepBlocks)
polylines_sweep(uint8_t* __restrict__ out, const double* __restrict__ sx0,
                const double* __restrict__ sx1, const double* __restrict__ sd0,
                const double* __restrict__ sd1, const double* __restrict__ srcp,
                const unsigned long long* __restrict__ srgb,
                const int* __restrict__ sorder, int* __restrict__ scratch,
                int w, int c, int sharp, int stride, int top_len,
                int list_len) {
    __shared__ double warp_top[kSweepWarps];
    __shared__ int s_whole;
    __shared__ unsigned long long s_parts, s_replayed;
    const int tid = threadIdx.x;
    const int r = blockIdx.x;
    const bool single = !sharp;
    const int n_pt = single ? w + 2 : 2 * w + 2;
    const int n_seg = n_pt - 1;
    const size_t rb = (size_t)r * stride;
    int* area = scratch + (size_t)r * (top_len + list_len);
    float* top = (float*)area;
    int* list = area + top_len;
    const Row R{sx0 + rb,  sx1 + rb,    sd0 + rb, sd1 + rb, srcp + rb,
                srgb + rb, sorder + rb, top,      n_seg};
    uint8_t* orow = out + (size_t)r * w * c;
    if (tid == 0) {
        s_whole = 0;
        s_parts = 0;
        s_replayed = 0;
    }

    // top[]: the running maximum of the ends.  Each warp takes a quarter
    // of the row, 32 entries at a time across its lanes: its maximum
    // first, then a scan by shuffles from the maxima of the quarters
    // before.  A point that is not finite sends the row to whole_row.
    const int lane = tid & 31, warp = tid >> 5;
    const int span = ((n_seg + kSweepWarps - 1) / kSweepWarps + 31) & ~31;
    const int lo = min(warp * span, n_seg), hi = min(lo + span, n_seg);
    double run = -INFINITY;
    bool finite = true;
    for (int s = lo + lane; s < hi; s += 32) {
        const double x1 = R.x1[s];
        finite = finite && isfinite(x1);
        run = x1 > run ? x1 : run;
    }
    for (int d = 16; d > 0; d >>= 1) {
        const double u = __shfl_xor_sync(kFull, run, d);
        run = u > run ? u : run;
    }
    if (lane == 0) warp_top[warp] = run;
    __syncthreads();
    run = -INFINITY;
    for (int k = 0; k < warp; ++k) run = warp_top[k] > run ? warp_top[k] : run;
    for (int base = lo; base < hi; base += 32) {
        const int q = base + lane;
        double v = q < hi ? R.x1[q] : -INFINITY;
        for (int d = 1; d < 32; d <<= 1) {
            const double u = __shfl_up_sync(kFull, v, d);
            if (lane >= d && u > v) v = u;
        }
        v = run > v ? run : v;
        run = __shfl_sync(kFull, v, 31);
        if (q >= hi) continue;
        top[q] = __double2float_ru(v);
        finite = finite && isfinite(R.pts[q]);
    }
    const bool whole = __syncthreads_or(!finite);

    // each part's choice from its window; the list's order only where the
    // choice depends on it
    unsigned long long parts = 0, replayed = 0;
    bool redo = whole;
    int* mine = list + tid * kListSlots;
    for (int col = tid; col < w && !redo; col += kSweepThreads) {
        int j = last_below(R, col);
        double sig;
        // the centres never fall: the last part of column col - 1 is the
        // one from the same point j
        double prev = col > 0 ? centre(R, col - 1, j, &sig) : -INFINITY;
        double color[kMaxChannels] = {0.5, 0.5, 0.5, 0.5};
        for (;;) {
            const double xc = centre(R, col, j, &sig);
            ++parts;
            if (xc < prev) {
                redo = true;
                break;
            }
            prev = xc;
            const Window v = window(R, pushed(R, j, xc), xc);
            int best = v.n_live <= 1 ? v.live : v.best;
            if (v.n_live > 1 && v.n_top != 1) {
                ++replayed;
                best = replay(R, col, j, xc, mine, kListSlots);
                if (best == kOverflow) {
                    redo = true;
                    break;
                }
            }
            if (best >= 0)
                add_part(R, best, xc, sig, c, n_pt, single, color);
            if (!(R.pts[j + 1] < col + 1.0)) break;
            ++j;
        }
        if (!redo) put_column(orow, col, c, color);
    }
    if (redo) s_whole = 1;
    atomicAdd(&s_parts, parts);
    if (replayed) atomicAdd(&s_replayed, replayed);
    __syncthreads();
    if (tid == 0) {
        unsigned long long p = s_parts, q = s_replayed;
        if (s_whole) {
            p = whole_row(R, orow, list, w, c, n_pt, single);
            q = 0;
            atomicAdd(&g_sweep_counts[2], 1ULL);
        }
        atomicAdd(&g_sweep_counts[0], p);
        if (q) atomicAdd(&g_sweep_counts[1], q);
    }
}

}  // namespace

extern "C" {

// Bytes of device scratch per row that polylines_sort needs when its
// arrays do not fit in shared memory; 0 when they do.
long long polylines_sort_scratch_bytes(int w, int sharp) {
    const long long need = sort_bytes(w, sharp);
    return need <= max_dynamic_smem() ? 0 : need;
}

// Ints of device scratch per row that polylines_sweep needs: the running
// maximum of the ends (f32), then the replay lists.
int polylines_sweep_scratch_ints(int w, int sharp) {
    return sweep_top_len(w, sharp) + sweep_list_len(w, sharp);
}

// Stage A.  image (rows, w, c) uint8, ep = nd^exponent (rows, w) f64
// (computed as the plain version does); sorted (5, rows,
// stride) f64 (start x, end x, closeness at start and end, 1 / length),
// rgb (rows, stride) uint64 and order (rows, stride) int, stride >= the
// number of segments + 1; scratch: rows x polylines_sort_scratch_bytes, or
// null when that is 0.  Returns a cudaError_t.
int polylines_sort_forward(const void* image, const void* ep, void* sorted,
                           void* rgb, void* order, void* scratch, int rows,
                           int w, int c, int stride, double divergence_px,
                           double separation_px, int sharp, void* stream) {
    if (rows < 1 || w < 1 || c < 1 || c > kMaxChannels ||
        stride < segments(w, sharp) + 1)
        return (int)cudaErrorInvalidValue;
    const long long need = sort_bytes(w, sharp);
    const bool in_smem = need <= max_dynamic_smem();
    if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int smem = in_smem ? (int)need : 0;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            polylines_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    double* s = (double*)sorted;
    const size_t plane = (size_t)rows * stride;
    polylines_sort<<<rows, kSortThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)image, (const double*)ep, s, s + plane, s + 2 * plane,
        s + 3 * plane, s + 4 * plane, (unsigned long long*)rgb, (int*)order,
        in_smem ? nullptr : (unsigned char*)scratch, need, w, c,
        pow2_at_least(segments(w, sharp)), stride, divergence_px,
        separation_px, sharp);
    return (int)cudaGetLastError();
}

// Stage B.  out (rows, w, c) uint8; sorted, rgb, order from stage A;
// scratch (rows, polylines_sweep_scratch_ints) int.  Returns a cudaError_t.
int polylines_sweep_forward(void* out, const void* sorted, const void* rgb,
                            const void* order, void* scratch,
                            int rows, int w, int c, int stride, int sharp,
                            void* stream) {
    if (rows < 1 || w < 1 || c < 1 || c > kMaxChannels ||
        stride < segments(w, sharp) + 1)
        return (int)cudaErrorInvalidValue;
    const double* s = (const double*)sorted;
    const size_t plane = (size_t)rows * stride;
    polylines_sweep<<<rows, kSweepThreads, 0, (cudaStream_t)stream>>>(
        (uint8_t*)out, s, s + plane, s + 2 * plane, s + 3 * plane,
        s + 4 * plane, (const unsigned long long*)rgb, (const int*)order,
        (int*)scratch, w, c, sharp, stride,
        sweep_top_len(w, sharp), sweep_list_len(w, sharp));
    return (int)cudaGetLastError();
}

// The sweep's counters on card device, added into out[0..2], or (reset)
// set to 0, once the card has finished its work.  Returns a cudaError_t.
int polylines_sweep_counts(int device, unsigned long long* out, int reset) {
    int old = 0;
    cudaError_t e = cudaGetDevice(&old);
    if (e == cudaSuccess) e = cudaSetDevice(device);
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
    if (e != cudaSuccess) return (int)e;
    unsigned long long v[3] = {0, 0, 0};
    e = reset ? cudaMemcpyToSymbol(g_sweep_counts, v, sizeof v)
              : cudaMemcpyFromSymbol(v, g_sweep_counts, sizeof v);
    for (int k = 0; k < 3 && out; ++k) out[k] += v[k];
    const cudaError_t back = cudaSetDevice(old);
    return (int)(e != cudaSuccess ? e : back);
}

const char* polylines_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
