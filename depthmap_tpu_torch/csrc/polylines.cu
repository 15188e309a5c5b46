// Polylines stereo rasterizer for Hopper (sm_90a): a parallel stable sort
// per row, then a sweep with one warp per row.
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
// What bounds it on the H100: not bytes (an eye reads its image and f64
// map and writes the eye once: 8.7 us at 1080p) but the latency of each
// row's chain of sweep steps: ~5,700 parts per 1080p row, each depending on
// the active list the one before left, and only ~8 rows per SM to overlap.
// The design takes everything that does not depend on that list off the
// chain and keeps the list in registers:
//  * polylines_sort (one CTA per row) replaces the serial insertion sort:
//    a bitonic sort in shared memory on (x, point index), a total order and
//    so exactly the stable order, ~80 parallel passes for a 1080p row.  It
//    writes each segment in sorted order with everything the sweep needs:
//    both ends' x and closeness, 1 / length (the sweep's ratio then takes
//    two FMA corrections, not a division) and its end columns' colours, so
//    the sweep follows no index and reads no image.
//  * polylines_sweep (one warp per row, 4 rows per CTA, all rows resident):
//    every lane runs the same step loop.  The sorted arrays are forward
//    streams, a chunk of 32 entries one per lane, the next one prefetched,
//    handed out by __shfl_sync.  Slot i of the active list lives in lane
//    i % 32, in registers for the first 32 slots and in a per-row spill
//    area beyond (a lane reads and writes only its own spill cells).  The
//    removal is a ballot, and the swap-with-last order is its closed form:
//    the k-th dead slot below the new length m takes the k-th live slot
//    counted from the end.  The best segment is the first maximum of the
//    closeness in list order: __reduce_max_sync on an order-preserving
//    key, a ballot, __ffs; it is chosen on the layout before the removal's
//    moves, by each slot's position after them, so it does not wait for
//    the moves' shuffles.  Lane ch accumulates channel ch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr double kEps = 1e-7;
constexpr int kSortThreads = 512;
constexpr int kSweepWarps = 4;       // rows per CTA of the sweep
constexpr unsigned kFull = 0xffffffffu;

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

// one segment on the active list: y = 1 / (x1 - x0), rgb its end columns'
// colours (as srgb), o its start point
struct Seg {
    double x0, x1, d0, d1, y;
    unsigned long long rgb;
    int o;
};
constexpr int kSegWords = 7;   // a spilled slot: one 64-bit word a field

__device__ __forceinline__ Seg shfl_seg(const Seg& s, int src) {
    return Seg{__shfl_sync(kFull, s.x0, src), __shfl_sync(kFull, s.x1, src),
               __shfl_sync(kFull, s.d0, src), __shfl_sync(kFull, s.d1, src),
               __shfl_sync(kFull, s.y, src), __shfl_sync(kFull, s.rgb, src),
               __shfl_sync(kFull, s.o, src)};
}

// (xc - x0) / (x1 - x0), correctly rounded, from y = RN(1 / (x1 - x0)):
// one correction makes the quotient faithful, a second rounds it correctly
// (Markstein's theorem; no operand here is near under- or overflow).  Two
// FMAs each, against a ~110-cycle division.
__device__ __forceinline__ double ratio(double xc, const Seg& s) {
    const double num = xc - s.x0, den = s.x1 - s.x0;
    const double q0 = num * s.y;
    const double q1 = fma(fma(-den, q0, num), s.y, q0);
    return fma(fma(-den, q1, num), s.y, q1);
}

// an image byte as f64 (exact: 2^52 + v - 2^52), one add instead of a
// conversion
__device__ __forceinline__ double byte_f64(uint8_t v) {
    return __hiloint2double(0x43300000, v) - 4503599627370496.0;
}

// the bit position of the (k+1)-th highest / lowest set bit of x (x has
// more than k set bits), by binary search on the count above a position
__device__ __forceinline__ int kth_highest(unsigned x, int k) {
    int p = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
        if (__popc(x >> (p + step)) > k) p += step;
    return p;
}
__device__ __forceinline__ int kth_lowest(unsigned x, int k) {
    return 31 - kth_highest(__brev(x), k);
}

// lanes below n (n may lie outside 0..32)
__device__ __forceinline__ unsigned lanes_below(int n) {
    return n <= 0 ? 0u : (n >= 32 ? kFull : (1u << n) - 1u);
}

// Stage B: one warp per row.  spill (rows, kSegWords, spill) holds the
// active slots 32 and above.
__global__ void __launch_bounds__(kSweepWarps * 32)
polylines_sweep(uint8_t* __restrict__ out, const double* __restrict__ sx0,
                const double* __restrict__ sx1, const double* __restrict__ sd0,
                const double* __restrict__ sd1, const double* __restrict__ srcp,
                const unsigned long long* __restrict__ srgb,
                const int* __restrict__ sorder,
                unsigned long long* __restrict__ spill_words, int rows, int w,
                int c, int sharp, int stride, int spill) {
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * kSweepWarps + (threadIdx.x >> 5);
    if (r >= rows) return;
    const bool single = !sharp;
    const int n_pt = single ? w + 2 : 2 * w + 2;
    const int n_seg = n_pt - 1;
    uint8_t* orow = out + (size_t)r * w * c;
    const size_t rb = (size_t)r * stride;
    const double* X0 = sx0 + rb;
    const double* X1 = sx1 + rb;
    const double* D0 = sd0 + rb;
    const double* D1 = sd1 + rb;
    const double* Y = srcp + rb;
    const unsigned long long* RGB = srgb + rb;
    const int* OR = sorder + rb;
    unsigned long long* sp = spill_words + (size_t)r * kSegWords * spill;

    // this lane's slot of group g (slots 32g .. 32g + 31), and its update:
    // group 0 in registers, the others spilled (g may differ by lane; a
    // spilled slot is read and written only by its own lane)
    Seg reg{0.0, 0.0, 0.0, 0.0, 0.0, 0, 0};
    auto get = [&](int g) -> Seg {
        if (g == 0) return reg;
        const unsigned long long* e = sp + (g - 1) * 32 + lane;
        return Seg{__longlong_as_double(e[0]), __longlong_as_double(e[spill]),
                   __longlong_as_double(e[2 * spill]),
                   __longlong_as_double(e[3 * spill]),
                   __longlong_as_double(e[4 * spill]), e[5 * spill],
                   (int)e[6 * spill]};
    };
    auto put = [&](int g, const Seg& s) {
        if (g == 0) {
            reg = s;
            return;
        }
        unsigned long long* e = sp + (g - 1) * 32 + lane;
        e[0] = __double_as_longlong(s.x0);
        e[spill] = __double_as_longlong(s.x1);
        e[2 * spill] = __double_as_longlong(s.d0);
        e[3 * spill] = __double_as_longlong(s.d1);
        e[4 * spill] = __double_as_longlong(s.y);
        e[5 * spill] = s.rgb;
        e[6 * spill] = (unsigned long long)s.o;
    };

    // the sorted points, read forward: pts[i] for i = 0, 1, 2, ...
    int p_base = 0;
    double p_cur = X0[lane];
    double p_nxt = 32 + lane < stride ? X0[32 + lane] : 0.0;
    auto pts = [&](int i) -> double {
        if (i >= p_base + 32) {
            p_base += 32;
            p_cur = p_nxt;
            const int e = p_base + 32 + lane;
            p_nxt = e < stride ? X0[e] : 0.0;
        }
        return __shfl_sync(kFull, p_cur, i - p_base);
    };
    // the sorted segments, read forward by the push pointer
    auto load_seg = [&](int e) -> Seg {
        return e < stride
                   ? Seg{X0[e], X1[e], D0[e], D1[e], Y[e], RGB[e], OR[e]}
                   : Seg{0.0, 0.0, 0.0, 0.0, 0.0, 0, 0};
    };
    int s_base = 0;
    Seg s_cur = load_seg(lane);
    Seg s_nxt = load_seg(32 + lane);
    int sg_pointer = 0;
    double next_x0 = __shfl_sync(kFull, s_cur.x0, 0);

    int n_active = 0;
    // consecutive sorted points a, b, and the one after (read a part ahead)
    double a = pts(0), b = pts(1), nb = pts(2);
    int pj = 2;
    double color = 0.5;   // lane ch < c: channel ch of the column
    const int shift = 8 * (lane < c ? lane : 0);
    for (int col = 0; col < w; ++col) {
        const double colf = col, top = colf + 1;
        while (b < colf) {
            a = b;
            b = nb;
            nb = pts(++pj);
        }
        for (;;) {
            // the part [max(col, a), min(col + 1, b)] and its centre
            const double coord_from = (colf < a ? a : colf) + kEps;
            const double coord_to = (b < top ? b : top) - kEps;
            const double significance = coord_to - coord_from;
            const double xc = coord_from + 0.5 * significance;

            // push the segments that start before xc
            while (sg_pointer < n_seg && next_x0 < xc) {
                const int i = sg_pointer - s_base;
                const Seg s = shfl_seg(s_cur, i);
                next_x0 = __shfl_sync(kFull, i < 31 ? s_cur.x0 : s_nxt.x0,
                                      (i + 1) & 31);
                if (lane == (n_active & 31)) put(n_active >> 5, s);
                ++n_active;
                if (++sg_pointer == s_base + 32) {
                    s_base += 32;
                    s_cur = s_nxt;
                    s_nxt = load_seg(s_base + 32 + lane);
                }
            }

            // the closest segment's ip and start point (uniform)
            double best_ip = 0.0;
            int best_o = -1;
            unsigned long long best_rgb = 0;
            if (n_active <= 32) {
                // every slot in reg.  The removal (swap-with-last) moves
                // the k-th live slot from the end into the k-th dead slot
                // below the new length m.  The best segment is chosen on the
                // layout before that move, by its position after it, so the
                // choice does not wait for the move's shuffles.
                Seg& s0 = reg;
                const bool live = lane < n_active && !(s0.x1 < xc);
                const unsigned alive = __ballot_sync(kFull, live);
                const int m = __popc(alive);
                const unsigned front = lanes_below(m);
                const unsigned holes = ~alive & front;
                const unsigned srcs = alive & ~front;
                const bool hole = (holes >> lane) & 1u;
                const double ipl = ratio(xc, s0);
                const double cl = (1.0 - ipl) * s0.d0 + ipl * s0.d1;
                const bool cand = live && cl > -kEps && 0.0 < ipl && ipl < 1.0;
                if (m > 0) {
                    // the slot at position 0 after the move: lane 0, or the
                    // last live slot when lane 0 died
                    int bl = (alive & 1u) ? 0 : 31 - __clz(alive);
                    if (m > 1) {
                        // first maximum: the key's high word, then on a tie
                        // its low word (a candidate's closeness is never
                        // -0.0, so equal keys are equal values)
                        const unsigned long long key = cand ? okey(cl) : 0;
                        const unsigned khi = (unsigned)(key >> 32);
                        const unsigned hi = __reduce_max_sync(kFull, khi);
                        unsigned hit = __ballot_sync(kFull, cand && khi == hi);
                        if (__popc(hit) > 1) {
                            bool tie = (hit >> lane) & 1u;
                            const unsigned lo = __reduce_max_sync(
                                kFull, tie ? (unsigned)key : 0u);
                            tie = tie && (unsigned)key == lo;
                            // the lowest position after the move
                            const int above =
                                __popc(srcs & ~lanes_below(lane + 1));
                            const int pos =
                                lane < m ? lane : kth_lowest(holes, above);
                            const unsigned first = __reduce_min_sync(
                                kFull, tie ? (unsigned)pos : 32u);
                            hit = __ballot_sync(kFull,
                                                tie && pos == (int)first);
                        }
                        if (hit) bl = __ffs(hit) - 1;
                    }
                    best_ip = __shfl_sync(kFull, ipl, bl);
                    best_o = __shfl_sync(kFull, s0.o, bl);
                    best_rgb = __shfl_sync(kFull, s0.rgb, bl);
                }
                if (holes) {
                    // the k-th hole takes the k-th live slot from the end
                    int src = lane;
                    if (hole) {
                        unsigned from = srcs;
                        for (int k = __popc(holes & lanes_below(lane)); k > 0;
                             --k)
                            from &= ~(1u << (31 - __clz(from)));
                        src = 31 - __clz(from);
                    }
                    const Seg moved = shfl_seg(s0, src);
                    if (hole) s0 = moved;
                }
                n_active = m;
            } else {
                // more than 32 slots: the same removal and choice, group by
                // group, the removal's moves one at a time
                int ng = (n_active + 31) >> 5;
                auto alive_mask = [&](int g) -> unsigned {
                    return __ballot_sync(kFull, 32 * g + lane < n_active &&
                                                    !(get(g).x1 < xc));
                };
                int m = 0;
                for (int g = 0; g < ng; ++g) m += __popc(alive_mask(g));
                if (m < n_active) {
                    int hg = -1, sgp = ng;
                    unsigned holes = 0, srcs = 0;
                    for (;;) {
                        while (holes == 0 && 32 * (hg + 1) < m) {
                            ++hg;
                            holes = ~alive_mask(hg) & lanes_below(m - 32 * hg);
                        }
                        if (holes == 0) break;
                        while (srcs == 0) {
                            --sgp;
                            srcs = alive_mask(sgp) & ~lanes_below(m - 32 * sgp);
                        }
                        const int p = 32 * hg + __ffs(holes) - 1;
                        holes &= holes - 1;
                        const int qb = 31 - __clz(srcs);
                        srcs &= ~(1u << qb);
                        const Seg s = shfl_seg(get(sgp), qb);
                        if (lane == (p & 31)) put(p >> 5, s);
                    }
                    n_active = m;
                    ng = (m + 31) >> 5;
                }
                if (n_active > 0) {
                    // this lane's slot of group g: its ratio, the key of its
                    // closeness, and whether it is a candidate
                    auto closeness = [&](int g, double& ip,
                                         unsigned long long& key) -> bool {
                        const Seg s = get(g);
                        ip = ratio(xc, s);
                        const double cl = (1.0 - ip) * s.d0 + ip * s.d1;
                        key = okey(cl);
                        return 32 * g + lane < n_active && cl > -kEps &&
                               0.0 < ip && ip < 1.0;
                    };
                    double ip;
                    unsigned long long key, kmax = 0;
                    for (int g = 0; g < ng; ++g)
                        if (closeness(g, ip, key) && key > kmax) kmax = key;
                    int best = 0;
                    const unsigned hi =
                        __reduce_max_sync(kFull, (unsigned)(kmax >> 32));
                    const unsigned lo = __reduce_max_sync(
                        kFull,
                        (unsigned)(kmax >> 32) == hi ? (unsigned)kmax : 0u);
                    const unsigned long long top =
                        (unsigned long long)hi << 32 | lo;
                    for (int g = 0; top != 0 && g < ng; ++g) {
                        const bool cand = closeness(g, ip, key);
                        const unsigned hit =
                            __ballot_sync(kFull, cand && key == top);
                        if (hit) {
                            best = 32 * g + __ffs(hit) - 1;
                            break;
                        }
                    }
                    // its ip and start point, from the lane that holds it
                    closeness(best >> 5, ip, key);
                    const Seg s = get(best >> 5);
                    best_ip = __shfl_sync(kFull, ip, best & 31);
                    best_o = __shfl_sync(kFull, s.o, best & 31);
                    best_rgb = __shfl_sync(kFull, s.rgb, best & 31);
                }
            }
            if (best_o >= 0) {
                // the start and end columns are the same one for the
                // sentinels' segments and (sharp) a pixel's own segment
                const double vl = byte_f64((uint8_t)(best_rgb >> shift));
                if (best_o == 0 || best_o == n_pt - 2 ||
                    (!single && (best_o & 1))) {
                    color += vl * significance;
                } else {
                    const double vr =
                        byte_f64((uint8_t)(best_rgb >> (shift + 32)));
                    color += (vl * (1.0 - best_ip) + vr * best_ip) *
                             significance;
                }
            }
            if (!(b < top)) break;
            a = b;
            b = nb;
            nb = pts(++pj);
        }
        if (lane < c)
            orow[col * c + lane] =
                (uint8_t)(color < 0 ? 0 : (color > 255 ? 255 : color));
        color = 0.5;
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

// Active slots per row that polylines_sweep may spill beyond its registers.
int polylines_spill_slots(int w, int sharp) {
    const int groups = (segments(w, sharp) + 31) / 32 - 1;   // after reg
    return 32 * (groups > 1 ? groups : 1);
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

// Stage B.  out (rows, w, c) uint8; sorted, rgb, order from stage A; spill
// (rows, 7, spill) uint64 with spill = polylines_spill_slots.  Returns a
// cudaError_t.
int polylines_sweep_forward(void* out, const void* sorted, const void* rgb,
                            const void* order, void* spill, int rows, int w,
                            int c, int stride, int spill_slots, int sharp,
                            void* stream) {
    if (rows < 1 || w < 1 || c < 1 || c > kMaxChannels ||
        stride < segments(w, sharp) + 1 ||
        spill_slots < polylines_spill_slots(w, sharp))
        return (int)cudaErrorInvalidValue;
    const double* s = (const double*)sorted;
    const size_t plane = (size_t)rows * stride;
    const int blocks = (rows + kSweepWarps - 1) / kSweepWarps;
    polylines_sweep<<<blocks, kSweepWarps * 32, 0, (cudaStream_t)stream>>>(
        (uint8_t*)out, s, s + plane, s + 2 * plane, s + 3 * plane,
        s + 4 * plane, (const unsigned long long*)rgb, (const int*)order,
        (unsigned long long*)spill, rows, w, c, sharp, stride, spill_slots);
    return (int)cudaGetLastError();
}

const char* polylines_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
