// Flash attention forward with an additive bias, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel depthmap_tpu/ops/flash_attention.py
// (flash_attention, bodies _kernel_single and _kernel): out =
// softmax(q.k^T * scale + bias) . v with an exact online softmax.
//
// Semantics kept from the TPU kernel, in both bodies:
//  * q.k^T is taken on input-dtype values with f32 accumulation (f32 in
//    split TF32, below, at f32 accuracy);
//  * the running max m, running sum l and the output accumulator are f32;
//  * p is rounded to the input dtype before p.v, l sums the unrounded p;
//  * a row whose sum is 0 yields 0;
//  * keys at or beyond kv_len are masked to -inf by a select, and a ragged
//    edge tile never reads out of bounds (out-of-range rows load as 0);
//  * the bias is (1, H, N, Nk), shared across the batch, or (B, H, N, Nk),
//    with rows of `ldb` elements (a multiple of 16; the columns past Nk
//    are never read), heads and batch packed behind the rows.
//
// Table mode (BEiT's relative-position bias, each body's REL = true
// instance).  Replaces the streamed tier of the JAX package
// (depthmap_tpu/models/attention.py attention_rel_streamed: a (chunk, N)
// bias tile gathered per 512-query chunk, then the Pallas call on it).
// Here no bias is materialized: the kernel reads each bias value from the
// block's (H, T) table, T = (2gh-1)(2gw-1)+3, held in f32 (a bf16 value
// widens exactly) in rows padded to 16 bytes, at the index timm's
// gen_relative_position_index gives the pair (token 0 is cls; tokens t >=
// 1 sit at row (t-1) / gw, column (t-1) % gw of the gh x gw grid):
//    idx = (r1 - r2 + gh - 1)(2gw - 1) + (c1 - c2 + gw - 1)
//        = base(t1) - off(t2),  base = (r1 + gh - 1)(2gw-1) + c1 + gw - 1,
//                               off = r2 (2gw - 1) + c2,
// and num_rel / num_rel + 1 / num_rel + 2 for cls -> token / token -> cls
// / cls -> cls.
//  * The window.  base() and off() rise with the token, so every non-cls
//    index of a query tile against a kv tile lies in one range of the
//    head's row, [base(qf) - off(kl), base(ql) - off(kf)] (first / last
//    tokens of each tile, tokens past N taken as N - 1, cls as token 1).
//    Each stage's bias slot, which this mode fills with no bias tile (16
//    KB in the bf16 instance, 32 KB in the f32 one), holds that range
//    widened to 16-byte bounds (one cp.async.bulk on the stage's
//    mbarrier, a tile ahead as K and V), the kv tile's 64 off() values
//    (a bulk copy from the per-grid int32 table the wrapper builds once,
//    as byte offsets, 4 off()) and, from each stage's first fill on, the
//    16-byte span of the row that holds the three cls entries.  The
//    range is at most rel_tile_span(rows, gw) + rel_tile_span(BK, gw) + 1
//    entries, plus the widening; the launch refuses a grid whose bound
//    does not fit the slot (gw <= 1946 in bf16, 3962 in f32; the UI's
//    largest net, 2048, gives gw = 128).
//  * The index.  Each thread works out base() of its two query rows and
//    of the CTA's first query once; a score's entry is window[(base - lo)
//    - off], lo from the staged off() of the tile's last key: per score
//    one integer subtraction of the staged byte offset from the row's
//    address, and one shared-memory load; no division.  Only query tile 0
//    and kv tile 0 hold a cls row or column; that branch is uniform per
//    tile, and only those tiles run the selects.
//  * Under the tensor cores.  The 32 loads of a thread complete while the
//    tensor cores compute S (bf16: issued just before S's wgmma; f32:
//    between its commit and its wait, where the f32 body's registers
//    allow it), and the window of the tile two ahead is worked out by the
//    thread that refills the stage (f32: while S runs).
// The table value is the input dtype's and enters the same fmaf(x, scale,
// b) as a materialized bias's: the answer is the materialized-bias call's,
// bit for bit.  The call moves q, k, v, out and the table once: its bound
// is the operations, 4.B.H.N^2.D (at (1, 16, 16385) 1.11 ms of bf16
// tensor time against 2.57 ms of bias bytes alone for the materialized
// call).
//
// Two bodies, chosen by dtype, both on the tensor cores; neither falls
// back to the other.
//
// bf16 (the main path).  At the BEiT-L shapes (D = 64,
// N = 1025 or 1793) a call moves q, k, v, out and the bias once (67 MB at
// (4, 16, 1025) with a shared bias) against 4.B.H.N^2.D flops (17 GFLOP):
// about 20 us of memory time and 17 us of bf16 tensor time on an H100, so
// the kernel has to keep both the copy engine and the tensor cores busy.
// One CTA (one warpgroup, 128 threads) owns 64 query rows; on the H100 a
// second warpgroup (128 rows) or a third stage measured slower at the
// batched shape (4, 16, 1025), where 64-row CTAs fit three to an SM
// (PERF.md, "Build variants"):
//  * Q arrives once by TMA; K, V and the bias tile arrive by TMA into a
//    ring of STAGES stages, each reported by an mbarrier, so tile j+1 is in
//    flight while tile j is computed.  Every tile is 64 rows of 128 bytes
//    in the 128-byte swizzle that TMA writes and wgmma reads.
//  * S = Q.K^T is four wgmma m64n64k16 (Q and K from shared memory, both
//    K-major); the softmax runs in registers on the accumulator layout:
//    one FMA adds the bias to the scaled score, and one FMA before each
//    ex2.approx moves it to log2 space (log2e and the row max folded in);
//    the 4 lanes of a row reduce its max by shuffles and keep partial
//    sums, reduced once at the end.
//  * Each tile's P.V is four wgmma into an accumulator of its own, with P
//    from registers (the S accumulator is the A-fragment layout once
//    rounded to bf16) and V from shared memory as stored (MN-major, the
//    transposed-B form), then O = O.alpha + tile in f32 (the tensor cores'
//    sums round toward zero: one accumulator over every tile drifted by a
//    signed 1.9e-5 from f64 at 10,765 keys); alpha comes from the
//    difference of the maxima, exactly 1 while the max holds.  (Adding a
//    tile to O during the next tile's S measured slower: ptxas waits on
//    the wgmma there.)
//  * The grid runs batch fastest, so the CTAs of one (head, query tile)
//    read a shared bias tile close together in time and find it in L2.
//  * q, k, v are described to TMA as (64, N, B.H): a head's ragged last
//    tile reads zeros, never the next head's rows.
//
// f32 (Marigold's UNet, every f32 path): split TF32 ("3xTF32").  The tensor
// cores take f32 only as TF32 (10 mantissa bits; one pass errs ~1e-3 at
// the check's inputs, far from f32).  With x = hi + lo (hi = x rounded to
// TF32, lo = x - hi rounded to TF32) a product is hi.hi + hi.lo + lo.hi,
// three TF32 passes into one f32 accumulator, as accurate as f32 (~2e-6
// against the f32 plain version, which holds it to 5e-5).  At Marigold's
// (5, 5, 6912) a call moves 177 MB of q, k, v and out (53 us) against
// 3 x 4.B.H.N^2.D = 917 GFLOP of TF32 work (1.85 ms at 495 TFLOP/s): the
// tensor cores bound it, and the L2 has to feed them.
//  * A pre-pass (split_kv_f32) writes K's and V^T's hi and lo parts once a
//    call into a scratch the wrapper allocates (4x K's bytes): tf32 wgmma
//    takes both operands K-major, so V is transposed, with its keys
//    permuted inside each group of 8 so that P's A fragment is the S
//    accumulator's own registers.
//  * One CTA: two warpgroups of 64 query rows each, sharing a 2-stage ring
//    of K hi / lo, V^T hi / lo and bias tiles (64 keys, each as two
//    128-byte-swizzled boxes of 32 columns) that TMA fills; the last warp
//    done with a stage refills it.  128 rows a CTA halve the L2 bytes per
//    flop of 64-row CTAs.  (A producer warp of its own made 9 warps, 3 on
//    one of the SM's four register quarters: 168 registers a thread and
//    spills.)
//  * Q's rows are split once into A fragments in registers; S = Q.K^T is
//    24 wgmma m64n64k8 (3 passes x 8 k-steps), the softmax runs as in the
//    bf16 body, P is split in registers, and each tile's P.V is 24 more
//    into an accumulator of its own, added to O in f32 (the tensor cores'
//    sums round toward zero: one accumulator over every tile erred 4e-5 at
//    6912 keys).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim (the kernel supports only 64)
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

// --------------------------------------------------------------- bf16 body
constexpr int STAGES = 2;                  // K / V / bias ring
constexpr int TC_THREADS = 128;            // one warpgroup, 64 query rows
constexpr uint32_t TILE_BYTES = 64 * 128;  // 64 rows of 64 bf16
// Q | K[STAGES] | V[STAGES] | bias[STAGES] | mbarriers, from a
// 1024-byte aligned base (the 128-byte swizzle repeats every 8 rows =
// 1024 bytes)
constexpr uint32_t OFF_K = TILE_BYTES;
constexpr uint32_t OFF_V = OFF_K + STAGES * TILE_BYTES;
constexpr uint32_t OFF_B = OFF_V + STAGES * TILE_BYTES;
constexpr uint32_t OFF_BAR = OFF_B + STAGES * TILE_BYTES;
constexpr size_t kTcSmemBytes = 1024 + OFF_BAR + 8 * (1 + STAGES);
// table mode: a bias slot of twice a tile (its window holds f32 values),
// the mbarriers after it; three CTAs still fit an SM
constexpr uint32_t REL_SLOT = 2 * TILE_BYTES;
constexpr uint32_t OFF_BAR_REL = OFF_B + STAGES * REL_SLOT;
constexpr size_t kTcRelSmemBytes = 1024 + OFF_BAR_REL + 8 * (1 + STAGES);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase with this parity has completed.  A copy that never
// lands (a bad tensor map) traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    const long long t0 = clock64();
    while (true) {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) break;
        if (clock64() - t0 > 20000000000LL) __trap();
    }
    __syncwarp();  // the warp leaves the wait together (wgmma is .aligned)
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// wgmma shared-memory descriptor for a tile of 128-byte rows in the
// 128-byte swizzle: start address, leading offset 16 B (unused by these
// shapes), stride 1024 B between 8-row groups, layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses of wgmma's registers across the
// asynchronous instructions
__device__ __forceinline__ void reg_fence(float (&r)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define ACC32_STR                                                          \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
    "%28, %29, %30, %31}"
#define ACC32_OPS(d)                                                       \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
    "+f"(d[30]), "+f"(d[31])

// d (+)= A.B^T, A (64 x 16) and B (64 x 16) both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_STR
        ", %32, %33, p, 1, 1, 0, 0;\n\t}"
        : ACC32_OPS(d)
        : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B, A (64 x 16) from registers, B (16 x 64) MN-major in shared
// memory (the transposed-B form)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_STR
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
        : ACC32_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
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

// ------------------------------------------------------------ table mode
// p / gw for 0 <= p < 2^24: the f32 quotient is off by at most one, which
// the remainder's sign fixes
__device__ __forceinline__ int div_gw(int p, int gw, float inv_gw) {
    const int r = __float2int_rz(__int2float_rn(p) * inv_gw);
    const int m = p - r * gw;
    return r + (m >= gw) - (m < 0);
}

// base() of query token t >= 1 (see the head of the file)
__device__ __forceinline__ int rel_base(int t, int gh, int gw,
                                        float inv_gw) {
    const int p = t - 1, r = div_gw(p, gw, inv_gw);
    return (r + gh - 1) * (2 * gw - 1) + (p - r * gw) + gw - 1;
}

// off() of key token t >= 1
__device__ __forceinline__ int rel_off(int t, int gw, float inv_gw) {
    const int p = t - 1;
    return p + div_gw(p, gw, inv_gw) * (gw - 1);
}

// A stage's bias slot in table mode: the cls entries (the 16-byte-aligned
// span of the head's row that holds num_rel .. num_rel + 2, loaded with
// each stage's first fill and kept), the kv tile's BK off() values (int32
// byte offsets, 4 off(), from the wrapper's per-grid table), then the
// tile's window of the row.
// The table is f32 in both bodies (bf16 values widen exactly), so a
// window entry is the f32 that enters the fmaf.
constexpr uint32_t REL_CLS = 0;
constexpr uint32_t REL_OFFS = 32;
constexpr uint32_t REL_WIN = REL_OFFS + 4 * BK;
constexpr int REL_E = 4;  // table entries per 16 bytes

// What table mode reads besides q, k, v: the (H, T) f32 table in rows of
// ld elements (a multiple of 4), the per-grid off() table, the grid.
struct RelArgs {
    const float* table;
    const int* offs;
    int T_len, ld, gh, gw;
};

// The window of the head's row that query rows [q0, q0 + rows) need
// against keys [k0, k0 + BK): base() and off() rise with the token, so
// every index but the cls ones lies in [base(qf) - off(kl), base(ql) -
// off(kf)] (first / last tokens of each range, past N clamped to N - 1,
// cls taking token 1's); widened to 16-byte bounds.  lo: its first entry;
// bytes: its size.
struct RelWindow {
    int lo;
    uint32_t bytes;
};

__device__ __forceinline__ RelWindow rel_window(int q0, int rows, int k0,
                                                int N, int gh, int gw) {
    constexpr int E = REL_E;
    const float inv_gw = 1.f / gw;
    const int lo = rel_base(max(q0, 1), gh, gw, inv_gw) -
                   rel_off(min(k0 + BK - 1, N - 1), gw, inv_gw);
    const int hi = rel_base(min(q0 + rows - 1, N - 1), gh, gw, inv_gw) -
                   rel_off(max(k0, 1), gw, inv_gw);
    const int lo_a = lo & ~(E - 1);
    return {lo_a, (uint32_t)(((hi + E) & ~(E - 1)) - lo_a) * 16 / E};
}

// cp.async.bulk global -> shared (16-byte aligned, a multiple of 16 bytes),
// counted on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
           "r"(bar)
        : "memory");
}

// The producer's part of a table-mode fill of the slot at `slot` for kv
// tile k0 of head h, whose window is w: the bytes it adds to the stage's
// transaction count, and its bulk copies, issued after the expect_tx.
// `cls`: the stage's first fill, which also copies the cls entries.  The
// window fits the slot: the launch refuses a grid whose bound
// (rel_window_fits) does not.
struct RelFill {
    const float* row;
    const int* offs;
    RelWindow w;
    int c0;
    uint32_t cls_bytes;

    __device__ __forceinline__ RelFill(const RelArgs& a, int h, int k0,
                                       RelWindow w_)
        : w(w_) {
        constexpr int E = REL_E;
        row = a.table + (size_t)h * a.ld;
        offs = a.offs + k0;
        const int num_rel = a.T_len - 3;
        c0 = num_rel & ~(E - 1);
        cls_bytes = (uint32_t)(((num_rel + 2 + E) & ~(E - 1)) - c0) * 16 / E;
    }
    __device__ __forceinline__ uint32_t bytes(bool cls) const {
        return 4 * BK + w.bytes + (cls ? cls_bytes : 0);
    }
    __device__ __forceinline__ void issue(uint32_t slot, uint32_t bar,
                                          bool cls) const {
        bulk_load(slot + REL_OFFS, offs, 4 * BK, bar);
        bulk_load(slot + REL_WIN, row + w.lo, w.bytes, bar);
        if (cls) bulk_load(slot + REL_CLS, row + c0, cls_bytes, bar);
    }
};

// What a consumer thread keeps of table mode: base() of its two query
// rows (past N: token N - 1's; cls: token 1's) and of the CTA's first
// query token (the window's query term), and whether its first row is
// the cls token.
struct RelRows {
    int base[2], first;
    bool cls_row;

    __device__ __forceinline__ RelRows(int q0, int row, int N, int gh,
                                       int gw) {
        const float inv_gw = 1.f / gw;
        base[0] = rel_base(max(min(row, N - 1), 1), gh, gw, inv_gw);
        base[1] = rel_base(min(row + 8, N - 1), gh, gw, inv_gw);
        first = rel_base(max(q0, 1), gh, gw, inv_gw);
        cls_row = row == 0;
    }
};

// The 32 bias values of a thread's scores on kv tile j, from the slot:
// b[4 jj + 2 hh + e] for the accumulator's score (row + 8 hh, k0 + 8 jj +
// cq + e).  A score's entry is window[(base - lo) - off]; only query tile
// 0 and kv tile 0 hold a cls row or column, so only they take the
// selects.
__device__ __forceinline__ void rel_fetch(float (&b)[32], const RelRows& rr,
                                          const uint8_t* slot, int cq,
                                          int T_len, bool cls_tile,
                                          bool cls_col) {
    const int* offs = reinterpret_cast<const int*>(slot + REL_OFFS);
    const int lo = (rr.first - (offs[BK - 1] >> 2)) & ~(REL_E - 1);
    // each row's entry at off() = 0, in bytes: a score's is 4 off() below
    const uint8_t* w[2] = {slot + REL_WIN + 4 * (rr.base[0] - lo),
                           slot + REL_WIN + 4 * (rr.base[1] - lo)};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
        const int2 o = *reinterpret_cast<const int2*>(offs + 8 * jj + cq);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            b[4 * jj + 2 * hh] =
                *reinterpret_cast<const float*>(w[hh] - o.x);
            b[4 * jj + 2 * hh + 1] =
                *reinterpret_cast<const float*>(w[hh] - o.y);
        }
    }
    if (cls_tile) {
        const int num_rel = T_len - 3;
        const float* cls = reinterpret_cast<const float*>(slot + REL_CLS) +
                           (num_rel & (REL_E - 1));
        if (rr.cls_row) {  // cls -> token
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) b[4 * jj] = b[4 * jj + 1] = cls[0];
        }
        if (cls_col) {     // token -> cls, cls -> cls
            b[0] = cls[rr.cls_row ? 2 : 1];
            b[2] = cls[1];
        }
    }
}

// REL: table mode (has_bias is then 0: no bias tile is loaded)
template <bool REL>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tb,
               __nv_bfloat16* __restrict__ out, int H, int N, int NK,
               int has_bias, int bias_batch, float scale,
               const RelArgs rel) {
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint8_t* gbase = smem_raw + (base - raw);
    const uint32_t bar_q = base + (REL ? OFF_BAR_REL : OFF_BAR);

    const int b = blockIdx.x, h = blockIdx.z;
    const int q0 = blockIdx.y * BQ;
    const int bh = b * H + h;
    const int bplane = (bias_batch == 1 ? 0 : b) * H + h;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int n_tiles = (NK + BK - 1) / BK;
    const uint32_t stage_bytes = (has_bias ? 3 : 2) * TILE_BYTES;

    auto issue = [&](int j, int s) {
        const uint32_t bar = bar_q + 8 * (1 + s);
        if (REL) {  // K, V, and the tile's window into the bias slot
            const RelFill f(rel, h, j * BK,
                            rel_window(q0, BQ, j * BK, N, rel.gh, rel.gw));
            mbar_expect_tx(bar, stage_bytes + f.bytes(j < STAGES));
            tma_load_3d(base + OFF_K + s * TILE_BYTES, &tk, bar, 0, j * BK,
                        bh);
            tma_load_3d(base + OFF_V + s * TILE_BYTES, &tv, bar, 0, j * BK,
                        bh);
            f.issue(base + OFF_B + s * REL_SLOT, bar, j < STAGES);
            return;
        }
        mbar_expect_tx(bar, stage_bytes);
        tma_load_3d(base + OFF_K + s * TILE_BYTES, &tk, bar, 0, j * BK, bh);
        tma_load_3d(base + OFF_V + s * TILE_BYTES, &tv, bar, 0, j * BK, bh);
        if (has_bias)
            tma_load_3d(base + OFF_B + s * TILE_BYTES, &tb, bar,
                        j * BK, q0, bplane);
    };

    if (tid == 0) {
        for (int i = 0; i < 1 + STAGES; ++i) mbar_init(bar_q + 8 * i, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(bar_q, TILE_BYTES);
        tma_load_3d(base, &tq, bar_q, 0, q0, bh);
        for (int s = 0; s < STAGES && s < n_tiles; ++s) issue(s, s);
    }

    // this thread's rows of the 64: r_lo and r_lo + 8; its
    // columns in each 8-column chunk: cq and cq + 1
    const int r_lo = warp * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const int swz = lane >> 2;  // (row & 7) for both rows
    // (a placeholder on a 1 x 1 grid in the other modes, never read)
    const RelRows rr = REL ? RelRows(q0, q0 + r_lo, N, rel.gh, rel.gw)
                           : RelRows(0, 0, 1, 1, 1);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    const uint64_t dq = sw128_desc(base);

    for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(bar_q + 8 * (1 + s), (j / STAGES) & 1);

        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        const uint64_t dk = sw128_desc(base + OFF_K + s * TILE_BYTES);
        // table mode: the tile's bias values from the slot; the loads
        // complete while the tensor cores compute S.  (Issued after S's
        // commit, ptxas spread them between its four wgmma, which then
        // started later: 0.5-2% slower.)
        float rb[32];
        if (REL)
            rel_fetch(rb, rr, gbase + OFF_B + s * REL_SLOT, cq, rel.T_len,
                      q0 == 0 || j == 0, j == 0 && cq == 0);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)  // 16 of D per step: +32 bytes
            wgmma_ss(sc, dq + 2 * ks, dk + 2 * ks, ks);
        wg_commit();
        wg_wait0();
        reg_fence(sc);

        // scores s.scale + bias
        const int k0 = j * BK;
        if (REL) {
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] = fmaf(sc[i], scale, rb[i]);
        } else if (has_bias) {
            const uint8_t* bt = gbase + OFF_B + s * TILE_BYTES;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int r = r_lo + 8 * hh;
                    const float2 bf = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(
                            bt + r * 128 + ((jj ^ swz) << 4) + 2 * cq));
                    float* x = sc + 4 * jj + 2 * hh;
                    x[0] = fmaf(x[0], scale, bf.x);
                    x[1] = fmaf(x[1], scale, bf.y);
                }
        } else {
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] *= scale;
        }
        if (k0 + BK > NK) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (k0 + 8 * jj + cq + e >= NK) {
                        sc[4 * jj + e] = -INFINITY;
                        sc[4 * jj + 2 + e] = -INFINITY;
                    }
        }

        // online softmax in log2 space: exp(x - m) = ex2(x.log2e - m.log2e),
        // one FMA before each ex2.  alpha comes from the difference of the
        // maxima, exactly 1 while the max holds (the reference's
        // exp2(m_prev - m_next)); ex2(m.log2e + nml) is not (nml is
        // -m.log2e rounded), and would rescale the earlier tiles' weights
        // by ~1e-6 once a tile.
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            float mx = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
                mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * hh],
                                     sc[4 * jj + 2 * hh + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[hh], mx);
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float nml = -LOG2E * m_use;
            alpha[hh] = ex2((m[hh] - m_use) * LOG2E);
            m[hh] = m_new;
            float sum = 0.f;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float* x = sc + 4 * jj + 2 * hh + e;
                    *x = ex2(fmaf(*x, LOG2E, nml));
                    sum += *x;
                }
            l[hh] = l[hh] * alpha[hh] + sum;  // this lane's part of the row
        }

        // P as the A fragment of m64n64k16, one per 16 keys
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i],
                                      sc[8 * kk + 2 * i + 1]);

        // P.V of this tile into a fresh accumulator, then O = O.alpha +
        // tile, rounded to nearest: the tensor cores' sums round toward
        // zero, so one accumulator over every tile would pile that bias up
        // (a signed mean error of 1.9e-5 against f64 at 10,765 keys)
        float pv[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) pv[i] = 0.f;
        const uint64_t dv = sw128_desc(base + OFF_V + s * TILE_BYTES);
        reg_fence(pv);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16 keys per step: +2048 bytes
            wgmma_rs(pv, pa[kk], dv + 128 * kk, kk);
        wg_commit();
        wg_wait0();
        reg_fence(pv);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int i = 4 * jj + 2 * hh + e;
                    o[i] = fmaf(o[i], alpha[hh], pv[i]);
                }

        __syncthreads();  // every thread is done with stage s
        if (tid == 0 && j + STAGES < n_tiles) issue(j + STAGES, s);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + r_lo + 8 * hh;
        if (row >= N) continue;
        const float inv = l[hh] == 0.f ? 0.f : 1.f / l[hh];
        __nv_bfloat16* op = out + ((size_t)bh * N + row) * D + cq;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<__nv_bfloat162*>(op + 8 * jj) =
                __floats2bfloat162_rn(o[4 * jj + 2 * hh] * inv,
                                      o[4 * jj + 2 * hh + 1] * inv);
    }
}

// ---------------------------------------------------------------- f32 body
// Split-TF32 products on wgmma.  x = hi + lo with hi = rna_tf32(x) and
// lo = rna_tf32(x - hi); a.b ~ hi.hi + hi.lo + lo.hi (lo.lo, ~2^-22 |a.b|,
// dropped), three m64n64k8 tf32 passes into one f32 accumulator.
constexpr int F_WG = 2;                     // warpgroups, 64 query rows each
constexpr int F_BQ = 64 * F_WG;             // query rows per CTA
constexpr int F_THREADS = 128 * F_WG;
constexpr int F_STAGES = 2;
constexpr int SPLIT_THREADS = 256;
constexpr uint32_t F_BOX = 64 * 128;        // 64 rows of 32 f32, swizzled
constexpr uint32_t F_TILE = 2 * F_BOX;      // 64 x 64 f32: two boxes
constexpr uint32_t F_BIAS_BOX = F_BQ * 128; // F_BQ rows of 32 f32
// a stage: K hi | K lo | V^T hi | V^T lo | bias (two column boxes); the
// stages, then an mbarrier and a count of the warps done with it per
// stage, from a 1024-byte aligned base
constexpr uint32_t F_OFF_KH = 0;
constexpr uint32_t F_OFF_KL = F_TILE;
constexpr uint32_t F_OFF_VH = 2 * F_TILE;
constexpr uint32_t F_OFF_VL = 3 * F_TILE;
constexpr uint32_t F_OFF_B = 4 * F_TILE;
constexpr uint32_t F_STAGE = 4 * F_TILE + 2 * F_BIAS_BOX;
constexpr uint32_t F_OFF_BAR = F_STAGES * F_STAGE;
constexpr size_t kF32SmemBytes = 1024 + F_OFF_BAR + 16 * F_STAGES;

// x rounded to TF32 (round to nearest, ties away), as f32 bits with the
// low 13 bits clear
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t y;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
    return y & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

// d (+)= A.B, A (64 x 8) from registers, B (8 x 64) K-major in shared
// memory (tf32 takes no transposed operand)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ACC32_STR
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n\t}"
        : ACC32_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}

// The descriptor of k-step ks (8 columns) of a 64 x 64 f32 tile held as
// two 128-byte-swizzled boxes of 32 columns: +32 bytes a step in a box.
__device__ __forceinline__ uint64_t f32_desc(uint32_t tile, int ks) {
    return sw128_desc(tile + (ks >> 2) * F_BOX) + 2 * (ks & 3);
}

// The split operands of the f32 body, per call: kh | kl as (2 BH, NKP, 64)
// and vth | vtl as (2 BH, 64, NKP), keys padded with zeros to NKP (a
// multiple of 64).  V^T is K-major for P.V; its keys are permuted within
// each group of 8 (position t <- key 2t, t + 4 <- key 2t + 1, t < 4), so
// that the A fragment of P (columns t and t + 4 of each group of 8) is the
// S accumulator's own pair of columns (2t, 2t + 1): P never leaves the
// registers.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kv_f32(const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ ws, int NK, int NKP) {
    __shared__ float vs[BK][D + 1];
    const int bh = blockIdx.x, k0 = blockIdx.y * BK;
    const size_t plane = (size_t)gridDim.x * NKP * D;
    const float* kp = k + (size_t)bh * NK * D;
    const float* vp = v + (size_t)bh * NK * D;
    float* kh = ws + (size_t)bh * NKP * D;
    float* vth = ws + 2 * plane + (size_t)bh * D * NKP;
    // K by 4 columns a thread, all loads in flight at once (a short call's
    // pre-pass is a few dependent rounds of memory latency)
#pragma unroll
    for (int i = 0; i < BK * D / 4 / SPLIT_THREADS; ++i) {
        const int e = threadIdx.x + i * SPLIT_THREADS;
        const int r = e / (D / 4), c = 4 * (e % (D / 4));
        const int key = k0 + r;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (key < NK) {
            kx = *reinterpret_cast<const float4*>(kp + (size_t)key * D + c);
            vx = *reinterpret_cast<const float4*>(vp + (size_t)key * D + c);
        }
        uint32_t hi[4], lo[4];
        split_tf32(kx.x, hi[0], lo[0]);
        split_tf32(kx.y, hi[1], lo[1]);
        split_tf32(kx.z, hi[2], lo[2]);
        split_tf32(kx.w, hi[3], lo[3]);
        *reinterpret_cast<uint4*>(kh + (size_t)key * D + c) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(kh + plane + (size_t)key * D + c) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
        vs[r][c] = vx.x;
        vs[r][c + 1] = vx.y;
        vs[r][c + 2] = vx.z;
        vs[r][c + 3] = vx.w;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BK * D / SPLIT_THREADS; ++i) {
        const int e = threadIdx.x + i * SPLIT_THREADS;
        const int d = e / BK, p = e % BK;
        const int t = p & 7;
        const int key = (p & ~7) + (t < 4 ? 2 * t : 2 * t - 7);
        uint32_t hi, lo;
        split_tf32(vs[key][d], hi, lo);
        vth[(size_t)d * NKP + k0 + p] = __uint_as_float(hi);
        vth[plane + (size_t)d * NKP + k0 + p] = __uint_as_float(lo);
    }
}

// One CTA: F_WG warpgroups of 64 query rows each, sharing a ring of K /
// V / bias stages loaded by TMA (bar[s] counts the bytes).  The last warp
// done with a stage refills it, so no warpgroup waits for another to
// start its next tile.  Q's rows are split once into A fragments in
// registers.
// REL: table mode (has_bias is then 0: no bias box is loaded)
template <bool REL>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_fwd_f32(const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tb,
              const float* __restrict__ q, float* __restrict__ out, int H,
              int N, int NK, int has_bias, int bias_batch, float scale,
              const RelArgs rel) {
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* gbase = smem_raw + (base - raw);
    const uint32_t bar0 = base + F_OFF_BAR;
    int* done = reinterpret_cast<int*>(gbase + F_OFF_BAR + 8 * F_STAGES);

    const int b = blockIdx.y, h = blockIdx.z;
    const int q0 = blockIdx.x * F_BQ;
    const int bh = b * H + h;
    const int n_bh = gridDim.y * H;  // the lo planes follow the hi ones
    const int bplane = (bias_batch == 1 ? 0 : b) * H + h;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int n_tiles = (NK + BK - 1) / BK;
    const uint32_t stage_bytes =
        4 * F_TILE + (has_bias ? 2 * F_BIAS_BOX : 0);

    // table mode: the window of the tile this warp would refill next,
    // worked out by its lane 0 while the tensor cores compute a tile's S
    RelWindow next = {0, 0};
    auto issue = [&](int j, int s) {
        const uint32_t bar = bar0 + 8 * s;
        const uint32_t st = base + s * F_STAGE;
        if (REL) {  // K, V, and the tile's window into the bias slot
            const RelFill f(rel, h, j * BK,
                            j < F_STAGES ? rel_window(q0, F_BQ, j * BK, N,
                                                      rel.gh, rel.gw)
                                         : next);
            mbar_expect_tx(bar, stage_bytes + f.bytes(j < F_STAGES));
            for (int x = 0; x < 2; ++x) {
                tma_load_3d(st + F_OFF_KH + x * F_BOX, &tk, bar, 32 * x,
                            j * BK, bh);
                tma_load_3d(st + F_OFF_KL + x * F_BOX, &tk, bar, 32 * x,
                            j * BK, n_bh + bh);
                tma_load_3d(st + F_OFF_VH + x * F_BOX, &tv, bar,
                            j * BK + 32 * x, 0, bh);
                tma_load_3d(st + F_OFF_VL + x * F_BOX, &tv, bar,
                            j * BK + 32 * x, 0, n_bh + bh);
            }
            f.issue(st + F_OFF_B, bar, j < F_STAGES);
            return;
        }
        mbar_expect_tx(bar, stage_bytes);
        for (int x = 0; x < 2; ++x) {  // the two 32-column boxes
            tma_load_3d(st + F_OFF_KH + x * F_BOX, &tk, bar, 32 * x, j * BK,
                        bh);
            tma_load_3d(st + F_OFF_KL + x * F_BOX, &tk, bar, 32 * x, j * BK,
                        n_bh + bh);
            tma_load_3d(st + F_OFF_VH + x * F_BOX, &tv, bar, j * BK + 32 * x,
                        0, bh);
            tma_load_3d(st + F_OFF_VL + x * F_BOX, &tv, bar, j * BK + 32 * x,
                        0, n_bh + bh);
            if (has_bias)
                tma_load_3d(st + F_OFF_B + x * F_BIAS_BOX, &tb, bar,
                            j * BK + 32 * x, q0, bplane);
        }
    };

    if (tid == 0) {
        for (int s = 0; s < F_STAGES; ++s) {
            mbar_init(bar0 + 8 * s, 1);
            done[s] = 0;
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int s = 0; s < F_STAGES && s < n_tiles; ++s) issue(s, s);
    }
    __syncthreads();

    const int wg = warp >> 2;
    // this thread's rows of the warpgroup's 64: r_lo and r_lo + 8; its
    // columns in each 8-column chunk of S and O: cq and cq + 1
    const int r_lo = (warp & 3) * 16 + (lane >> 2);
    const int t = lane & 3;
    const int cq = 2 * t;
    const int row0 = q0 + wg * 64 + r_lo;
    // (a placeholder on a 1 x 1 grid in the other modes, never read)
    const RelRows rr = REL ? RelRows(q0, row0, N, rel.gh, rel.gw)
                           : RelRows(0, 0, 1, 1, 1);

    // Q as split A fragments of m64n64k8: a0 (r_lo, t), a1 (r_lo + 8, t),
    // a2 (r_lo, t + 4), a3 (r_lo + 8, t + 4) of each 8 columns
    uint32_t qh[8][4], ql[8][4];
    const float* qp = q + (size_t)bh * N * D;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = row0 + 8 * (i & 1);
            const int c = 8 * ks + t + 4 * (i >> 1);
            split_tf32(r < N ? qp[(size_t)r * D + c] : 0.f, qh[ks][i],
                       ql[ks][i]);
        }

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int j = 0; j < n_tiles; ++j) {
        const int s = j % F_STAGES;
        const uint32_t st = base + s * F_STAGE;
        mbar_wait(bar0 + 8 * s, (j / F_STAGES) & 1);

        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        // the small terms of every k-step first, then the large ones: the
        // tensor cores' f32 sums round toward zero, each step at the
        // accumulator's magnitude, so the 16 small steps err at 2^-11 of
        // the 8 large ones
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
            wgmma_tf32(sc, ql[ks], f32_desc(st + F_OFF_KH, ks), ks);
            wgmma_tf32(sc, qh[ks], f32_desc(st + F_OFF_KL, ks), 1);
        }
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
            wgmma_tf32(sc, qh[ks], f32_desc(st + F_OFF_KH, ks), 1);
        wg_commit();
        // table mode: the tile's bias values from the slot while the
        // tensor cores compute S
        float rb[32];
        if (REL) {
            rel_fetch(rb, rr, gbase + s * F_STAGE + F_OFF_B, cq, rel.T_len,
                      q0 == 0 || j == 0, j == 0 && cq == 0);
            if (lane == 0 && j + F_STAGES < n_tiles)
                next = rel_window(q0, F_BQ, (j + F_STAGES) * BK, N, rel.gh,
                                  rel.gw);
        }
        wg_wait0();
        reg_fence(sc);

        // scores s.scale + bias
        const int k0 = j * BK;
        if (REL) {
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] = fmaf(sc[i], scale, rb[i]);
        } else if (has_bias) {
            const uint8_t* bt = gbase + s * F_STAGE + F_OFF_B;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int r = wg * 64 + r_lo + 8 * hh;  // r & 7 = lane >> 2
                    const int c = (8 * jj + cq) & 31;
                    const float2 bf = *reinterpret_cast<const float2*>(
                        bt + (jj >> 2) * F_BIAS_BOX + r * 128 +
                        (((c >> 2) ^ (r & 7)) << 4) + 4 * (c & 3));
                    float* x = sc + 4 * jj + 2 * hh;
                    x[0] = fmaf(x[0], scale, bf.x);
                    x[1] = fmaf(x[1], scale, bf.y);
                }
        } else {
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] *= scale;
        }
        if (k0 + BK > NK) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (k0 + 8 * jj + cq + e >= NK) {
                        sc[4 * jj + e] = -INFINITY;
                        sc[4 * jj + 2 + e] = -INFINITY;
                    }
        }

        // online softmax in log2 space, as in the bf16 body, but for
        // alpha: from the difference of the maxima, exactly 1 while the
        // max holds.  ex2(m.log2e + nml) is not (nml is -m.log2e rounded),
        // and would scale the earlier tiles' weights by the same factor
        // once a tile: a drift of 1e-6 a tile, 2e-5 in the output at
        // 6912 keys.
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            float mx = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
                mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * hh],
                                     sc[4 * jj + 2 * hh + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[hh], mx);
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float nml = -LOG2E * m_use;
            alpha[hh] = ex2((m[hh] - m_use) * LOG2E);
            m[hh] = m_new;
            float sum = 0.f;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float* x = sc + 4 * jj + 2 * hh + e;
                    *x = ex2(fmaf(*x, LOG2E, nml));
                    sum += *x;
                }
            l[hh] = l[hh] * alpha[hh] + sum;  // this lane's part of the row
        }

        // P as split A fragments, one per 8 keys in V^T's permuted order:
        // a0 (r_lo, key 2t), a1 (r_lo + 8, 2t), a2 (r_lo, 2t + 1),
        // a3 (r_lo + 8, 2t + 1): the accumulator's 4 kk, 4 kk + 2,
        // 4 kk + 1, 4 kk + 3
        uint32_t ph[8][4], pl[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                split_tf32(sc[4 * kk + ((i & 1) << 1) + (i >> 1)],
                           ph[kk][i], pl[kk][i]);

        // P.V of this tile into a fresh accumulator, small terms first as
        // for S: rounding toward zero is a bias that one running sum over
        // every tile would pile up (an error growing with Nk: 4e-5 at 6912
        // keys); O = O.alpha + tile then rounds to nearest
        float ot[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) ot[i] = 0.f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            wgmma_tf32(ot, pl[kk], f32_desc(st + F_OFF_VH, kk), kk);
            wgmma_tf32(ot, ph[kk], f32_desc(st + F_OFF_VL, kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
            wgmma_tf32(ot, ph[kk], f32_desc(st + F_OFF_VH, kk), 1);
        wg_commit();
        wg_wait0();
        reg_fence(ot);

        // stage s is consumed by this warp; the CTA's last warp to get
        // here refills it
        __syncwarp();
        if (lane == 0) {
            __threadfence_block();
            if (atomicAdd(done + s, 1) == F_THREADS / 32 - 1) {
                __threadfence_block();
                done[s] = 0;
                if (j + F_STAGES < n_tiles) issue(j + F_STAGES, s);
            }
        }

#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int i = 4 * jj + 2 * hh + e;
                    o[i] = fmaf(o[i], alpha[hh], ot[i]);
                }
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (row >= N) continue;
        const float inv = l[hh] == 0.f ? 0.f : 1.f / l[hh];
        float* op = out + ((size_t)bh * N + row) * D + cq;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<float2*>(op + 8 * jj) =
                make_float2(o[4 * jj + 2 * hh] * inv,
                            o[4 * jj + 2 * hh + 1] * inv);
    }
}

// ------------------------------------------------------------ host side
// error codes besides cudaError_t values
constexpr int ERR_NO_ENCODE = -1;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;      // a tensor map was refused

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime, so the library
// needs no -lcuda.
EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn) return fn;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
    return fn;
}

// A tensor seen as (cols, rows, planes), read in box_cols x box_rows x 1
// boxes of 128-byte rows in the 128-byte swizzle; out-of-range elements of
// a box read as 0.  Strides in elements.
bool swizzled_map(EncodeTiledFn encode, CUtensorMap* map,
                  CUtensorMapDataType type, uint32_t item, const void* ptr,
                  uint64_t cols, uint64_t rows, uint64_t planes,
                  uint64_t row_stride, uint64_t plane_stride,
                  uint32_t box_rows) {
    const cuuint64_t dims[3] = {cols, rows, planes};
    const cuuint64_t strides[2] = {row_stride * item, plane_stride * item};
    const cuuint32_t box[3] = {128 / item, box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                  elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool bf16_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
              uint64_t cols, uint64_t rows, uint64_t planes,
              uint64_t row_stride, uint64_t plane_stride,
              uint32_t box_rows) {
    return swizzled_map(encode, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        ptr, cols, rows, planes, row_stride, plane_stride,
                        box_rows);
}

bool f32_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
             uint64_t cols, uint64_t rows, uint64_t planes,
             uint64_t row_stride, uint64_t plane_stride, uint32_t box_rows) {
    return swizzled_map(encode, map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr,
                        cols, rows, planes, row_stride, plane_stride,
                        box_rows);
}

// The relative-position table of table mode: (H, T) f32 in rows of ld
// elements, null in the other modes; offs the per-grid off() table.
struct RelTable {
    const void* ptr;
    const int* offs;
    int T, ld, gh, gw;
};

int launch_bf16(const void* q, const void* k, const void* v,
                const void* bias, const RelTable& rel, void* out, int B,
                int H, int N, int NK, int bias_batch, int ldb, float scale,
                cudaStream_t stream) {
    EncodeTiledFn encode = encode_tiled();
    if (!encode) return ERR_NO_ENCODE;
    CUtensorMap tq, tk, tv, tb = {};
    const uint64_t bh = (uint64_t)B * H;
    bool ok = bf16_map(encode, &tq, q, D, N, bh, D, (uint64_t)N * D, BQ) &&
              bf16_map(encode, &tk, k, D, NK, bh, D, (uint64_t)NK * D, BK) &&
              bf16_map(encode, &tv, v, D, NK, bh, D, (uint64_t)NK * D, BK);
    if (ok && bias)
        ok = bf16_map(encode, &tb, bias, NK, N, (uint64_t)bias_batch * H, ldb,
                      (uint64_t)N * ldb, BQ);
    if (!ok) return ERR_ENCODE;
    auto kernel = rel.ptr ? flash_fwd_bf16<true> : flash_fwd_bf16<false>;
    const size_t smem = rel.ptr ? kTcRelSmemBytes : kTcSmemBytes;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B, (N + BQ - 1) / BQ, H);  // batch fastest
    kernel<<<grid, TC_THREADS, smem, stream>>>(
        tq, tk, tv, tb, (__nv_bfloat16*)out, H, N, NK, bias != nullptr,
        bias_batch, scale,
        RelArgs{(const float*)rel.ptr, rel.offs, rel.T, rel.ld, rel.gh,
                rel.gw});
    return (int)cudaGetLastError();
}

int padded_keys(int NK) { return (NK + BK - 1) / BK * BK; }

// The largest base() (or off()) spread over `rows` consecutive tokens of a
// grid gw wide: rows - 1 steps, and at most (gw + rows - 2) / gw row
// changes of gw - 1 more each.
long long rel_tile_span(int rows, int gw) {
    return rows - 1 + (long long)((gw + rows - 2) / gw) * (gw - 1);
}

// Whether every table-mode window of a grid gw wide (any gh) fits the
// body's bias slot: the query tile's spread, the kv tile's, one, and the
// widening to 16-byte bounds at both ends (ops/flash_attention.py
// rel_window_bound restates it).
bool rel_window_fits(int gw, int dtype) {
    const int rows = dtype == 0 ? F_BQ : BQ;
    const long long entries = rel_tile_span(rows, gw) +
                              rel_tile_span(BK, gw) + 1 + 2 * (REL_E - 1);
    const uint32_t slot = dtype == 0 ? 2 * F_BIAS_BOX : REL_SLOT;
    return entries * (16 / REL_E) <= (long long)(slot - REL_WIN);
}

// ws: flash_attention_workspace_bytes(B, H, NK, 0) bytes, 16-byte aligned
int launch_f32(const void* q, const void* k, const void* v, const void* bias,
               const RelTable& rel, void* out, void* ws, int B, int H, int N,
               int NK, int bias_batch, int ldb, float scale,
               cudaStream_t stream) {
    EncodeTiledFn encode = encode_tiled();
    if (!encode) return ERR_NO_ENCODE;
    const int NKP = padded_keys(NK);
    const uint64_t bh = (uint64_t)B * H;
    const uint64_t plane = bh * NKP * D;
    CUtensorMap tk, tv, tb = {};
    bool ok = f32_map(encode, &tk, ws, D, NKP, 2 * bh, D, (uint64_t)NKP * D,
                      BK) &&
              f32_map(encode, &tv, (const float*)ws + 2 * plane, NKP, D,
                      2 * bh, NKP, (uint64_t)D * NKP, D);
    if (ok && bias)
        ok = f32_map(encode, &tb, bias, NK, N, (uint64_t)bias_batch * H, ldb,
                     (uint64_t)N * ldb, F_BQ);
    if (!ok) return ERR_ENCODE;
    split_kv_f32<<<dim3((unsigned)bh, NKP / BK), SPLIT_THREADS, 0, stream>>>(
        (const float*)k, (const float*)v, (float*)ws, NK, NKP);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    auto kernel = rel.ptr ? flash_fwd_f32<true> : flash_fwd_f32<false>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kF32SmemBytes);
    if (err != cudaSuccess) return (int)err;
    // query tiles fastest: the CTAs that read one head's K and V run
    // together and find them in L2
    dim3 grid((N + F_BQ - 1) / F_BQ, B, H);
    kernel<<<grid, F_THREADS, kF32SmemBytes, stream>>>(
        tk, tv, tb, (const float*)q, (float*)out, H, N, NK, bias != nullptr,
        bias_batch, scale,
        RelArgs{(const float*)rel.ptr, rel.offs, rel.T, rel.ld, rel.gh,
                rel.gw});
    return (int)cudaGetLastError();
}

template <typename Kernel>
int ctas_per_sm(Kernel kernel, int threads, size_t smem) {
    int n = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                            threads, smem);
    return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" {

// The scratch the f32 body needs (its split K and V^T), in bytes; 0 for
// bf16.
size_t flash_attention_workspace_bytes(int B, int H, int NK, int dtype) {
    return dtype == 0 ? 4 * sizeof(float) * (size_t)B * H * padded_keys(NK) * D
                      : 0;
}

// The dynamic shared memory of the body for dtype (table_mode: its REL
// instance), in bytes.
size_t flash_attention_smem_bytes(int dtype, int table_mode) {
    return dtype == 0 ? kF32SmemBytes
                      : table_mode ? kTcRelSmemBytes : kTcSmemBytes;
}

// How many CTAs of the body for dtype (table_mode: its REL instance) an
// SM holds at once, or a negative cudaError_t.
int flash_attention_ctas_per_sm(int dtype, int table_mode) {
    const size_t smem = flash_attention_smem_bytes(dtype, table_mode);
    if (dtype == 0)
        return ctas_per_sm(
            table_mode ? flash_fwd_f32<true> : flash_fwd_f32<false>,
            F_THREADS, smem);
    return ctas_per_sm(
        table_mode ? flash_fwd_bf16<true> : flash_fwd_bf16<false>,
        TC_THREADS, smem);
}

// dtype: 0 = float32, 1 = bfloat16.  bias may be null; bias_batch is its
// leading dim (1 = shared across the batch, B = per batch element) and
// bias_ld its row stride in elements (a multiple of 16, >= NK).  table
// (table mode; null otherwise, and then bias must be null): the (H,
// table_len) relative-position table, f32 (in bf16 the bf16 values
// widened), shared across the batch, of a gh x gw grid (table_len =
// (2gh-1)(2gw-1)+3 and N = NK = gh.gw + 1), in 16-byte-aligned rows of
// table_ld elements (a multiple of 4, >= table_len); rel_offs: off() of every key token, padded to
// a multiple of 64 entries (int32; cls and tokens past N as the wrapper
// builds it).  workspace: flash_attention_workspace_bytes(B, H, NK, dtype)
// bytes (null for bf16).  Returns 0 on success, a cudaError_t, or a
// negative code of this file.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            const void* bias, const void* table,
                            const void* rel_offs, void* out,
                            void* workspace, int B, int H, int N, int NK,
                            int head_dim, int bias_batch, int bias_ld,
                            int table_len, int table_ld, int gh, int gw,
                            float scale, int dtype, void* stream) {
    if (head_dim != D || N < 1 || NK < 1 || B < 1 || H < 1 || B > 65535 ||
        H > 65535 || (bias && (bias_ld < NK || bias_ld % 16 != 0)) ||
        (dtype == 0 && !workspace))
        return (int)cudaErrorInvalidValue;
    if (table && (bias || !rel_offs || gh < 1 || gw < 1 || N != NK ||
                  (long long)gh * gw + 1 != N ||
                  table_len != (2 * gh - 1) * (2 * gw - 1) + 3 ||
                  table_ld < table_len || table_ld % REL_E != 0 ||
                  !rel_window_fits(gw, dtype)))
        return (int)cudaErrorInvalidValue;
    const RelTable rel = {table, (const int*)rel_offs, table_len, table_ld,
                          gh, gw};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_f32(q, k, v, bias, rel, out, workspace, B, H, N, NK,
                          bias_batch, bias_ld, scale, s);
    if (dtype == 1)
        return launch_bf16(q, k, v, bias, rel, out, B, H, N, NK, bias_batch,
                           bias_ld, scale, s);
    return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
    if (err == ERR_NO_ENCODE)
        return "cuTensorMapEncodeTiled not found through the CUDA runtime";
    if (err == ERR_ENCODE)
        return "cuTensorMapEncodeTiled refused a tensor map";
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
