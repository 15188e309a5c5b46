// Flash attention forward with an additive bias, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel depthmap_tpu/ops/flash_attention.py
// (flash_attention, bodies _kernel_single and _kernel): out =
// softmax(q.k^T * scale + bias) . v with an exact online softmax.
//
// Semantics kept from the TPU kernel, in both bodies:
//  * q.k^T is taken on input-dtype values with f32 accumulation;
//  * the running max m, running sum l and the output accumulator are f32;
//  * p is rounded to the input dtype before p.v, l sums the unrounded p;
//  * a row whose sum is 0 yields 0;
//  * keys at or beyond kv_len are masked to -inf by a select, and a ragged
//    edge tile never reads out of bounds (out-of-range rows load as 0);
//  * the bias is (1, H, N, Nk), shared across the batch, or (B, H, N, Nk),
//    with rows of `ldb` elements (a multiple of 16; the columns past Nk
//    are never read), heads and batch packed behind the rows.
//
// Two bodies, chosen by dtype; neither falls back to the other.
//
// bf16 (the main path): tensor cores.  At the BEiT-L shapes (D = 64,
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
//  * O += P.V is four wgmma with P from registers (the S accumulator is the
//    A-fragment layout once rounded to bf16) and V from shared memory as
//    stored (MN-major, the transposed-B form).
//  * The grid runs batch fastest, so the CTAs of one (head, query tile)
//    read a shared bias tile close together in time and find it in L2.
//  * q, k, v are described to TMA as (64, N, B.H): a head's ragged last
//    tile reads zeros, never the next head's rows.
//
// f32: CUDA cores.  Tensor cores take f32 only as TF32, which would break
// the f32 bound; this body runs both products as f32 FMAs (a 4x8 register
// micro-tile per thread over 64x64 tiles staged in shared memory).
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

// ---------------------------------------------------------------- f32 body
constexpr int THREADS = 128; // 16 row groups x 8 column groups
constexpr int LD = D + 1;    // padded smem row stride (no bank conflicts)
constexpr int LS = BK + 1;

constexpr size_t kSmemBytes =
    sizeof(float) * (BQ * LD + BK * LD + BK * D + BQ * LS);

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ out, int H, int N, int NK, int bias_batch,
              int ldb, float scale) {
    extern __shared__ float smem[];
    float* Qs = smem;               // BQ x LD
    float* Ks = Qs + BQ * LD;       // BK x LD
    float* Vs = Ks + BK * LD;       // BK x D
    float* Ss = Vs + BK * D;        // BQ x LS: bias tile, then p

    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x;
    const int ty = tid >> 3;        // rows ty + 16 i
    const int tx = tid & 7;         // cols tx + 8 j
    const size_t bh = (size_t)b * H + h;
    const float* qp = q + bh * N * D;
    const float* kp = k + bh * NK * D;
    const float* vp = v + bh * NK * D;
    const float* bp = bias ? bias + ((size_t)(bias_batch == 1 ? 0 : b) * H + h)
                                        * N * ldb
                           : nullptr;

    for (int e = tid; e < BQ * D; e += THREADS) {
        const int r = e / D, c = e % D;
        const int qr = q0 + r;
        Qs[r * LD + c] = qr < N ? qp[(size_t)qr * D + c] : 0.f;
    }

    float m[4], l[4], acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < NK; k0 += BK) {
        __syncthreads();  // the previous tile's Ks/Vs/Ss are consumed
        for (int e = tid; e < BK * D; e += THREADS) {
            const int r = e / D, c = e % D;
            const int kr = k0 + r;
            const bool ok = kr < NK;
            Ks[r * LD + c] = ok ? kp[(size_t)kr * D + c] : 0.f;
            Vs[r * D + c] = ok ? vp[(size_t)kr * D + c] : 0.f;
        }
        if (bp) {
            for (int e = tid; e < BQ * BK; e += THREADS) {
                const int r = e / BK, c = e % BK;
                const int qr = q0 + r, kc = k0 + c;
                Ss[r * LS + c] = (qr < N && kc < NK)
                    ? bp[(size_t)qr * ldb + kc] : 0.f;
            }
        }
        __syncthreads();

        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            float a[4], bk[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
            for (int j = 0; j < 8; ++j) bk[j] = Ks[(tx + 8 * j) * LD + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int c = tx + 8 * j;
                float val = s[i][j] * scale;
                if (bp) val += Ss[r * LS + c];
                s[i][j] = (k0 + c < NK) ? val : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            // the 8 threads of a row are 8 consecutive lanes
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            const float m_new = fmaxf(m[i], mx);
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float alpha = expf(m[i] - m_use);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float p = expf(s[i][j] - m_use);
                sum += p;
                s[i][j] = p;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            sum += __shfl_xor_sync(0xffffffffu, sum, 4);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();  // every thread has read its bias entries
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                Ss[(ty + 16 * i) * LS + tx + 8 * j] = s[i][j];
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Ss[(ty + 16 * i) * LS + kk];
#pragma unroll
            for (int j = 0; j < 8; ++j) bv[j] = Vs[kk * D + tx + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qr = q0 + ty + 16 * i;
        if (qr >= N) continue;
        const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            out[(bh * N + qr) * D + tx + 8 * j] = acc[i][j] * inv;
    }
}

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
                                         uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_STR
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
        : ACC32_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tb,
               __nv_bfloat16* __restrict__ out, int H, int N, int NK,
               int has_bias, int bias_batch, float scale) {
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint8_t* gbase = smem_raw + (base - raw);
    const uint32_t bar_q = base + OFF_BAR;

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
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)  // 16 of D per step: +32 bytes
            wgmma_ss(sc, dq + 2 * ks, dk + 2 * ks, ks);
        wg_commit();
        wg_wait0();
        reg_fence(sc);

        // scores s.scale + bias
        if (has_bias) {
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
        const int k0 = j * BK;
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
        // one FMA before each ex2
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
            const float nml = -LOG2E * (m_new == -INFINITY ? 0.f : m_new);
            alpha[hh] = ex2(fmaf(m[hh], LOG2E, nml));
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
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                o[4 * jj + 2 * hh] *= alpha[hh];
                o[4 * jj + 2 * hh + 1] *= alpha[hh];
            }

        const uint64_t dv = sw128_desc(base + OFF_V + s * TILE_BYTES);
        reg_fence(o);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16 keys per step: +2048 bytes
            wgmma_rs(o, pa[kk], dv + 128 * kk);
        wg_commit();
        wg_wait0();
        reg_fence(o);

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

// A bf16 tensor seen as (cols, rows, planes), read in 64 x box_rows x 1
// boxes in the 128-byte swizzle; out-of-range elements of a box read as 0.
bool bf16_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
              uint64_t cols, uint64_t rows, uint64_t planes,
              uint64_t row_stride, uint64_t plane_stride,
              uint32_t box_rows) {
    const cuuint64_t dims[3] = {cols, rows, planes};
    const cuuint64_t strides[2] = {row_stride * 2, plane_stride * 2};
    const cuuint32_t box[3] = {64, box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* q, const void* k, const void* v,
                const void* bias, void* out, int B, int H, int N, int NK,
                int bias_batch, int ldb, float scale, cudaStream_t stream) {
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
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kTcSmemBytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B, (N + BQ - 1) / BQ, H);  // batch fastest
    flash_fwd_bf16<<<grid, TC_THREADS, kTcSmemBytes, stream>>>(
        tq, tk, tv, tb, (__nv_bfloat16*)out, H, N, NK, bias != nullptr,
        bias_batch, scale);
    return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const void* bias,
               void* out, int B, int H, int N, int NK, int bias_batch,
               int ldb, float scale, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + BQ - 1) / BQ, H, B);
    flash_fwd_f32<<<grid, THREADS, kSmemBytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)bias, (float*)out, H, N, NK, bias_batch, ldb, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bias may be null; bias_batch is its
// leading dim (1 = shared across the batch, B = per batch element) and
// bias_ld its row stride in elements (a multiple of 16, >= NK).
// Returns 0 on success, a cudaError_t, or a negative code of this file.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            const void* bias, void* out, int B, int H, int N,
                            int NK, int head_dim, int bias_batch, int bias_ld,
                            float scale, int dtype, void* stream) {
    if (head_dim != D || N < 1 || NK < 1 || B < 1 || H < 1 || B > 65535 ||
        H > 65535 || (bias && (bias_ld < NK || bias_ld % 16 != 0)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_f32(q, k, v, bias, out, B, H, N, NK, bias_batch,
                          bias_ld, scale, s);
    if (dtype == 1)
        return launch_bf16(q, k, v, bias, out, B, H, N, NK, bias_batch,
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
