// Flash attention forward with an additive bias, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel depthmap_tpu/ops/flash_attention.py
// (flash_attention, bodies _kernel_single and _kernel): out =
// softmax(q.k^T * scale + bias) . v with an exact online softmax.
//
// Semantics kept from the TPU kernel:
//  * q.k^T is taken on input-dtype values with f32 accumulation (a bf16
//    product is exact in f32, so converting to f32 and using f32 FMAs is
//    the same arithmetic);
//  * the running max m, running sum l and the output accumulator are f32;
//  * p is rounded to the input dtype before p.v, l sums the unrounded p;
//  * a row whose sum is 0 yields 0;
//  * keys at or beyond kv_len are masked, and a ragged edge tile never
//    reads out of bounds (out-of-range rows load as 0);
//  * the bias is (1, H, N, Nk), shared across the batch, or (B, H, N, Nk).
//
// What bounds it on the H100: at the BEiT-L shapes (D = 64, N = 1025 or
// 1793, bias streamed once per batch element) the work is ~4.N^2.D flops
// per head against 2.N^2 bias bytes, well above the card's flop/byte
// balance, so the kernel is compute bound.  This first version runs the
// two products on the CUDA cores in f32 (a 4x8 register micro-tile per
// thread over 64x64 tiles staged in shared memory, the bias tile staged
// coalesced), which keeps f32 inputs exact and bf16 inputs identical in
// arithmetic.  Tensor cores (mma.sync / wgmma) and TMA-fed pipelines are
// the follow-up that would lift the bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim (the kernel supports only 64)
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128; // 16 row groups x 8 column groups
constexpr int LD = D + 1;    // padded smem row stride (no bank conflicts)
constexpr int LS = BK + 1;

constexpr size_t kSmemBytes =
    sizeof(float) * (BQ * LD + BK * LD + BK * D + BQ * LS);

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ bias,
          T* __restrict__ out, int H, int N, int NK, int bias_batch,
          float scale) {
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
    const T* qp = q + bh * N * D;
    const T* kp = k + bh * NK * D;
    const T* vp = v + bh * NK * D;
    const T* bp = bias ? bias + ((size_t)(bias_batch == 1 ? 0 : b) * H + h)
                                    * N * NK
                       : nullptr;

    for (int e = tid; e < BQ * D; e += THREADS) {
        const int r = e / D, c = e % D;
        const int qr = q0 + r;
        Qs[r * LD + c] = qr < N ? to_f<T>(qp[(size_t)qr * D + c]) : 0.f;
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
            Ks[r * LD + c] = ok ? to_f<T>(kp[(size_t)kr * D + c]) : 0.f;
            Vs[r * D + c] = ok ? to_f<T>(vp[(size_t)kr * D + c]) : 0.f;
        }
        if (bp) {
            for (int e = tid; e < BQ * BK; e += THREADS) {
                const int r = e / BK, c = e % BK;
                const int qr = q0 + r, kc = k0 + c;
                Ss[r * LS + c] = (qr < N && kc < NK)
                    ? to_f<T>(bp[(size_t)qr * NK + kc]) : 0.f;
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
                s[i][j] = to_f<T>(from_f<T>(p));
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
            out[(bh * N + qr) * D + tx + 8 * j] = from_f<T>(acc[i][j] * inv);
    }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int H, int N, int NK,
                   int bias_batch, float scale, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    dim3 grid((N + BQ - 1) / BQ, H, B);
    flash_fwd<T><<<grid, THREADS, kSmemBytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)bias, (T*)out, H, N,
        NK, bias_batch, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bias may be null; bias_batch is its
// leading dim (1 = shared across the batch, B = per batch element).
// Returns a cudaError_t (0 on success).
int flash_attention_forward(const void* q, const void* k, const void* v,
                            const void* bias, void* out, int B, int H, int N,
                            int NK, int head_dim, int bias_batch, float scale,
                            int dtype, void* stream) {
    if (head_dim != D || N < 1 || NK < 1 || B < 1 || H < 1 || B > 65535 ||
        H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return (int)launch<float>(q, k, v, bias, out, B, H, N, NK, bias_batch,
                                  scale, s);
    if (dtype == 1)
        return (int)launch<__nv_bfloat16>(q, k, v, bias, out, B, H, N, NK,
                                          bias_batch, scale, s);
    return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
