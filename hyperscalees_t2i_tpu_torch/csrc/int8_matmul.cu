// W8A16 dequant-matmul for Hopper: out = x @ (q8 * scale).
//
// Replaces the TPU kernel hyperscalees_t2i_tpu/ops/quant_mm.py:_int8_mm_kernel
// (launched by _pallas_int8_matmul). That kernel holds one token tile of x and
// the whole [din, dout] int8 kernel in VMEM and dequantizes it there. A Hopper
// block has at most 227 KB of shared memory, so this kernel instead tiles the
// reduction axis K in a loop through shared memory and tiles the output in
// 64x64 blocks spread over the SMs.
//
// Arithmetic: x (bf16 or f32) and q8 (s8, sign-extended) are widened to f32,
// the products are summed in f32 over K in a fixed order, and the per-column
// scale is applied once in the epilogue: x@(q*s) == (x@q)*s up to rounding.
// Every output element is summed in the same order whatever the number of
// rows, so a row's result does not depend on the other rows in the call.
//
// What bounds it: at the serving shapes (T = 1024..4096 tokens, K, N ~ 2k-11k)
// the work is compute-bound on the card (~300 flop per byte of the int8 base);
// at T = 1 and T = 32 it is bound by reading the int8 kernel. This first
// version multiplies with f32 FMAs on the CUDA cores (67 TFLOP/s peak), not
// the tensor cores (989 TFLOP/s bf16), so it sits far above the compute bound
// at large T. It reads each int8 weight once per 64-row tile of x and never
// writes a dequantized copy to device memory. Tensor-core (mma/wgmma) tiles,
// TMA loads and a pipelined K loop are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of x per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // reduction depth per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each owning 4 x 4 outputs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, T* __restrict__ out,
               int M, int K, int N) {
    // x tile stored transposed ([k][row]) and padded by one column so the
    // transposing store hits 32 different banks.
    __shared__ float xs[BK][BM + 1];
    __shared__ float ws[BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // output columns tx, tx+16, tx+32, tx+48
    const int ty = tid / 16;  // output rows    ty, ty+16, ty+32, ty+48
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int it = 0; it < (BM * BK) / THREADS; ++it) {
            const int i = tid + it * THREADS;
            const int r = i / BK, c = i % BK;
            const int gr = row0 + r, gc = k0 + c;
            xs[c][r] = (gr < M && gc < K) ? to_f32(x[(int64_t)gr * K + gc]) : 0.f;
        }
#pragma unroll
        for (int it = 0; it < (BK * BN) / THREADS; ++it) {
            const int i = tid + it * THREADS;
            const int r = i / BN, c = i % BN;
            const int gr = k0 + r, gc = col0 + c;
            ws[r][c] = (gr < K && gc < N) ? (float)(int8_t)q[(int64_t)gr * N + gc] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c >= N) continue;
        const float s = scale[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = row0 + ty + 16 * i;
            if (r < M) out[(int64_t)r * N + c] = from_f32<T>(acc[i][j] * s);
        }
    }
}

template <typename T>
int launch(const void* x, const void* q, const void* scale, void* out,
           int M, int K, int N, void* stream) {
    if (M <= 0 || N <= 0) return (int)cudaSuccess;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int8_mm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const int8_t*)q, (const float*)scale, (T*)out, M, K, N);
    return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] bf16 row-major, q [K, N] s8 row-major, scale [N] f32, out [M, N] bf16.
extern "C" int hses_int8_matmul_bf16(const void* x, const void* q, const void* scale,
                                     void* out, int M, int K, int N, void* stream) {
    return launch<__nv_bfloat16>(x, q, scale, out, M, K, N, stream);
}

// The same with x and out in f32.
extern "C" int hses_int8_matmul_f32(const void* x, const void* q, const void* scale,
                                    void* out, int M, int K, int N, void* stream) {
    return launch<float>(x, q, scale, out, M, K, N, stream);
}
