// Fused int8 base + perturbed-LoRA matmul for Hopper (K3):
//   out = x @ (q8 * scale) + lora_scale * (x @ a_k) @ b_k
// with a_k = a.w + c_a * a.u @ a.v^T and b_k = b.w + c_b * b.u @ b.v^T, for
// one or several ES member lanes (rows grouped lane-major, one (u, v, c) set
// per lane, w shared).
//
// Replaces the TPU kernel hyperscalees_t2i_tpu/ops/fused_qlora.py:_qlora_kernel
// (launched by _pallas_fused_qlora). That kernel keeps one [din, bn] s8 base
// tile and the whole token tile in VMEM and runs the chain against them. A
// Hopper block has at most 227 KB of shared memory, so this kernel keeps the
// structure of csrc/int8_matmul.cu (K1): 64x64 output tiles, the reduction
// axis din looped through shared memory in stages of 32, 256 threads with 4x4
// outputs each. In the same K loop the block also sums the thin products
// x @ a.w [64, r_l] and x @ a.u [64, r_e]: they are r_l + r_e (at most 32)
// extra output columns, and each thread sums them for its own 4 rows from
// the x values it has already loaded into registers for the base term, so
// the thin part costs one more shared-memory load per step (two when
// r_l + r_e > 16) and 4 (8) more FMAs beside the base term's 8 loads and 16
// FMAs. The epilogue forms xa, applies b.w, b.u and b.v for the
// block's 64 output columns (csrc/lora_chain.cuh), adds the scaled base term
// and writes x's dtype. xa is recomputed by every column tile, as on the TPU:
// r_l + r_e extra columns against the tile's 64.
//
// Arithmetic: f32 throughout. bf16 x, s8 q8 and the bf16 noise factors are
// widened exactly; the per-column scale is applied once in the epilogue.
//
// What bounds it: at the DiT's T = 1024 sites the work is compute-bound on
// the card (~10 GFLOP per call against ~5 MB of s8 weights); at T = 1 and
// T = 32 it is bound by reading the s8 kernel. Like K1 this first version
// multiplies with f32 FMAs on the CUDA cores (67 TFLOP/s peak), not the
// tensor cores, so it sits far above the compute bound at large T; it reads
// each s8 weight once per 64-row tile of x, and the LoRA chain adds no pass
// over x and no write of a perturbed factor to device memory. Tensor-core
// tiles for the base term are the next step, as for K1.

#include "lora_chain.cuh"

namespace {

using namespace lora_chain;

constexpr int BM = 64;   // rows of x per block (all of one lane)
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // reduction depth per shared-memory stage
constexpr int THREADS = 256;

struct KLoop {
    float xs[BK][BM + 1];  // x tile, transposed, padded against bank conflicts
    float ws[BK][BN];      // s8 base tile widened to f32
    float ts[BK][MAX_THIN];  // a.w | a.u rows of this stage
};

union Smem {
    KLoop k;
    EpilogueSmem<BM, BN> e;
};

template <typename T, typename NT>
__global__ void __launch_bounds__(THREADS, 3)
fused_qlora_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ out, Factors f,
                   int rows_per_lane, int K, int N, float lora_scale) {
    __shared__ Smem sm;
    __shared__ float thin[BM][MAX_THIN + 1];

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // output columns tx, tx+16, tx+32, tx+48
    const int ty = tid / 16;  // output rows    ty, ty+16, ty+32, ty+48
    const int lane = blockIdx.z;
    const int row0 = blockIdx.y * BM;  // first row of the tile, inside the lane
    const int col0 = blockIdx.x * BN;
    const T* xl = x + (long long)lane * rows_per_lane * K;
    T* ol = out + (long long)lane * rows_per_lane * N;
    const bool wide = f.r_l + f.r_e > 16;  // thin columns tx and tx + 16

    float acc[4][4], tacc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        tacc[i][0] = tacc[i][1] = 0.f;
    }

    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int it = 0; it < (BM * BK) / THREADS; ++it) {
            const int i = tid + it * THREADS;
            const int r = i / BK, c = i % BK;
            const int gr = row0 + r, gc = k0 + c;
            sm.k.xs[c][r] = (gr < rows_per_lane && gc < K) ? to_f32(xl[(long long)gr * K + gc]) : 0.f;
        }
#pragma unroll
        for (int it = 0; it < (BK * BN) / THREADS; ++it) {
            const int i = tid + it * THREADS;
            const int r = i / BN, c = i % BN;
            const int gr = k0 + r, gc = col0 + c;
            sm.k.ws[r][c] = (gr < K && gc < N) ? (float)(int8_t)q[(long long)gr * N + gc] : 0.f;
        }
        load_thin_tile<NT, BK>(sm.k.ts, f, lane, k0, K, tid, THREADS);
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = sm.k.xs[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = sm.k.ws[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            const float t0 = sm.k.ts[kk][tx];
#pragma unroll
            for (int i = 0; i < 4; ++i) tacc[i][0] = fmaf(a[i], t0, tacc[i][0]);
            if (wide) {
                const float t1 = sm.k.ts[kk][tx + 16];
#pragma unroll
                for (int i = 0; i < 4; ++i) tacc[i][1] = fmaf(a[i], t1, tacc[i][1]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        thin[ty + 16 * i][tx] = tacc[i][0];
        thin[ty + 16 * i][tx + 16] = tacc[i][1];
    }
    // every thread left the K loop through its final barrier, so the
    // epilogue may now reuse the K loop's shared memory
    chain_prologue<NT>(sm.e, thin, f, lane, col0, N, tid, THREADS);

    const float cb = f.cb[lane];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c >= N) continue;
        const float s = scale[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = row0 + ty + 16 * i;
            if (r >= rows_per_lane) continue;
            const float d = chain_at(sm.e, f.r_l, f.r_e, cb, ty + 16 * i, tx + 16 * j);
            ol[(long long)r * N + c] = from_f32<T>(fmaf(lora_scale, d, acc[i][j] * s));
        }
    }
}

template <typename T, typename NT>
int launch(const void* x, const void* q, const void* scale, void* out,
           const void* aw, const void* au, const void* av,
           const void* bw, const void* bu, const void* bv,
           const void* ca, const void* cb,
           int rows_per_lane, int lanes, int K, int N, int r_l, int r_e,
           long long au_ls, long long av_ls, long long bu_ls, long long bv_ls,
           float lora_scale, void* stream) {
    if (r_l < 1 || r_l > MAX_RL || r_e < 1 || r_e > MAX_RE) return (int)cudaErrorInvalidValue;
    if (rows_per_lane <= 0 || lanes <= 0 || N <= 0) return (int)cudaSuccess;
    Factors f{(const float*)aw, au, av, (const float*)bw, bu, bv,
              (const float*)ca, (const float*)cb, au_ls, av_ls, bu_ls, bv_ls, r_l, r_e};
    dim3 grid((N + BN - 1) / BN, (rows_per_lane + BM - 1) / BM, lanes);
    fused_qlora_kernel<T, NT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const int8_t*)q, (const float*)scale, (T*)out, f,
        rows_per_lane, K, N, lora_scale);
    return (int)cudaGetLastError();
}

}  // namespace

// x [lanes * rows_per_lane, K] and out [.., N] in x's dtype; q [K, N] s8;
// scale [N] f32; a.w [K, r_l] and b.w [r_l, N] f32; a.u [K, r_e],
// a.v [r_l, r_e], b.u [r_l, r_e], b.v [N, r_e] per lane (lane strides in
// elements) in the noise dtype; c_a, c_b [lanes] f32. Entry names:
// hses_fused_qlora_<x dtype>_<noise dtype>.
#define HSES_FUSED_QLORA_ENTRY(NAME, T, NT)                                                   \
    extern "C" int NAME(const void* x, const void* q, const void* scale, void* out,          \
                        const void* aw, const void* au, const void* av, const void* bw,      \
                        const void* bu, const void* bv, const void* ca, const void* cb,      \
                        int rows_per_lane, int lanes, int K, int N, int r_l, int r_e,        \
                        long long au_ls, long long av_ls, long long bu_ls, long long bv_ls,  \
                        float lora_scale, void* stream) {                                    \
        return launch<T, NT>(x, q, scale, out, aw, au, av, bw, bu, bv, ca, cb,              \
                             rows_per_lane, lanes, K, N, r_l, r_e,                          \
                             au_ls, av_ls, bu_ls, bv_ls, lora_scale, stream);               \
    }

HSES_FUSED_QLORA_ENTRY(hses_fused_qlora_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
HSES_FUSED_QLORA_ENTRY(hses_fused_qlora_bf16_f32, __nv_bfloat16, float)
HSES_FUSED_QLORA_ENTRY(hses_fused_qlora_f32_bf16, float, __nv_bfloat16)
HSES_FUSED_QLORA_ENTRY(hses_fused_qlora_f32_f32, float, float)
