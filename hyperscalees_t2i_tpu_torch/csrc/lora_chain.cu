// Perturbed-LoRA chain for Hopper (K2):
//   out = scale * (x @ a_k) @ b_k
// with a_k = a.w + c_a * a.u @ a.v^T and b_k = b.w + c_b * b.u @ b.v^T, for
// one or several ES member lanes (rows grouped lane-major, one (u, v, c) set
// per lane, w shared). It is the LoRA delta of a float base site under the
// factored ES perturbation; the base matmul itself stays outside.
//
// Replaces the TPU kernel hyperscalees_t2i_tpu/ops/fused_lora.py:_chain_kernel
// (launched by _pallas_member_lora_delta), which runs the four thin products
// on one VMEM-resident token tile with all factors loaded whole. Here a block
// owns 32 rows of one lane: its K loop streams the x tile through shared
// memory in stages of 32 and sums x @ a.w [32, r_l] and x @ a.u [32, r_e];
// then it forms xa and xb once (csrc/lora_chain.cuh) and writes its
// [32, dout] output in chunks of 64 columns, each chunk's slices of b.w and
// b.v loaded into shared memory first.
//
// Arithmetic: f32 throughout; bf16 x and bf16 noise factors are widened.
//
// What bounds it: bytes. Per row it reads din values of x and writes dout
// values, and does only 2 * (r_l + r_e) * (din + dout) flops, about 12
// flops per byte at r_l = 8, r_e = 4 in bf16: far below the card's ~300. The
// design reads x once and writes the output once, with nothing in between
// touching device memory. A token tile of 32 rows leaves few blocks at small
// T (one block for T = 1); a split over column chunks is the next step.

#include "lora_chain.cuh"

namespace {

using namespace lora_chain;

constexpr int BM = 32;   // rows of x per block (all of one lane)
constexpr int BN = 64;   // output columns per chunk
constexpr int BK = 32;   // reduction depth per shared-memory stage
constexpr int THREADS = 256;
constexpr int TACC = (BM * MAX_THIN + THREADS - 1) / THREADS;

struct KLoop {
    float xs[BK][BM + 1];
    float ts[BK][MAX_THIN];
};

union Smem {
    KLoop k;
    EpilogueSmem<BM, BN> e;
};

template <typename T, typename NT>
__global__ void __launch_bounds__(THREADS)
lora_chain_kernel(const T* __restrict__ x, T* __restrict__ out, Factors f,
                  int rows_per_lane, int K, int N, float scale) {
    __shared__ Smem sm;
    __shared__ float thin[BM][MAX_THIN + 1];

    const int tid = threadIdx.x;
    const int lane = blockIdx.y;
    const int row0 = blockIdx.x * BM;
    const T* xl = x + (long long)lane * rows_per_lane * K;
    T* ol = out + (long long)lane * rows_per_lane * N;
    const int R = f.r_l + f.r_e;
    const int nthin = (BM * R + THREADS - 1) / THREADS;

    float tacc[TACC];
#pragma unroll
    for (int t = 0; t < TACC; ++t) tacc[t] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int it = 0; it < (BM * BK) / THREADS; ++it) {
            const int i = tid + it * THREADS;
            const int r = i / BK, c = i % BK;
            const int gr = row0 + r, gc = k0 + c;
            sm.k.xs[c][r] = (gr < rows_per_lane && gc < K) ? to_f32(xl[(long long)gr * K + gc]) : 0.f;
        }
        load_thin_tile<NT, BK>(sm.k.ts, f, lane, k0, K, tid, THREADS);
        __syncthreads();
#pragma unroll
        for (int t = 0; t < TACC; ++t) {
            const int o = tid + t * THREADS;
            if (t < nthin && o < BM * R) {
                const int r = o / R, c = o % R;
                float s = tacc[t];
                for (int kk = 0; kk < BK; ++kk) s = fmaf(sm.k.xs[kk][r], sm.k.ts[kk][c], s);
                tacc[t] = s;
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int t = 0; t < TACC; ++t) {
        const int o = tid + t * THREADS;
        if (t < nthin && o < BM * R) thin[o / R][o % R] = tacc[t];
    }

    const float cb = f.cb[lane];
    for (int col0 = 0; col0 < N; col0 += BN) {
        // xa and xb are recomputed per chunk from `thin` (a few hundred
        // flops), so the epilogue state fits the K loop's shared memory
        chain_prologue<NT>(sm.e, thin, f, lane, col0, N, tid, THREADS);
        for (int o = tid; o < BM * BN; o += THREADS) {
            const int r = o / BN, c = o % BN;
            if (row0 + r < rows_per_lane && col0 + c < N)
                ol[(long long)(row0 + r) * N + col0 + c] =
                    from_f32<T>(scale * chain_at(sm.e, f.r_l, f.r_e, cb, r, c));
        }
        __syncthreads();  // the next chunk overwrites the b.w / b.v slices
    }
}

template <typename T, typename NT>
int launch(const void* x, void* out,
           const void* aw, const void* au, const void* av,
           const void* bw, const void* bu, const void* bv,
           const void* ca, const void* cb,
           int rows_per_lane, int lanes, int K, int N, int r_l, int r_e,
           long long au_ls, long long av_ls, long long bu_ls, long long bv_ls,
           float scale, void* stream) {
    if (r_l < 1 || r_l > MAX_RL || r_e < 1 || r_e > MAX_RE) return (int)cudaErrorInvalidValue;
    if (rows_per_lane <= 0 || lanes <= 0 || N <= 0) return (int)cudaSuccess;
    Factors f{(const float*)aw, au, av, (const float*)bw, bu, bv,
              (const float*)ca, (const float*)cb, au_ls, av_ls, bu_ls, bv_ls, r_l, r_e};
    dim3 grid((rows_per_lane + BM - 1) / BM, lanes);
    lora_chain_kernel<T, NT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, (T*)out, f, rows_per_lane, K, N, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// x [lanes * rows_per_lane, K] and out [.., N] in x's dtype; a.w [K, r_l] and
// b.w [r_l, N] f32; a.u [K, r_e], a.v [r_l, r_e], b.u [r_l, r_e], b.v [N, r_e]
// per lane (lane strides in elements) in the noise dtype; c_a, c_b [lanes]
// f32. Entry names: hses_lora_chain_<x dtype>_<noise dtype>.
#define HSES_LORA_CHAIN_ENTRY(NAME, T, NT)                                                    \
    extern "C" int NAME(const void* x, void* out, const void* aw, const void* au,            \
                        const void* av, const void* bw, const void* bu, const void* bv,      \
                        const void* ca, const void* cb,                                      \
                        int rows_per_lane, int lanes, int K, int N, int r_l, int r_e,        \
                        long long au_ls, long long av_ls, long long bu_ls, long long bv_ls,  \
                        float scale, void* stream) {                                         \
        return launch<T, NT>(x, out, aw, au, av, bw, bu, bv, ca, cb,                        \
                             rows_per_lane, lanes, K, N, r_l, r_e,                          \
                             au_ls, av_ls, bu_ls, bv_ls, scale, stream);                    \
    }

HSES_LORA_CHAIN_ENTRY(hses_lora_chain_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
HSES_LORA_CHAIN_ENTRY(hses_lora_chain_bf16_f32, __nv_bfloat16, float)
HSES_LORA_CHAIN_ENTRY(hses_lora_chain_f32_bf16, float, __nv_bfloat16)
HSES_LORA_CHAIN_ENTRY(hses_lora_chain_f32_f32, float, float)
