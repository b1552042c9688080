// W8A16 dequant-matmul for Hopper: out[M, N] = (x[M, K] @ q8[K, N]) * scale[N].
//
// Replaces the TPU kernel hyperscalees_t2i_tpu/ops/quant_mm.py:_int8_mm_kernel
// (launched by _pallas_int8_matmul through pl.pallas_call). That kernel holds
// one token tile of x and the whole s8 [K, N] kernel in VMEM and dequantizes
// it there, so no dequantized copy of the weight ever reaches HBM. This one
// keeps that property: q8 moves as raw bytes into shared memory and becomes
// bf16 there; the per-column scale is applied once in the f32 epilogue
// (x@(q*s) == (x@q)*s up to rounding).
//
// What bounds it on the H100 (989 TFLOP/s bf16 tensor cores, 3.35 TB/s):
// - M >= 1024 (the DiT and DC-AE shapes): operations. 2MKN flop against
//   K*N + 2M(K+N) bytes is 300-2000 flop a byte, above the card's 295.
// - M <= 50 (timestep, caption, CLIP-B/32, the projections): the bytes of
//   the s8 weight; M = 256/257 (CLIP-H) sits near the balance point.
// - At every M <= 257 the work is a few microseconds, so launch latency and
//   filling 132 SMs matter more than the inner loop.
//
// Design.
// - bf16 x: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 sums).
//   s8 values are exact in bf16 and each bf16 product is exact in f32, so
//   converting q8 loses nothing. The K loop (int8_tile.cuh, shared with K3
//   in fused_qlora.cu) streams 64-deep stages through a
//   4-stage ring in shared memory filled by cp.async, one barrier a stage:
//   x tiles (16-byte copies, or 8-byte where K % 8 or x's alignment forbids
//   them, or element loads) in rows padded by 16 bytes so ldmatrix reads
//   them without bank conflicts; q8 tiles as raw bytes (16 a copy). The s8
//   values become bf16 in registers (the faster of the two ways): a warp's
//   four n8 tiles take four adjacent columns, so one 32-bit shared read of a
//   q8 row serves all four, a byte permute pairs rows k and k+1, and an exact
//   magic-number conversion (no I2F) gives the bf16 pairs of the B fragment.
//   The same column order gives each thread 8 adjacent outputs, stored as
//   16 bytes. Tiles by M, chosen in Python (ops/quant_mm.py:_plan): 128x128
//   with 8 warps (64x32 each) from 120 blocks (0.9 of a wave) up, else 64x64
//   with 4 warps, else 16x64 with 2 warps, so M <= 50 still puts 48-210
//   blocks on the card.
// - f32 x (the T = 1 timestep sites and f32 checks): CUDA-core f32 FMAs,
//   64x64 tiles for M > 8 and, for M <= 8, blocks of 32 columns whose 16
//   warps take alternate 32-deep K chunks.
//
// Batch invariance, bitwise: a row's result never depends on the other rows
// in the call. The tile may depend on M, but the order of each output's sum
// over k depends only on (K, N, dtype): bf16 sums k16 mma steps in ascending
// k; f32 sums each 32-deep K chunk with FMAs in ascending k from zero and
// adds the chunk sums in ascending order, in both f32 layouts. K is never
// split across blocks.
//
// Left for later: wgmma with TMA loads and mbarriers, a warp-specialised
// producer/consumer pipeline, and a persistent grid with tile rasterisation
// (the N = 2240 shapes give 144 blocks of 128x128 for 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16 route

// The tiles and the K loop are int8_tile.cuh's, shared with K3.
using TileL = hses::MmaTile<128, 128, 2, 4, 2>;  // 110,592 B shared, 2 blocks an SM
using TileM = hses::MmaTile<64, 64, 2, 2, 3>;    // 57,344 B
using TileS = hses::MmaTile<16, 64, 1, 2, 4>;    // 29,696 B
constexpr int BK = hses::MMA_BK;

template <class T, int AV, bool BV>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
int8_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int N) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
    const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
    float acc[T::MI][4][4];
    hses::NoExtra none;
    hses::int8_mma_mainloop<T, AV, BV>(x, q, M, K, N, m0, n0, smem, acc, none);

    // epilogue: a thread holds 8 adjacent columns, 8(lane%4) + {0..7}, of
    // rows lane/4 and lane/4 + 8: column 8(lane%4) + j is tile j's c0 (c2),
    // column 8(lane%4) + 4 + j its c1 (c3)
    const int c = n0 + wn * 32 + 8 * (lane & 3);
    float sc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sc[e] = c + e < N ? scale[c + e] : 0.f;
    const bool vec = (N & 7) == 0 && c + 8 <= N;
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int rr = m0 + wm * T::WTM + mi * 16 + (lane >> 2) + 8 * h;
            if (rr >= M || c >= N) continue;
            float v[8];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                v[j] = acc[mi][j][2 * h] * sc[j];
                v[4 + j] = acc[mi][j][2 * h + 1] * sc[4 + j];
            }
            bf16* o = out + (int64_t)rr * N + c;
            if (vec) {
                uint4 p;
                __nv_bfloat162 t0 = __floats2bfloat162_rn(v[0], v[1]), t1 = __floats2bfloat162_rn(v[2], v[3]);
                __nv_bfloat162 t2 = __floats2bfloat162_rn(v[4], v[5]), t3 = __floats2bfloat162_rn(v[6], v[7]);
                p.x = *reinterpret_cast<uint32_t*>(&t0);
                p.y = *reinterpret_cast<uint32_t*>(&t1);
                p.z = *reinterpret_cast<uint32_t*>(&t2);
                p.w = *reinterpret_cast<uint32_t*>(&t3);
                *reinterpret_cast<uint4*>(o) = p;
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    if (c + e < N) o[e] = __float2bfloat16(v[e]);
            }
        }
}

template <class T, int AV, bool BV>
int launch_mma(const void* x, const void* q, const void* scale, void* out, int M, int K, int N,
               cudaStream_t stream) {
    auto kernel = int8_mma_kernel<T, AV, BV>;
    constexpr int smem = T::RING;
    const cudaError_t e = hses::raise_smem_limit(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN);
    if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
    kernel<<<grid, T::THREADS, smem, stream>>>((const bf16*)x, (const int8_t*)q, (const float*)scale,
                                               (bf16*)out, M, K, N);
    return (int)cudaGetLastError();
}

template <class T>
int launch_tile(const void* x, const void* q, const void* scale, void* out, int M, int K, int N,
                int a_vec, int b_vec, cudaStream_t s) {
    if (b_vec == 16) {
        if (a_vec == 8) return launch_mma<T, 8, true>(x, q, scale, out, M, K, N, s);
        if (a_vec == 4) return launch_mma<T, 4, true>(x, q, scale, out, M, K, N, s);
        return launch_mma<T, 1, true>(x, q, scale, out, M, K, N, s);
    }
    if (a_vec == 8) return launch_mma<T, 8, false>(x, q, scale, out, M, K, N, s);
    if (a_vec == 4) return launch_mma<T, 4, false>(x, q, scale, out, M, K, N, s);
    return launch_mma<T, 1, false>(x, q, scale, out, M, K, N, s);
}

// ----------------------------------------------------------------- f32 route

constexpr int KC = 32;  // depth of one f32 K chunk: FMAs inside, adds across

// M > 8: 64x64 tiles, 16x16 threads each owning 4x4 outputs.
constexpr int FBM = 64, FBN = 64, FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
f32_tile_kernel(const float* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
                float* __restrict__ out, int M, int K, int N) {
    __shared__ float xs[KC][FBM + 1];  // transposed [k][row], padded against bank conflicts
    __shared__ float ws[KC][FBN];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int row0 = blockIdx.x * FBM, col0 = blockIdx.y * FBN;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
#pragma unroll
        for (int it = 0; it < (FBM * KC) / FTHREADS; ++it) {
            const int i = tid + it * FTHREADS, r = i / KC, c = i % KC, gr = row0 + r, gc = k0 + c;
            xs[c][r] = (gr < M && gc < K) ? x[(int64_t)gr * K + gc] : 0.f;
        }
#pragma unroll
        for (int it = 0; it < (KC * FBN) / FTHREADS; ++it) {
            const int i = tid + it * FTHREADS, r = i / FBN, c = i % FBN, gr = k0 + r, gc = col0 + c;
            ws[r][c] = (gr < K && gc < N) ? (float)q[(int64_t)gr * N + gc] : 0.f;
        }
        __syncthreads();
        float part[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
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
            if (r < M) out[(int64_t)r * N + c] = acc[i][j] * s;
        }
    }
}

// M <= 8: 32 columns a block (one a lane); warp w sums K chunks w, w+16, ...
// for all 8 rows, then the chunk sums are added in ascending chunk order by
// the thread that owns (row = warp, column = lane). A warp loads its chunk's
// 32 weights into registers before the first FMA, so one memory latency
// covers the chunk.
constexpr int FR = 8, FWARPS = 16;

__global__ void __launch_bounds__(32 * FWARPS)
f32_rows_kernel(const float* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
                float* __restrict__ out, int M, int K, int N) {
    __shared__ __align__(16) float xs[FWARPS][FR][KC];  // each warp's x chunk
    __shared__ float parts[FWARPS][FR][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = blockIdx.x * 32 + lane;
    const int nchunks = (K + KC - 1) / KC;
    float total = 0.f;
    for (int c0 = 0; c0 < nchunks; c0 += FWARPS) {
        const int chunk = c0 + warp;
        float part[FR];
#pragma unroll
        for (int m = 0; m < FR; ++m) part[m] = 0.f;
        if (chunk < nchunks) {
            const int k0 = chunk * KC;
            int8_t w8[KC];
#pragma unroll
            for (int kk = 0; kk < KC; ++kk) {
                const int k = k0 + kk;
                w8[kk] = (k < K && col < N) ? q[(int64_t)k * N + col] : (int8_t)0;
            }
#pragma unroll
            for (int m = 0; m < FR; ++m)
                xs[warp][m][lane] = (m < M && k0 + lane < K) ? x[(int64_t)m * K + k0 + lane] : 0.f;
            __syncwarp();
#pragma unroll
            for (int kk = 0; kk < KC; kk += 4) {
#pragma unroll
                for (int m = 0; m < FR; ++m) {
                    const float4 xv = *reinterpret_cast<const float4*>(&xs[warp][m][kk]);
                    part[m] = fmaf(xv.x, (float)w8[kk], part[m]);
                    part[m] = fmaf(xv.y, (float)w8[kk + 1], part[m]);
                    part[m] = fmaf(xv.z, (float)w8[kk + 2], part[m]);
                    part[m] = fmaf(xv.w, (float)w8[kk + 3], part[m]);
                }
            }
            __syncwarp();
        }
#pragma unroll
        for (int m = 0; m < FR; ++m) parts[warp][m][lane] = part[m];
        __syncthreads();
        if (warp < FR) {
#pragma unroll
            for (int w = 0; w < FWARPS; ++w)
                if (c0 + w < nchunks) total += parts[w][warp][lane];
        }
        __syncthreads();
    }
    if (warp < M && col < N) out[(int64_t)warp * N + col] = total * scale[col];
}

}  // namespace

// Tile ids of ops/quant_mm.py:_plan. bk: the plan's depth of one stage of
// the k sum, refused unless it is this route's own (BK, KC), so the plan
// that the CPU tests check is the order the kernel sums in. a_vec / b_vec:
// elements of x / bytes of q8 per copy, checked here against K, N and the
// pointers' alignment.
enum { F32_ROWS8 = 0, F32_TILE = 1, MMA_128x128 = 2, MMA_64x64 = 3, MMA_16x64 = 4 };

// x [M, K] bf16 row-major, q [K, N] s8 row-major, scale [N] f32, out [M, N] bf16.
extern "C" int hses_int8_matmul_bf16(const void* x, const void* q, const void* scale, void* out,
                                     int M, int K, int N, int tile, int bk, int a_vec, int b_vec,
                                     void* stream) {
    if (bk != BK) return (int)cudaErrorInvalidValue;
    if (M <= 0 || N <= 0) return (int)cudaSuccess;
    const uintptr_t xa = (uintptr_t)x, qa = (uintptr_t)q;
    const bool a_ok = a_vec == 1 || (a_vec == 8 && K % 8 == 0 && xa % 16 == 0) ||
                      (a_vec == 4 && K % 4 == 0 && xa % 8 == 0);
    const bool b_ok = b_vec == 1 || (b_vec == 16 && N % 16 == 0 && qa % 16 == 0);
    if (!a_ok || !b_ok) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (tile) {
        case MMA_128x128: return launch_tile<TileL>(x, q, scale, out, M, K, N, a_vec, b_vec, s);
        case MMA_64x64: return launch_tile<TileM>(x, q, scale, out, M, K, N, a_vec, b_vec, s);
        case MMA_16x64: return launch_tile<TileS>(x, q, scale, out, M, K, N, a_vec, b_vec, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The same with x and out in f32 (a_vec and b_vec are not used).
extern "C" int hses_int8_matmul_f32(const void* x, const void* q, const void* scale, void* out,
                                    int M, int K, int N, int tile, int bk, int a_vec, int b_vec,
                                    void* stream) {
    (void)a_vec;
    (void)b_vec;
    if (bk != KC) return (int)cudaErrorInvalidValue;
    if (M <= 0 || N <= 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    if (tile == F32_ROWS8) {
        if (M > FR) return (int)cudaErrorInvalidValue;
        f32_rows_kernel<<<(N + 31) / 32, 32 * FWARPS, 0, s>>>((const float*)x, (const int8_t*)q,
                                                              (const float*)scale, (float*)out, M, K, N);
    } else if (tile == F32_TILE) {
        const dim3 grid((M + FBM - 1) / FBM, (N + FBN - 1) / FBN);
        if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
        f32_tile_kernel<<<grid, FTHREADS, 0, s>>>((const float*)x, (const int8_t*)q, (const float*)scale,
                                                  (float*)out, M, K, N);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Dynamic shared memory of a bf16 tile's block, in bytes (-1 for any other
// tile id; the f32 routes' shared memory is static and in ptxas's report).
extern "C" int hses_int8_matmul_smem(int tile) {
    switch (tile) {
        case MMA_128x128: return TileL::RING;
        case MMA_64x64: return TileM::RING;
        case MMA_16x64: return TileS::RING;
        default: return -1;
    }
}
