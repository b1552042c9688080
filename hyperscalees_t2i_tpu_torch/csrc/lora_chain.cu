// Perturbed-LoRA chain for Hopper (K2):
//   out = scale * (x @ a_k) @ b_k
// with a_k = a.w + c_a * a.u @ a.v^T and b_k = b.w + c_b * b.u @ b.v^T, for
// one or several ES member lanes (rows grouped lane-major, one (u, v, c) set
// per lane, w shared). It is the LoRA delta of a float base site under the
// factored ES perturbation; the base matmul itself stays outside.
//
// Replaces the TPU kernel hyperscalees_t2i_tpu/ops/fused_lora.py:_chain_kernel
// (launched by _pallas_member_lora_delta), which runs the four thin products
// on one VMEM-resident token tile with all factors loaded whole.
//
// What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s bf16, 67 f32): bytes.
// Per row it reads din values of x and writes dout values and does only
// 2 * (r_l + r_e) * (din + dout) flops, about 12 a byte in bf16 at r_l 8,
// r_e 4: at 1024 x 2240 x 2240, 4.6 MB in, 4.6 MB out, 2.8 us. Below that
// the work is a few microseconds at most, so what decides the time is how
// much of the card a call occupies and how long one block's chain of
// dependent steps is: at T = 32 (41 calls an image) and T = 1 one block
// would walk every output column alone. As built, on an H100 at 700 W a
// call takes 16-26 us of device time (PERF.md section 6): one block of 8
// warps an SM (the ring takes 204 KB), whose k walk and epilogue are
// latency-bound, not the bytes.
//
// The grid: lanes x row tiles x column groups, planned in Python
// (ops/fused_lora.py:_plan) to fill one wave of 132 SMs where the rows
// allow: 32-row tiles x 4 groups of 560 columns at T = 1024 (128 blocks),
// one tile x 35 groups of 64 at T = 32, 130 groups of 104 columns at T = 1.
// Every block sums its rows' thin products over all of din itself (K is
// never split across blocks): x is re-read from L2 once per column group,
// and a call is still one launch.
//
// bf16 x (every main-path site but T = 1): the thin products on the tensor
// cores. x @ a.w and x @ a.u are 2 * (r_l + r_e) columns of
// mma.sync.m16n8k16 bf16 -> f32, 24 at r_l 8, r_e 4 (3 n8 tiles; a wide
// route of 8 tiles takes ranks up to 16 each). Each f32 factor value is
// split into bf16 hi + lo in adjacent columns (lora_chain.cuh, K3's scheme;
// a bf16 a.u value splits into itself and an exact 0). A block of 32 rows
// has too few m16 tiles to keep 8 warps busy on one k walk, so the k walk is
// split: warp w takes the 64-deep stages w, w + 8, w + 16, ... through its
// own ring of cp.async stages in shared memory (x tiles by K1's copy widths,
// raw factor rows), splits each stage into a k-major bf16 slot and reads it
// with ldmatrix.trans; it needs no block barrier until its stages are done.
// The eight warps' partial sums (hi + lo, in f32) are then added through
// shared memory in ascending warp order.
//
// f32 x (the T = 1 time_embed site, and f32 checks): CUDA-core FMAs on
// 8-row tiles: in rounds of 8 chunks of 32 k, warp w sums chunk w of the
// round for the 8 rows (a lane a factor column), and the chunk sums are
// added in ascending chunk order (K3's f32 rule). Each chunk's x and factor
// rows arrive by 16-byte cp.async into the warp's two buffers, the next
// chunk's copies in flight while this one is summed; rows past the lane's
// last are not summed (the T = 1 site fills one row of a tile of 8).
//
// Epilogue, once per block, f32: the block's slices of b.w and b.v^T and
// the lane's a.v, b.u in shared memory, then xa and xb for its rows
// (chain_xa_xb, chain_prologue's order), then each output once: a thread
// takes 8 adjacent columns of 4 rows (the b.w and b.v^T reads shared by the
// rows), each output in chain_row8's order, stored 16 bytes at a time in x's
// dtype.
//
// Batch and lane invariance, bitwise: a row's result never depends on the
// other rows or lanes of the call. The plan may change the column group; it
// may not change the sum order: the stage depth (64 bf16, 32 f32), the
// warps W = 8 and their order are the same for every route, row count, lane
// count and tile, and the C entry refuses a plan that says otherwise. The
// epilogue's order does not depend on the group.

#include "int8_mma.cuh"
#include "lora_chain.cuh"

namespace {

using namespace lora_chain;
using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;  // W: the k walk's split, the same on every route
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 64;         // bf16: depth of one stage (four k16 mma steps)
constexpr int KC = 32;         // f32: depth of one FMA chunk
constexpr int BM = 32;         // bf16: rows of a lane per block
constexpr int FR = 8;          // f32: rows of a lane per block
constexpr int MAX_COLS = 1024; // widest column group (a multiple of 8)

extern __shared__ __align__(16) unsigned char chain_smem[];

__device__ __forceinline__ float ld_noise(const void* p, int64_t i, bool f32) {
    return f32 ? static_cast<const float*>(p)[i] : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// The epilogue of a block of ROWS rows of lane ln and columns [n0, n0 + cols),
// once each thread has written its share of e.thin (the rows' xw | xu; the
// barrier after the loads below orders those writes too): the lane's a.v,
// b.u and the group's b.w, b.v^T slices (zeros past N) into shared memory,
// xa and xb, then every output once. cols % 8 == 0.
template <int ROWS, typename T>
__device__ __forceinline__ void chain_epilogue(ChainRows<ROWS>& e, float* bw, float* bvt, const Factors& f,
                                               bool nt_f32, int ln, int m0, int n0, int cols, int M, int N,
                                               T* __restrict__ ol, float scale) {
    const int tid = threadIdx.x, rl = f.r_l, re = f.r_e;
    const void* av = static_cast<const char*>(f.av) + (int64_t)ln * f.av_ls * (nt_f32 ? 4 : 2);
    const void* bu = static_cast<const char*>(f.bu) + (int64_t)ln * f.bu_ls * (nt_f32 ? 4 : 2);
    const void* bv = static_cast<const char*>(f.bv) + (int64_t)ln * f.bv_ls * (nt_f32 ? 4 : 2);
    for (int i = tid; i < rl * re; i += THREADS) {
        e.av[i / re][i % re] = ld_noise(av, i, nt_f32);
        e.bu[i / re][i % re] = ld_noise(bu, i, nt_f32);
    }
    // the slices: eight loads in flight a thread before their stores
    constexpr int U = 8;
    for (int i0 = tid; i0 < rl * cols; i0 += U * THREADS) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS, l = i / cols, gc = n0 + i % cols;
            v[u] = i < rl * cols && gc < N ? f.bw[(int64_t)l * N + gc] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (i0 + u * THREADS < rl * cols) bw[i0 + u * THREADS] = v[u];
    }
    for (int i0 = tid; i0 < cols * re; i0 += U * THREADS) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS, gc = n0 + i / re;
            v[u] = i < cols * re && gc < N ? ld_noise(bv, (int64_t)n0 * re + i, nt_f32) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS;
            if (i < cols * re) bvt[(i % re) * cols + i / re] = v[u];
        }
    }
    __syncthreads();
    chain_xa_xb<ROWS>(e.xa, e.xb, e.av, e.bu, e.thin, rl, re, f.ca[ln], tid, THREADS);

    // a thread writes 8 adjacent columns of RG rows, the b.w and b.v^T
    // slices read once for them
    constexpr int RG = 4;
    static_assert(ROWS % RG == 0, "row groups");
    const float cb = f.cb[ln];
    const int units = cols / 8;
    const bool vec = (N & 7) == 0;
    for (int u = tid; u < ROWS / RG * units; u += THREADS) {
        const int r0 = RG * (u / units), c = 8 * (u % units), gc = n0 + c;
        if (m0 + r0 >= M || gc >= N) continue;
        float d[RG][8];
        chain_rows8_t<RG>(e.xa + r0, e.xb + r0, bw, bvt, cols, rl, re, cb, c, d);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
            if (m0 + r0 + r >= M) break;
            T* o = ol + (int64_t)(m0 + r0 + r) * N + gc;
#pragma unroll
            for (int i = 0; i < 8; ++i) d[r][i] *= scale;
            if (vec && gc + 8 <= N) {
                if constexpr (sizeof(T) == 2) {
                    uint4 pk;
                    __nv_bfloat162 t0 = __floats2bfloat162_rn(d[r][0], d[r][1]);
                    __nv_bfloat162 t1 = __floats2bfloat162_rn(d[r][2], d[r][3]);
                    __nv_bfloat162 t2 = __floats2bfloat162_rn(d[r][4], d[r][5]);
                    __nv_bfloat162 t3 = __floats2bfloat162_rn(d[r][6], d[r][7]);
                    pk.x = *reinterpret_cast<uint32_t*>(&t0);
                    pk.y = *reinterpret_cast<uint32_t*>(&t1);
                    pk.z = *reinterpret_cast<uint32_t*>(&t2);
                    pk.w = *reinterpret_cast<uint32_t*>(&t3);
                    *reinterpret_cast<uint4*>(o) = pk;
                } else {
                    *reinterpret_cast<float4*>(o) = make_float4(d[r][0], d[r][1], d[r][2], d[r][3]);
                    *reinterpret_cast<float4*>(o + 4) = make_float4(d[r][4], d[r][5], d[r][6], d[r][7]);
                }
            } else {
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    if (gc + i < N) o[i] = from_f32<T>(d[r][i]);
            }
        }
    }
}

// ---------------------------------------------------------------- bf16 route

// A warp's share of the dynamic shared memory during the k walk: NST stages
// of (an x tile [BM][BK + 8] bf16, a raw thin stage) and one split slot.
// After the walk the block reuses all of it: ChainRows, the warps' partial
// sums [W][BM][MAX_THIN + 1], then the b.w and b.v^T slices.
template <int NCOL, int NST>
struct MmaRoute {
    static constexpr int MI = BM / 16;                        // m16 tiles
    static constexpr int TILES = NCOL / 8;                    // n8 tiles of the thin operand
    static constexpr int HALF = NCOL / 2;                     // factor columns: one word each
    static constexpr int SROW = NCOL % 16 ? NCOL : NCOL + 8;  // slot row, bf16: ldmatrix rows on distinct banks
    static constexpr int AS = BK + 8;                         // x row stride, bf16: 16 bytes of padding
    static constexpr int XT = BM * AS * 2;
    static constexpr int RAW = BK * HALF * 4;
    static constexpr int SLOT = BK * SROW * 2;
    static constexpr int STAGE = XT + RAW;
    static constexpr int WARP_BYTES = NST * STAGE + SLOT;
    static constexpr int RING = WARPS * WARP_BYTES;
    static constexpr int PARTS = sizeof(ChainRows<BM>);
    static constexpr int COLS_AT = PARTS + WARPS * BM * (MAX_THIN + 1) * 4;
    static constexpr int EPI = COLS_AT + HALF * MAX_COLS * 4;  // b.w and b.v^T: r_l + r_e <= HALF rows
    static constexpr int SMEM = RING > EPI ? RING : EPI;
    static_assert(XT % 16 == 0 && STAGE % 16 == 0 && WARP_BYTES % 16 == 0 && PARTS % 16 == 0, "16-byte slots");
    static_assert(SMEM <= 232448, "one block's shared memory");
};

template <int NCOL, int NST, int AV>
__global__ void __launch_bounds__(THREADS, 1)
lora_chain_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, Factors f, bool nt_f32,
                      int rows_per_lane, int K, int N, int cols, float scale) {
    using R = MmaRoute<NCOL, NST>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n0 = blockIdx.x * cols, m0 = blockIdx.y * BM, ln = blockIdx.z;
    const int M = rows_per_lane;
    const bf16* xl = x + (int64_t)ln * M * K;
    const char* gu = static_cast<const char*>(f.au) + (int64_t)ln * f.au_ls * (nt_f32 ? 4 : 2);
    const bool quads = f.r_l % 4 == 0 && f.r_e % 4 == 0 && (((uintptr_t)f.aw | (uintptr_t)gu) & 15) == 0;
    const int C = f.r_l + f.r_e, ntiles = (2 * C + 7) / 8;
    const int ktiles = (K + BK - 1) / BK;
    const int mine = warp < ktiles ? (ktiles - warp + WARPS - 1) / WARPS : 0;  // stages warp, warp + W, ...

    unsigned char* wsm = chain_smem + warp * R::WARP_BYTES;
    auto xs = [&](int i) { return reinterpret_cast<bf16*>(wsm + (i % NST) * R::STAGE); };
    auto raw = [&](int i) { return reinterpret_cast<uint32_t*>(wsm + (i % NST) * R::STAGE + R::XT); };
    bf16* slot = reinterpret_cast<bf16*>(wsm + NST * R::STAGE);

    // the warp's i-th stage (global stage warp + W i): x rows [m0, m0 + BM) and
    // the thin factor rows, k in [64 s, 64 s + 64), zeros past M and K
    auto load = [&](int i) {
        const int k0 = (warp + WARPS * i) * BK;
        bf16* a = xs(i);
        if constexpr (AV > 1) {
            constexpr int CPR = BK / AV;
#pragma unroll
            for (int e = lane; e < BM * CPR; e += 32) {
                const int r = e / CPR, c = (e % CPR) * AV, gr = m0 + r, gk = k0 + c;
                const bool ok = gr < M && gk < K;
                const bf16* src = ok ? xl + (int64_t)gr * K + gk : x;
                if constexpr (AV == 8) hses::cp_async16(a + r * R::AS + c, src, ok ? 16 : 0);
                else hses::cp_async8(a + r * R::AS + c, src, ok ? 8 : 0);
            }
        } else {
            for (int e = lane; e < BM * BK; e += 32) {
                const int r = e / BK, c = e % BK, gr = m0 + r, gk = k0 + c;
                a[r * R::AS + c] = (gr < M && gk < K) ? xl[(int64_t)gr * K + gk] : __float2bfloat16(0.f);
            }
        }
        load_thin_raw<BK, R::HALF, 32>(raw(i), f, gu, nt_f32, quads, k0, K, lane);
    };

    float acc[R::MI][R::TILES][4];
#pragma unroll
    for (int mi = 0; mi < R::MI; ++mi)
#pragma unroll
        for (int j = 0; j < R::TILES; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

#pragma unroll
    for (int i = 0; i < NST - 1; ++i) {
        if (i < mine) load(i);
        hses::cp_async_commit();
    }
    for (int i = 0; i < mine; ++i) {
        if (i + NST - 1 < mine) load(i + NST - 1);  // into the stage that step i - 1 finished with
        hses::cp_async_commit();
        hses::cp_async_wait<NST - 1>();
        __syncwarp();  // stage i landed for the whole warp
        split_thin_raw<BK, R::HALF, R::SROW, 32>(reinterpret_cast<uint32_t*>(slot), raw(i), f.r_l, C, nt_f32,
                                                 quads, lane);
        __syncwarp();
        const bf16* a = xs(i);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t af[R::MI][4];
#pragma unroll
            for (int mi = 0; mi < R::MI; ++mi)
                hses::ldmatrix_x4(af[mi], a + (mi * 16 + (lane & 15)) * R::AS + kk + (lane >> 4) * 8);
            const bf16* s = slot + (kk + (lane & 15)) * R::SROW;  // lanes 0-15: rows kk .. kk + 15
#pragma unroll
            for (int j = 0; j < R::TILES; ++j) {
                if (j < ntiles) {
                    uint32_t b0, b1;
                    hses::ldmatrix_x2_trans(b0, b1, s + 8 * j);
#pragma unroll
                    for (int mi = 0; mi < R::MI; ++mi) hses::mma_bf16_16816(acc[mi][j], af[mi], b0, b1);
                }
            }
        }
        __syncwarp();  // the warp is done with stage i and the slot
    }
    hses::cp_async_wait<0>();
    __syncthreads();  // every warp is done with its ring: the epilogue reuses it

    ChainRows<BM>& e = *reinterpret_cast<ChainRows<BM>*>(chain_smem);
    float(*parts)[BM][MAX_THIN + 1] = reinterpret_cast<float(*)[BM][MAX_THIN + 1]>(chain_smem + R::PARTS);
    float* bw = reinterpret_cast<float*>(chain_smem + R::COLS_AT);
    // a thread holds columns 2 (lane % 4) and 2 (lane % 4) + 1 of n8 tile j
    // (c0, c1 for row lane / 4; c2, c3 for row lane / 4 + 8): hi and lo of
    // factor column p = 4 j + lane % 4
#pragma unroll
    for (int mi = 0; mi < R::MI; ++mi)
#pragma unroll
        for (int j = 0; j < R::TILES; ++j) {
            if (j < ntiles) {
                const int r = mi * 16 + (lane >> 2), p = 4 * j + (lane & 3);
                parts[warp][r][p] = acc[mi][j][0] + acc[mi][j][1];
                parts[warp][r + 8][p] = acc[mi][j][2] + acc[mi][j][3];
            }
        }
    __syncthreads();
    for (int o = threadIdx.x; o < BM * C; o += THREADS) {
        const int r = o / C, p = o % C;
        float s = parts[0][r][p];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += parts[w][r][p];  // ascending warp order
        e.thin[r][p] = s;
    }
    // the slices follow the parts, so the loads need no barrier against them
    chain_epilogue<BM>(e, bw, bw + f.r_l * cols, f, nt_f32, ln, m0, n0, cols, M, N,
                       out + (int64_t)ln * M * N, scale);
}

// ----------------------------------------------------------------- f32 route

// Dynamic shared memory: each warp's two x chunks [FR][KC], the chunk sums
// [W][FR][32], ChainRows, each warp's two staged factor chunks (KC rows of
// a.w, then KC rows of the lane's a.u in the noise dtype: f_stage bytes),
// then the b.w and b.v^T slices.
constexpr int F_XS = 2 * WARPS * FR * KC * 4;
constexpr int F_PARTS = WARPS * FR * 32 * 4;
constexpr int F_ROWS_AT = F_XS + F_PARTS;
constexpr int F_STAGE_AT = F_ROWS_AT + (int)sizeof(ChainRows<FR>);
constexpr int F_SMEM = F_STAGE_AT + WARPS * 2 * KC * MAX_THIN * 4 + MAX_THIN * MAX_COLS * 4;
static_assert(F_STAGE_AT % 16 == 0 && F_SMEM <= 232448, "f32 route's shared memory");

__host__ __device__ __forceinline__ int f_stage(int r_l, int r_e, int nsize) { return KC * (r_l * 4 + r_e * nsize); }

template <typename NT>
__global__ void __launch_bounds__(THREADS, 1)
lora_chain_f32_kernel(const float* __restrict__ x, float* __restrict__ out, Factors f, int rows_per_lane, int K,
                      int N, int cols, float scale) {
    constexpr int NS = sizeof(NT);
    float(*xs)[WARPS][FR][KC] = reinterpret_cast<float(*)[WARPS][FR][KC]>(chain_smem);
    float(*parts)[FR][32] = reinterpret_cast<float(*)[FR][32]>(chain_smem + F_XS);
    ChainRows<FR>& e = *reinterpret_cast<ChainRows<FR>*>(chain_smem + F_ROWS_AT);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n0 = blockIdx.x * cols, m0 = blockIdx.y * FR, ln = blockIdx.z;
    const int M = rows_per_lane, r_l = f.r_l, r_e = f.r_e, C = r_l + r_e;
    const int sb = f_stage(r_l, r_e, NS), uoff = KC * r_l * 4;
    unsigned char* stages = chain_smem + F_STAGE_AT + warp * 2 * sb;
    float* bw = reinterpret_cast<float*>(chain_smem + F_STAGE_AT + WARPS * 2 * sb);
    const float* xl = x + (int64_t)ln * M * K;
    const char* gu = static_cast<const char*>(f.au) + (int64_t)ln * f.au_ls * NS;
    const int nchunks = (K + KC - 1) / KC, mv = min(FR, M - m0);
    // 16-byte copies where K and the addresses allow (the main path), else element copies
    const bool wide = K % 4 == 0 && (((uintptr_t)xl | (uintptr_t)f.aw | (uintptr_t)gu) & 15) == 0;

    // chunk c (k in [32 c, 32 c + 32), zeros past K and M) into the warp's buffer b
    auto stage = [&](int b, int c) {
        const int k0 = c * KC, rows = min(KC, K - k0);
        float* xd = &xs[b][warp][0][0];
        unsigned char* sd = stages + b * sb;
        const char* ws = reinterpret_cast<const char*>(f.aw + (int64_t)k0 * r_l);
        const char* us = gu + (int64_t)k0 * r_e * NS;
        if (wide) {
            for (int j = lane; j < FR * KC / 4; j += 32) {
                const int m = j / (KC / 4), q = 4 * (j % (KC / 4));
                const bool ok = m0 + m < M && q < rows;
                hses::cp_async16(xd + m * KC + q, ok ? xl + (int64_t)(m0 + m) * K + k0 + q : xl, ok ? 16 : 0);
            }
            for (int j = lane; j < KC * r_l / 4; j += 32) {
                const int n = max(0, min(16, rows * r_l * 4 - 16 * j));
                hses::cp_async16(sd + 16 * j, n ? ws + 16 * j : ws, n);
            }
            for (int j = lane; j < KC * r_e * NS / 16; j += 32) {
                const int n = max(0, min(16, rows * r_e * NS - 16 * j));
                hses::cp_async16(sd + uoff + 16 * j, n ? us + 16 * j : us, n);
            }
            return;
        }
        for (int m = 0; m < FR; ++m)
            xd[m * KC + lane] = (m0 + m < M && lane < rows) ? xl[(int64_t)(m0 + m) * K + k0 + lane] : 0.f;
        for (int i = lane; i < KC * r_l; i += 32)
            reinterpret_cast<float*>(sd)[i] = i < rows * r_l ? reinterpret_cast<const float*>(ws)[i] : 0.f;
        const int uh = r_e * NS / 2;  // 2-byte halves of an a.u row
        for (int i = lane; i < KC * uh; i += 32)
            reinterpret_cast<unsigned short*>(sd + uoff)[i] =
                i < rows * uh ? reinterpret_cast<const unsigned short*>(us)[i] : (unsigned short)0;
    };
    // lane p's factor column at row kk of a staged chunk, as 32-bit words
    // without a branch: a.w's word (kk r_l + p), a.u's element kk r_e + p -
    // r_l (a bf16 one is the top half of its f32), 0 past C
    const bool in_w = lane < r_l, in_u = lane >= r_l && lane < C, u16 = NS == 2 && in_u;
    const int t_stride = in_w ? r_l : r_e, t_off = in_w ? lane : in_u ? lane - r_l : 0;
    const int t_base = in_w ? 0 : uoff / 4;
    auto tval = [&](const unsigned char* sd, int kk) -> float {
        const int el = kk * t_stride + t_off;
        const uint32_t w = reinterpret_cast<const uint32_t*>(sd)[t_base + (u16 ? el >> 1 : el)];
        const uint32_t bits = u16 ? (el & 1 ? w & 0xffff0000u : w << 16) : w;
        return __uint_as_float(in_w || in_u ? bits : 0u);
    };

    // rounds of W chunks: warp w sums chunk W r + w (an FMA chain over its 32
    // k) while its next chunk's copies are in flight; thread (warp m, lane
    // p) adds the round's sums for row m0 + m, factor column p in chunk order
    float total = 0.f;
    if (warp < nchunks) stage(0, warp);
    hses::cp_async_commit();
    for (int c0 = 0, r = 0; c0 < nchunks; c0 += WARPS, ++r) {
        const int chunk = c0 + warp;
        if (chunk + WARPS < nchunks) stage((r + 1) & 1, chunk + WARPS);
        hses::cp_async_commit();
        hses::cp_async_wait<1>();
        __syncwarp();
        float part[FR];
#pragma unroll
        for (int m = 0; m < FR; ++m) part[m] = 0.f;
        if (chunk < nchunks) {
            const unsigned char* sd = stages + (r & 1) * sb;
#pragma unroll
            for (int kk = 0; kk < KC; kk += 4) {
                const float t0 = tval(sd, kk), t1 = tval(sd, kk + 1), t2 = tval(sd, kk + 2), t3 = tval(sd, kk + 3);
#pragma unroll
                for (int m = 0; m < FR; ++m) {
                    if (m >= mv) break;  // rows past M stay 0 (the T = 1 site has one)
                    const float4 xv = *reinterpret_cast<const float4*>(&xs[r & 1][warp][m][kk]);
                    part[m] = fmaf(xv.x, t0, part[m]);
                    part[m] = fmaf(xv.y, t1, part[m]);
                    part[m] = fmaf(xv.z, t2, part[m]);
                    part[m] = fmaf(xv.w, t3, part[m]);
                }
            }
        }
#pragma unroll
        for (int m = 0; m < FR; ++m) parts[warp][m][lane] = part[m];
        __syncthreads();
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
            if (c0 + w < nchunks) total += parts[w][warp][lane];  // ascending chunk order
        __syncthreads();  // also: every warp is done with the buffer the next round refills
    }
    hses::cp_async_wait<0>();
    e.thin[warp][lane] = total;
    chain_epilogue<FR>(e, bw, bw + r_l * cols, f, NS == 4, ln, m0, n0, cols, M, N, out + (int64_t)ln * M * N,
                       scale);
}

// ------------------------------------------------------------------- launch

// Route ids of ops/fused_lora.py:_plan
enum { MMA_ROWS32 = 0, F32_ROWS8 = 1 };

struct Call {
    const void* x;
    void* out;
    Factors f;
    bool nt_f32;
    int rows_per_lane, lanes, K, N, cols;
    float scale;
    cudaStream_t stream;
};

template <typename K>
int set_smem(K kernel, int bytes) {
    return (int)hses::raise_smem_limit(kernel, bytes);
}

dim3 grid_of(const Call& c, int rows) {
    return dim3((c.N + c.cols - 1) / c.cols, (c.rows_per_lane + rows - 1) / rows, c.lanes);
}

template <int NCOL, int NST, int AV>
int launch_mma(const Call& c) {
    auto kernel = lora_chain_mma_kernel<NCOL, NST, AV>;
    constexpr int smem = MmaRoute<NCOL, NST>::SMEM;
    const int e = set_smem(kernel, smem);
    if (e != (int)cudaSuccess) return e;
    const dim3 grid = grid_of(c, BM);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
    kernel<<<grid, THREADS, smem, c.stream>>>((const bf16*)c.x, (bf16*)c.out, c.f, c.nt_f32, c.rows_per_lane, c.K,
                                              c.N, c.cols, c.scale);
    return (int)cudaGetLastError();
}

// NCOL 24 holds r_l + r_e <= 12 (the main path's 8 + 4) with three stages a
// warp; 64 every rank pair, one stage a warp (its slots are larger)
template <int AV>
int launch_ranks(const Call& c) {
    if (2 * (c.f.r_l + c.f.r_e) <= 24) return launch_mma<24, 3, AV>(c);
    return launch_mma<64, 1, AV>(c);
}

template <typename NT>
int launch_f32(const Call& c) {
    auto kernel = lora_chain_f32_kernel<NT>;
    const int e = set_smem(kernel, F_SMEM);
    if (e != (int)cudaSuccess) return e;
    const int smem = F_STAGE_AT + WARPS * 2 * f_stage(c.f.r_l, c.f.r_e, sizeof(NT)) + (c.f.r_l + c.f.r_e) * c.cols * 4;
    const dim3 grid = grid_of(c, FR);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
    kernel<<<grid, THREADS, smem, c.stream>>>((const float*)c.x, (float*)c.out, c.f, c.rows_per_lane, c.K, c.N,
                                              c.cols, c.scale);
    return (int)cudaGetLastError();
}

// The plan (route, bk, warps, cols, a_vec): refused unless bk and warps are
// the route's own (bf16 64 and 8, f32 32 and 8), so the order the CPU tests
// check is the order the kernel sums in; cols a multiple of 8 up to
// MAX_COLS; a_vec (elements of bf16 x per copy: 8, 4 or 1) checked against
// K and x's alignment.
template <typename T, typename NT>
int launch(const void* x, void* out, const void* aw, const void* au, const void* av, const void* bw,
           const void* bu, const void* bv, const void* ca, const void* cb, int rows_per_lane, int lanes, int K,
           int N, int r_l, int r_e, long long au_ls, long long av_ls, long long bu_ls, long long bv_ls, float scale,
           int route, int bk, int warps, int cols, int a_vec, void* stream) {
    if (r_l < 1 || r_l > MAX_RL || r_e < 1 || r_e > MAX_RE) return (int)cudaErrorInvalidValue;
    if (warps != WARPS || cols < 8 || cols > MAX_COLS || cols % 8) return (int)cudaErrorInvalidValue;
    if (rows_per_lane <= 0 || lanes <= 0 || N <= 0) return (int)cudaSuccess;
    Call c{x, out,
           Factors{(const float*)aw, au, av, (const float*)bw, bu, bv, (const float*)ca, (const float*)cb,
                   au_ls, av_ls, bu_ls, bv_ls, r_l, r_e},
           sizeof(NT) == 4, rows_per_lane, lanes, K, N, cols, scale, (cudaStream_t)stream};
    if constexpr (sizeof(T) == 4) {
        if (route != F32_ROWS8 || bk != KC) return (int)cudaErrorInvalidValue;
        return launch_f32<NT>(c);
    } else {
        if (route != MMA_ROWS32 || bk != BK) return (int)cudaErrorInvalidValue;
        const uintptr_t xa = (uintptr_t)x;
        if (a_vec == 8 && K % 8 == 0 && xa % 16 == 0) return launch_ranks<8>(c);
        if (a_vec == 4 && K % 4 == 0 && xa % 8 == 0) return launch_ranks<4>(c);
        if (a_vec == 1) return launch_ranks<1>(c);
        return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// x [lanes * rows_per_lane, K] and out [.., N] in x's dtype; a.w [K, r_l] and
// b.w [r_l, N] f32; a.u [K, r_e], a.v [r_l, r_e], b.u [r_l, r_e], b.v [N, r_e]
// per lane (lane strides in elements) in the noise dtype; c_a, c_b [lanes]
// f32; then the plan (route, bk, warps, cols, a_vec). Entry names:
// hses_lora_chain_<x dtype>_<noise dtype>.
#define HSES_LORA_CHAIN_ENTRY(NAME, T, NT)                                                    \
    extern "C" int NAME(const void* x, void* out, const void* aw, const void* au,            \
                        const void* av, const void* bw, const void* bu, const void* bv,      \
                        const void* ca, const void* cb,                                      \
                        int rows_per_lane, int lanes, int K, int N, int r_l, int r_e,        \
                        long long au_ls, long long av_ls, long long bu_ls, long long bv_ls,  \
                        float scale, int route, int bk, int warps, int cols, int a_vec,      \
                        void* stream) {                                                      \
        return launch<T, NT>(x, out, aw, au, av, bw, bu, bv, ca, cb,                        \
                             rows_per_lane, lanes, K, N, r_l, r_e,                          \
                             au_ls, av_ls, bu_ls, bv_ls, scale, route, bk, warps, cols,     \
                             a_vec, stream);                                                 \
    }

HSES_LORA_CHAIN_ENTRY(hses_lora_chain_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
HSES_LORA_CHAIN_ENTRY(hses_lora_chain_bf16_f32, __nv_bfloat16, float)
HSES_LORA_CHAIN_ENTRY(hses_lora_chain_f32_bf16, float, __nv_bfloat16)
HSES_LORA_CHAIN_ENTRY(hses_lora_chain_f32_f32, float, float)

// Dynamic shared memory of a block, in bytes: the bf16 route for
// r_l + r_e <= 12 (wide = 0) or above (wide = 1); the f32 route's most
// (route F32_ROWS8; a call takes less at narrower groups and ranks).
extern "C" int hses_lora_chain_smem(int route, int wide) {
    if (route == MMA_ROWS32) return wide ? MmaRoute<64, 1>::SMEM : MmaRoute<24, 3>::SMEM;
    if (route == F32_ROWS8) return F_SMEM;
    return -1;
}
