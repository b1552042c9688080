// The tensor-core mainloop of an int8-weight matmul tile, shared by the
// dequant-matmul (int8_matmul.cu, K1) and the fused int8 + LoRA matmul
// (fused_qlora.cu, K3): acc[BM, BN] = x[m0 : m0 + BM, :] @ q8[:, n0 : n0 + BN]
// in f32, x bf16 and q8 s8, the per-column scale left to the caller's
// epilogue.
//
// The K loop streams 64-deep stages through a ring of STAGES tiles in shared
// memory filled by cp.async, with one barrier a stage: x tiles (16-byte
// copies, or 8-byte where K % 8 or x's alignment forbids them, or element
// loads) in rows padded by 16 bytes so ldmatrix reads them without bank
// conflicts; q8 tiles as raw bytes (16 a copy). A warp owns WTM x 32 outputs;
// its four n8 tiles take 4 adjacent columns (fragment column c of tile j is
// column 4c + j of the warp's 32), so one 32-bit shared read of a q8 row
// feeds all four: a byte permute pairs rows k and k+1 and an exact
// magic-number conversion gives the bf16 pairs of the B fragment. The mma is
// m16n8k16, bf16 in, f32 sums, in ascending k whatever the tile.
//
// `extra` rides along in the same loop (K3's thin LoRA columns; K1 passes
// NoExtra): load(m) starts the copies of its operand for stage m, in the
// commit group of x and q8 stage m - 1 (stage 1 as well with stage 0), so
// that stage kt + 1 has landed when stage kt's barrier passes; split(m)
// turns stage m into the form the products read, after stage m - 1's
// products (stage 0's before the loop); mma(kt, kk, a) multiplies at depth
// kk with stage kt's x tile a (as the warps' A fragments are read from it).
#pragma once

#include "int8_mma.cuh"

namespace hses {

constexpr int MMA_BK = 64;   // reduction depth of one pipeline stage
constexpr int MMA_PAD = 8;   // bf16 elements of padding per shared x row (16 bytes)

// One block's output tile, its warps' layout, and its ring: x tiles
// [BM][BK + 8] bf16 and raw q8 tiles [BK][BN + 16] s8, STAGES of each.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int MIN_BLOCKS_, int STAGES_ = 4>
struct MmaTile {
    static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, STAGES = STAGES_;
    static constexpr int THREADS = 32 * WARPS_M * WARPS_N, MIN_BLOCKS = MIN_BLOCKS_;
    static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // one warp's output tile
    static constexpr int MI = WTM / 16;                           // m16 tiles per warp
    static constexpr int AS = MMA_BK + MMA_PAD;                   // x row stride, elements
    static constexpr int RS = BN + 16;                            // q8 row stride, bytes
    static constexpr int A_BYTES = STAGES * BM * AS * 2;
    static constexpr int RING = A_BYTES + STAGES * MMA_BK * RS;   // shared memory of the ring, bytes
    static_assert(WTM % 16 == 0 && WTN == 32, "a warp owns 16k rows and 32 columns");
    static_assert(STAGES >= 2, "the ring needs two stages");
};

struct NoExtra {
    static constexpr bool active = false;
    __device__ __forceinline__ void load(int) {}
    __device__ __forceinline__ void split(int) {}
    __device__ __forceinline__ void mma(int, int, const __nv_bfloat16*) {}
};

// AV: elements of x per copy (8: 16-byte cp.async, 4: 8-byte cp.async,
// 1: plain loads). BV: q8 in 16-byte cp.async (else plain byte loads).
// Every thread of the block calls it; it returns once every copy it started
// has landed (the caller's epilogue may reuse the ring after a barrier).
template <class T, int AV, bool BV, class Extra>
__device__ __forceinline__ void int8_mma_mainloop(const __nv_bfloat16* __restrict__ x,
                                                  const int8_t* __restrict__ q, int M, int K, int N,
                                                  int m0, int n0, unsigned char* smem,
                                                  float (&acc)[T::MI][4][4], Extra& extra) {
    using bf16 = __nv_bfloat16;
    constexpr int BK = MMA_BK, STAGES = T::STAGES;
    bf16* As = reinterpret_cast<bf16*>(smem);                      // [STAGES][BM][AS]
    int8_t* Braw = reinterpret_cast<int8_t*>(smem + T::A_BYTES);  // [STAGES][BK][RS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
    const int ktiles = (K + BK - 1) / BK;

    auto load_stage = [&](int stage, int kt) {
        const int k0 = kt * BK;
        bf16* a = As + stage * T::BM * T::AS;
        if constexpr (AV > 1) {
            constexpr int CPR = BK / AV;
#pragma unroll
            for (int i = tid; i < T::BM * CPR; i += T::THREADS) {
                const int r = i / CPR, c = (i % CPR) * AV, gr = m0 + r, gk = k0 + c;
                const bool ok = gr < M && gk < K;
                const bf16* src = ok ? x + (int64_t)gr * K + gk : x;
                if constexpr (AV == 8) cp_async16(a + r * T::AS + c, src, ok ? 16 : 0);
                else cp_async8(a + r * T::AS + c, src, ok ? 8 : 0);
            }
        } else {
            for (int i = tid; i < T::BM * BK; i += T::THREADS) {
                const int r = i / BK, c = i % BK, gr = m0 + r, gk = k0 + c;
                a[r * T::AS + c] = (gr < M && gk < K) ? x[(int64_t)gr * K + gk] : __float2bfloat16(0.f);
            }
        }
        int8_t* b = Braw + stage * BK * T::RS;
        if constexpr (BV) {
            constexpr int CPR = T::BN / 16;
#pragma unroll
            for (int i = tid; i < BK * CPR; i += T::THREADS) {
                const int r = i / CPR, c = (i % CPR) * 16, gk = k0 + r, gn = n0 + c;
                const bool ok = gk < K && gn < N;
                cp_async16(b + r * T::RS + c, ok ? q + (int64_t)gk * N + gn : q, ok ? 16 : 0);
            }
        } else {
            for (int i = tid; i < BK * T::BN; i += T::THREADS) {
                const int r = i / T::BN, c = i % T::BN, gk = k0 + r, gn = n0 + c;
                b[r * T::RS + c] = (gk < K && gn < N) ? q[(int64_t)gk * N + gn] : (int8_t)0;
            }
        }
    };

#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < ktiles) load_stage(s, s);
        if (s == 0) extra.load(0);
        if (s + 1 < ktiles) extra.load(s + 1);
        cp_async_commit();
    }
    if constexpr (Extra::active) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        extra.split(0);
    }
    const int krow = 2 * (lane & 3), bcol = wn * 32 + 4 * (lane >> 2);
    for (int kt = 0; kt < ktiles; ++kt) {
        const int stage = kt % STAGES;
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // tile kt (and extra's stage kt + 1) landed for all; stage kt-1 is free to refill
        {
            const int nk = kt + STAGES - 1;
            if (nk < ktiles) load_stage(nk % STAGES, nk);
            if (nk + 1 < ktiles) extra.load(nk + 1);
            cp_async_commit();
        }
        const bf16* a = As + stage * T::BM * T::AS;
        const int8_t* b = Braw + stage * BK * T::RS + bcol;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t af[T::MI][4], bfr[4][2];
#pragma unroll
            for (int mi = 0; mi < T::MI; ++mi)
                ldmatrix_x4(af[mi], a + (wm * T::WTM + mi * 16 + (lane & 15)) * T::AS + kk + (lane >> 4) * 8);
            extra.mma(kt, kk, a);
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(b + (kk + krow) * T::RS);
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(b + (kk + krow + 1) * T::RS);
            const uint32_t w8 = *reinterpret_cast<const uint32_t*>(b + (kk + krow + 8) * T::RS);
            const uint32_t w9 = *reinterpret_cast<const uint32_t*>(b + (kk + krow + 9) * T::RS);
            // interleave rows k, k+1 byte by byte: tile j's pair is byte j of each
            s8x4_to_bf16x4(__byte_perm(w0, w1, 0x5140), bfr[0][0], bfr[1][0]);
            s8x4_to_bf16x4(__byte_perm(w0, w1, 0x7362), bfr[2][0], bfr[3][0]);
            s8x4_to_bf16x4(__byte_perm(w8, w9, 0x5140), bfr[0][1], bfr[1][1]);
            s8x4_to_bf16x4(__byte_perm(w8, w9, 0x7362), bfr[2][1], bfr[3][1]);
#pragma unroll
            for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
        }
        if (kt + 1 < ktiles) extra.split(kt + 1);
    }
    cp_async_wait<0>();
}

}  // namespace hses
