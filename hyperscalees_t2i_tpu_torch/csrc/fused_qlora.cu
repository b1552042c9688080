// Fused int8 base + perturbed-LoRA matmul for Hopper (K3):
//   out = x @ (q8 * scale) + lora_scale * (x @ a_k) @ b_k
// with a_k = a.w + c_a * a.u @ a.v^T and b_k = b.w + c_b * b.u @ b.v^T, for
// one or several ES member lanes (rows grouped lane-major, one (u, v, c) set
// per lane, w shared).
//
// Replaces the TPU kernel hyperscalees_t2i_tpu/ops/fused_qlora.py:_qlora_kernel
// (launched by _pallas_fused_qlora). That kernel keeps one [din, bn] s8 base
// tile and the whole token tile in VMEM, feeds the dequantized tile to the
// MXU and runs the chain at HIGHEST precision against the same token tile.
// Here the base term is K1's work and runs on K1's mainloop
// (int8_tile.cuh); the chain rides in the same K loop.
//
// What bounds it on the H100 (989 TFLOP/s bf16 tensor cores, 3.35 TB/s):
// - T = 1024 (the DiT's attention projections): operations, 2*T*din*dout
//   for the base (10.3 GFLOP at 2240 x 2240, ~10 us) against ~5 MB of s8.
// - T <= 32 (caption projection, cross-attention k, v): the bytes of the s8
//   weight (5 MB, ~1.5 us); the work is a few microseconds, so launch
//   latency and filling 132 SMs matter more than the inner loop.
// - T = 1 (time_embed/linear, f32): the s8 bytes (30 MB at 2240 x 13440).
//
// Design, bf16 x (every main-path site but T = 1).
// - Base: int8_tile.cuh's loop, as in K1: a ring of 64-deep cp.async stages
//   of x and raw q8, s8 -> bf16 in registers, mma.sync.m16n8k16 with f32
//   sums in ascending k. Tiles chosen in Python (ops/fused_qlora.py:_plan,
//   K1's rule over lanes x row tiles x column tiles): 128x128 at T = 1024
//   (8 warps; 3 stages, so that two blocks an SM keep room for the thin
//   stages), 16x64 at T <= 32; 64x64 between.
// - Thin products on the tensor cores: x @ a.w [rows, r_l] and
//   x @ a.u [rows, r_e] are 2 * (r_l + r_e) extra columns of the same
//   mma, 24 at r_l 8, r_e 4 (3 n8 tiles against 16 of a 128-wide tile).
//   a.w is theta in f32, so one rounding to bf16 would lose 8 bits: each
//   factor value v is split into hi = bf16(v) and lo = bf16(v - hi), the
//   pair in adjacent columns 2p, 2p + 1, so the thread that holds one sum
//   holds both and adds them in f32 (hi + lo keeps v to ~2^-16 relative; a
//   bf16 a.u has lo = 0 exactly). The factor rows travel raw (a.w rows f32,
//   a.u rows in the noise dtype) by cp.async in x's and q8's commit groups,
//   one stage ahead; after stage k's products the block splits stage
//   k + 1 into a k-major bf16 slot, four words a thread with 16-byte shared
//   loads and stores, and the products read it with ldmatrix.trans. The
//   (n8 tile, m16 tile) pairs of a warp-row are dealt round-robin to its
//   warps, all of a warp's on one m16 tile (one more ldmatrix of x a step):
//   at 128x128 each warp takes 3 next to its 16 base tiles.
// - Epilogue in f32 on the CUDA cores, after the last barrier, in the
//   ring's shared memory: the per-row thin sums, xa and xb
//   (lora_chain::chain_prologue), then per output the chain in chain_at's
//   order (chain_row8: ~12 FMAs an output), plus acc * scale[col], stored
//   in x's dtype 16 bytes at a time as K1 does.
// - Registers bound the 128x128 tile: its warps hold 64 base sums and 12
//   thin ones at <= 128 registers (two blocks an SM); ptxas spills a few
//   bytes there (phase_build logs it). The thin operand keeps no other
//   state in registers: addresses are constants or kernel parameters.
//
// f32 x (the T = 1 site and f32 checks): CUDA-core f32 FMAs. Rows of a lane
// <= 8: K1's layout, blocks of 32 columns whose 16 warps take alternate
// 32-deep K chunks, base and thin partial sums added in chunk order. More
// rows: 64x64 tiles, 32-deep chunks summed the same way.
//
// Batch and lane invariance, bitwise: a row's result never depends on the
// other rows or lanes of the call. The tile may follow the rows and lanes;
// the order of every sum over k may not (bf16: k16 mma steps in ascending k;
// f32: 32-deep FMA chunks added in ascending order, in both f32 layouts),
// and the chain's sums run in one order whatever the tile. K is never split
// across blocks.
//
// Build parts: ops/_build.py compiles this file HSES_PARTS times at once,
// each with -DHSES_PART=k, and links the objects into one library. The 36
// bf16 tensor-core kernels take most of the compiler's time, so the 6
// instances of each (tile, thin width) pair (three x copies x two q8
// copies) build in a part of their own behind a C function (1, 2: 128x128
// at NCOL 24, 64; 3, 4: 64x64; 5, 6: 16x64); part 0 holds the entry points,
// the dispatch and the f32 route. The kernels are the same code as in one
// compilation.
// HSES_PARTS 7

#include "int8_tile.cuh"
#include "lora_chain.cuh"

#ifndef HSES_PART
#error "fused_qlora.cu is built in parts: compile with -DHSES_PART=0..6 (ops/_build.py)"
#endif

// the bf16 kernels of one tile at one thin width, defined in parts 1-6 (the
// call is a Call*)
#define HSES_QLORA_TILE_DECL(NAME) extern "C" int NAME(const void* call, int a_vec, int b_vec);
HSES_QLORA_TILE_DECL(hses_fused_qlora_128x128_n24)
HSES_QLORA_TILE_DECL(hses_fused_qlora_128x128_n64)
HSES_QLORA_TILE_DECL(hses_fused_qlora_64x64_n24)
HSES_QLORA_TILE_DECL(hses_fused_qlora_64x64_n64)
HSES_QLORA_TILE_DECL(hses_fused_qlora_16x64_n24)
HSES_QLORA_TILE_DECL(hses_fused_qlora_16x64_n64)

namespace {

using namespace lora_chain;
using bf16 = __nv_bfloat16;
constexpr int BK = hses::MMA_BK;

// ---------------------------------------------------------------- bf16 route

using TileL = hses::MmaTile<128, 128, 2, 4, 2, 3>;
using TileM = hses::MmaTile<64, 64, 2, 2, 3>;
using TileS = hses::MmaTile<16, 64, 1, 2, 4>;

// Dynamic shared memory of the bf16 route: the ring, the thin operand's raw
// stages, its two split slots.
extern __shared__ __align__(16) unsigned char qlora_smem[];

// The thin operand of the mainloop. A raw stage holds, per k row of the
// stage, the row of a.w (r_l f32 words) then the lane's row of a.u (its
// bytes, from word r_l), as HALF words. split(m) turns raw stage m into a
// slot [64][SROW] bf16, k major, whose columns 2p and 2p + 1 hold hi and lo
// of factor column p < C = r_l + r_e and zeros up to NCOL (24, or 64 for
// ranks above r_l + r_e = 12): one 32-bit word per (k, p).
template <class T, int NCOL>
struct ThinColumns {
    static_assert(T::WARPS_N % T::MI == 0, "a warp's thin pairs share one m16 tile");
    static constexpr bool active = true;
    static constexpr int TILES = NCOL / 8;
    static constexpr int SLOTS = (TILES * T::MI + T::WARPS_N - 1) / T::WARPS_N;  // (n8, m16) pairs a warp
    static constexpr int HALF = NCOL / 2;                  // factor columns: one word each
    static constexpr int SROW = NCOL % 16 ? NCOL : NCOL + 8;  // slot row, bf16: ldmatrix rows on distinct banks
    static constexpr int RAW = BK * HALF * 4;              // bytes of a raw stage
    static constexpr int SLOT = BK * SROW * 2;             // bytes of a slot
    static constexpr int BYTES = T::STAGES * RAW + 2 * SLOT;

    const Factors& f;
    const int K;
    const bool au_f32;
    bool quads;  // r_l, r_e multiples of 4 and both factors 16-byte aligned: cp.async copies

    float acc[SLOTS][4];

    static __device__ __forceinline__ uint32_t* raw(int m) {
        return reinterpret_cast<uint32_t*>(qlora_smem + T::RING + (m % T::STAGES) * RAW);
    }
    static __device__ __forceinline__ bf16* slot(int m) {
        return reinterpret_cast<bf16*>(qlora_smem + T::RING + T::STAGES * RAW + (m & 1) * SLOT);
    }
    __device__ __forceinline__ const char* lane_au() const {
        return static_cast<const char*>(f.au) + (int64_t)blockIdx.z * f.au_ls * (au_f32 ? 4 : 2);
    }

    __device__ __forceinline__ ThinColumns(const Factors& f_, int K_, bool nt_f32)
        : f(f_), K(K_), au_f32(nt_f32) {
        quads = f.r_l % 4 == 0 && f.r_e % 4 == 0 && (((uintptr_t)f.aw | (uintptr_t)lane_au()) & 15) == 0;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[s][e] = 0.f;
    }

    // rows [64 m, 64 m + 64) of a.w and of the lane's a.u into raw stage m
    // (lora_chain.cuh, shared with K2)
    __device__ __forceinline__ void load(int m) {
        load_thin_raw<BK, HALF, T::THREADS>(raw(m), f, lane_au(), au_f32, quads, m * BK, K, threadIdx.x);
    }

    static __device__ __forceinline__ uint32_t hi_lo(uint32_t bits) { return thin_hi_lo(bits); }

    // raw stage m into slot m: word (kk, p) = bf16 hi | bf16 lo << 16, four
    // adjacent words (a quad q) a thread, thread tid + i * THREADS = 64 q + kk
    // (a warp splits one quad column: whole f32 words, or bf16 a.u halves)
    __device__ __forceinline__ void split(int m) {
        const int r_l = f.r_l, C = r_l + f.r_e;
        const uint32_t* rs = raw(m);
        uint32_t* s = reinterpret_cast<uint32_t*>(slot(m));
#pragma unroll
        for (int i = 0; i < (BK * HALF / 4 + T::THREADS - 1) / T::THREADS; ++i) {
            const int e = threadIdx.x + i * T::THREADS, q = e / BK, kk = e % BK, p0 = 4 * q;
            if (q >= HALF / 4) break;
            uint32_t w[4];
            if (p0 + 4 <= r_l || (au_f32 && p0 >= r_l)) {  // four whole f32 words
                const uint4 v = *reinterpret_cast<const uint4*>(rs + kk * HALF + p0);
                w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
            } else if (p0 >= r_l && quads) {                 // four bf16 a.u values
                const uint2 v = *reinterpret_cast<const uint2*>(rs + kk * HALF + r_l + (p0 - r_l) / 2);
                w[0] = v.x << 16, w[1] = v.x & 0xffff0000u, w[2] = v.y << 16, w[3] = v.y & 0xffff0000u;
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int p = p0 + j;
                    const bool whole = p < r_l || au_f32;
                    const uint32_t word = rs[kk * HALF + (whole ? p : r_l + ((p - r_l) >> 1))];
                    w[j] = whole ? word : ((p - r_l) & 1 ? word & 0xffff0000u : word << 16);
                }
            }
            uint4 o;
            o.x = p0 < C ? hi_lo(w[0]) : 0u;
            o.y = p0 + 1 < C ? hi_lo(w[1]) : 0u;
            o.z = p0 + 2 < C ? hi_lo(w[2]) : 0u;
            o.w = p0 + 3 < C ? hi_lo(w[3]) : 0u;
            *reinterpret_cast<uint4*>(s + kk * (SROW / 2) + p0) = o;
        }
    }

    // pair q = slot * WARPS_N + wn of the warp-row: n8 tile q / MI, m16 tile
    // q % MI = wn % MI (WARPS_N % MI == 0), the same for every slot of a
    // warp: its A fragment is read once a step, from the stage's x tile a
    __device__ __forceinline__ void mma(int kt, int kk, const bf16* a) {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
        const int ntiles = (2 * (f.r_l + f.r_e) + 7) / 8;
        uint32_t at[4];
        hses::ldmatrix_x4(at, a + (wm * T::WTM + (wn % T::MI) * 16 + (lane & 15)) * T::AS + kk + (lane >> 4) * 8);
        const bf16* s = slot(kt) + (kk + (lane & 15)) * SROW;  // lanes 0-15: rows kk .. kk + 15
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) {
            const int j = (sl * T::WARPS_N + wn) / T::MI;
            if (j < ntiles) {
                uint32_t b0, b1;
                hses::ldmatrix_x2_trans(b0, b1, s + 8 * j);
                hses::mma_bf16_16816(acc[sl], at, b0, b1);
            }
        }
    }

    // the per-row sums of factor column p: hi + lo, into sums[row][p]
    __device__ __forceinline__ void write_sums(float (*sums)[MAX_THIN + 1], int wm, int wn, int lane) const {
        const int ntiles = (2 * (f.r_l + f.r_e) + 7) / 8;
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) {
            const int q = sl * T::WARPS_N + wn, j = q / T::MI, mi = q % T::MI;
            if (j < ntiles) {
                const int r = wm * T::WTM + mi * 16 + (lane >> 2), p = 4 * j + (lane & 3);
                sums[r][p] = acc[sl][0] + acc[sl][1];
                sums[r + 8][p] = acc[sl][2] + acc[sl][3];
            }
        }
    }
};

template <class T, int NCOL>
constexpr int mma_smem() { return T::RING + ThinColumns<T, NCOL>::BYTES; }

template <class T, int NCOL, int AV, bool BV>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
qlora_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
                 bf16* __restrict__ out, Factors f, bool nt_f32, int rows_per_lane, int K, int N,
                 float lora_scale) {
    using Epi = EpilogueSmem<T::BM, T::BN>;
    static_assert(sizeof(Epi) + T::BM * (MAX_THIN + 1) * 4 <= T::RING, "the epilogue must fit the ring");
    unsigned char* smem = qlora_smem;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
    const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN, ln = blockIdx.z;
    const bf16* xl = x + (int64_t)ln * rows_per_lane * K;
    bf16* ol = out + (int64_t)ln * rows_per_lane * N;

    ThinColumns<T, NCOL> thin(f, K, nt_f32);
    float acc[T::MI][4][4];
    hses::int8_mma_mainloop<T, AV, BV>(xl, q, rows_per_lane, K, N, m0, n0, smem, acc, thin);
    __syncthreads();  // every warp is done with the ring: the epilogue reuses it

    Epi& e = *reinterpret_cast<Epi*>(smem);
    float(*sums)[MAX_THIN + 1] = reinterpret_cast<float(*)[MAX_THIN + 1]>(smem + sizeof(Epi));
    thin.write_sums(sums, wm, wn, lane);
    if (nt_f32) chain_prologue<float>(e, sums, f, ln, n0, N, tid, T::THREADS);
    else chain_prologue<bf16>(e, sums, f, ln, n0, N, tid, T::THREADS);

    // a thread holds 8 adjacent columns, cl + {0..7}, of rows lane/4 and
    // lane/4 + 8 of each m16 tile: column cl + j is n8 tile j's c0 (c2),
    // column cl + 4 + j its c1 (c3)
    const int cl = wn * 32 + 8 * (lane & 3), c = n0 + cl;
    const float cb = f.cb[ln];
    float sc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = c + i < N ? scale[c + i] : 0.f;
    const bool vec = (N & 7) == 0 && c + 8 <= N;
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int rl = wm * T::WTM + mi * 16 + (lane >> 2) + 8 * h, rr = m0 + rl;
            if (rr >= rows_per_lane || c >= N) continue;
            float d[8], v[8];
            chain_row8(e, f.r_l, f.r_e, cb, rl, cl, d);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                v[j] = fmaf(lora_scale, d[j], acc[mi][j][2 * h] * sc[j]);
                v[4 + j] = fmaf(lora_scale, d[4 + j], acc[mi][j][2 * h + 1] * sc[4 + j]);
            }
            bf16* o = ol + (int64_t)rr * N + c;
            if (vec) {
                uint4 pk;
                __nv_bfloat162 t0 = __floats2bfloat162_rn(v[0], v[1]), t1 = __floats2bfloat162_rn(v[2], v[3]);
                __nv_bfloat162 t2 = __floats2bfloat162_rn(v[4], v[5]), t3 = __floats2bfloat162_rn(v[6], v[7]);
                pk.x = *reinterpret_cast<uint32_t*>(&t0);
                pk.y = *reinterpret_cast<uint32_t*>(&t1);
                pk.z = *reinterpret_cast<uint32_t*>(&t2);
                pk.w = *reinterpret_cast<uint32_t*>(&t3);
                *reinterpret_cast<uint4*>(o) = pk;
            } else {
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    if (c + i < N) o[i] = __float2bfloat16(v[i]);
            }
        }
}

struct Call {
    const void *x, *q, *scale;
    void* out;
    Factors f;
    bool nt_f32;
    int rows_per_lane, lanes, K, N;
    float lora_scale;
    cudaStream_t stream;
};

template <class T, int NCOL, int AV, bool BV>
int launch_mma(const Call& c) {
    auto kernel = qlora_mma_kernel<T, NCOL, AV, BV>;
    constexpr int smem = mma_smem<T, NCOL>();
    const cudaError_t e = hses::raise_smem_limit(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((c.rows_per_lane + T::BM - 1) / T::BM, (c.N + T::BN - 1) / T::BN, c.lanes);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
    kernel<<<grid, T::THREADS, smem, c.stream>>>((const bf16*)c.x, (const int8_t*)c.q, (const float*)c.scale,
                                                  (bf16*)c.out, c.f, c.nt_f32, c.rows_per_lane, c.K, c.N,
                                                  c.lora_scale);
    return (int)cudaGetLastError();
}

template <class T, int NCOL>
int launch_widths(const Call& c, int a_vec, int b_vec) {
    if (b_vec == 16) {
        if (a_vec == 8) return launch_mma<T, NCOL, 8, true>(c);
        if (a_vec == 4) return launch_mma<T, NCOL, 4, true>(c);
        return launch_mma<T, NCOL, 1, true>(c);
    }
    if (a_vec == 8) return launch_mma<T, NCOL, 8, false>(c);
    if (a_vec == 4) return launch_mma<T, NCOL, 4, false>(c);
    return launch_mma<T, NCOL, 1, false>(c);
}


// ----------------------------------------------------------------- f32 route

constexpr int KC = 32;  // depth of one f32 K chunk: FMAs inside, adds across

// more than 8 rows a lane: 64x64 tiles, 16x16 threads each owning 4x4
// outputs and the thin columns tx (and tx + 16) of its 4 rows
constexpr int FBM = 64, FBN = 64, FTHREADS = 256;

struct F32Loop {
    float xs[KC][FBM + 1];     // x chunk, transposed, padded against bank conflicts
    float ws[KC][FBN];         // s8 base chunk widened to f32
    float ts[KC][MAX_THIN];    // a.w | a.u rows of this chunk
};
union F32Smem {
    F32Loop k;
    EpilogueSmem<FBM, FBN> e;
};

template <typename NT>
__global__ void __launch_bounds__(FTHREADS, 3)
qlora_f32_tile_kernel(const float* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
                      float* __restrict__ out, Factors f, int rows_per_lane, int K, int N, float lora_scale) {
    __shared__ F32Smem sm;
    __shared__ float thin[FBM][MAX_THIN + 1];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int ln = blockIdx.z, row0 = blockIdx.y * FBM, col0 = blockIdx.x * FBN;
    const float* xl = x + (int64_t)ln * rows_per_lane * K;
    float* ol = out + (int64_t)ln * rows_per_lane * N;
    const bool wide = f.r_l + f.r_e > 16;

    float acc[4][4], tacc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        tacc[i][0] = tacc[i][1] = 0.f;
    }
    for (int k0 = 0; k0 < K; k0 += KC) {
#pragma unroll
        for (int it = 0; it < (FBM * KC) / FTHREADS; ++it) {
            const int i = tid + it * FTHREADS, r = i / KC, c = i % KC, gr = row0 + r, gc = k0 + c;
            sm.k.xs[c][r] = (gr < rows_per_lane && gc < K) ? xl[(int64_t)gr * K + gc] : 0.f;
        }
#pragma unroll
        for (int it = 0; it < (KC * FBN) / FTHREADS; ++it) {
            const int i = tid + it * FTHREADS, r = i / FBN, c = i % FBN, gr = k0 + r, gc = col0 + c;
            sm.k.ws[r][c] = (gr < K && gc < N) ? (float)q[(int64_t)gr * N + gc] : 0.f;
        }
        load_thin_tile<NT, KC>(sm.k.ts, f, ln, k0, K, tid, FTHREADS);
        __syncthreads();
        float part[4][4], tpart[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
            tpart[i][0] = tpart[i][1] = 0.f;
        }
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = sm.k.xs[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = sm.k.ws[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
            const float t0 = sm.k.ts[kk][tx];
#pragma unroll
            for (int i = 0; i < 4; ++i) tpart[i][0] = fmaf(a[i], t0, tpart[i][0]);
            if (wide) {
                const float t1 = sm.k.ts[kk][tx + 16];
#pragma unroll
                for (int i = 0; i < 4; ++i) tpart[i][1] = fmaf(a[i], t1, tpart[i][1]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
            tacc[i][0] += tpart[i][0];
            tacc[i][1] += tpart[i][1];
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
    chain_prologue<NT>(sm.e, thin, f, ln, col0, N, tid, FTHREADS);
    const float cb = f.cb[ln];
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
            ol[(int64_t)r * N + c] = fmaf(lora_scale, d, acc[i][j] * s);
        }
    }
}

// at most 8 rows a lane: 32 columns a block (one a lane of the warp); warp w
// sums K chunks w, w + 16, ... of the base and of the thin columns (lane p
// < r_l + r_e) for all 8 rows, then the chunk sums are added in ascending
// chunk order by the thread that owns (row = warp, column = lane)
constexpr int FR = 8, FWARPS = 16;

union RowsSmem {
    float xs[FWARPS][FR][KC];  // each warp's x chunk
    EpilogueSmem<FR, 32> e;
};

template <typename NT>
__global__ void __launch_bounds__(32 * FWARPS)
qlora_f32_rows_kernel(const float* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
                      float* __restrict__ out, Factors f, int rows_per_lane, int K, int N, float lora_scale) {
    __shared__ __align__(16) RowsSmem sm;
    __shared__ float parts[FWARPS][FR][32];
    __shared__ float thin[FR][MAX_THIN + 1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ln = blockIdx.y, col0 = blockIdx.x * 32, col = col0 + lane;
    const int M = rows_per_lane, r_l = f.r_l, r_e = f.r_e, C = r_l + r_e;
    const float* xl = x + (int64_t)ln * M * K;
    float* ol = out + (int64_t)ln * M * N;
    const NT* au = (const NT*)f.au + (int64_t)ln * f.au_ls;
    const int nchunks = (K + KC - 1) / KC;
    float total = 0.f, ttotal = 0.f;
    for (int c0 = 0; c0 < nchunks; c0 += FWARPS) {
        const int chunk = c0 + warp;
        float part[FR], tpart[FR];
#pragma unroll
        for (int m = 0; m < FR; ++m) part[m] = tpart[m] = 0.f;
        if (chunk < nchunks) {
            const int k0 = chunk * KC;
            // the thin factor's values stay raw bits until the FMAs (a bf16 a.u
            // value is its f32 bits' top half), so no load is waited for here
            int8_t w8[KC];
            uint32_t tw[KC];
#pragma unroll
            for (int kk = 0; kk < KC; ++kk) {
                const int k = k0 + kk;
                w8[kk] = (k < K && col < N) ? q[(int64_t)k * N + col] : (int8_t)0;
                uint32_t t = 0;
                if (k < K && lane < C) {
                    if (lane < r_l) t = __float_as_uint(__ldg(f.aw + (int64_t)k * r_l + lane));
                    else if constexpr (sizeof(NT) == 4) t = __ldg((const unsigned int*)au + (int64_t)k * r_e + (lane - r_l));
                    else t = __ldg((const unsigned short*)au + (int64_t)k * r_e + (lane - r_l));
                }
                tw[kk] = t;
            }
            const int tshift = sizeof(NT) == 2 && lane >= r_l ? 16 : 0;
#pragma unroll
            for (int m = 0; m < FR; ++m)
                sm.xs[warp][m][lane] = (m < M && k0 + lane < K) ? xl[(int64_t)m * K + k0 + lane] : 0.f;
            __syncwarp();
#pragma unroll
            for (int kk = 0; kk < KC; kk += 4) {
#pragma unroll
                for (int m = 0; m < FR; ++m) {
                    const float4 xv = *reinterpret_cast<const float4*>(&sm.xs[warp][m][kk]);
                    part[m] = fmaf(xv.x, (float)w8[kk], part[m]);
                    part[m] = fmaf(xv.y, (float)w8[kk + 1], part[m]);
                    part[m] = fmaf(xv.z, (float)w8[kk + 2], part[m]);
                    part[m] = fmaf(xv.w, (float)w8[kk + 3], part[m]);
                    tpart[m] = fmaf(xv.x, __uint_as_float(tw[kk] << tshift), tpart[m]);
                    tpart[m] = fmaf(xv.y, __uint_as_float(tw[kk + 1] << tshift), tpart[m]);
                    tpart[m] = fmaf(xv.z, __uint_as_float(tw[kk + 2] << tshift), tpart[m]);
                    tpart[m] = fmaf(xv.w, __uint_as_float(tw[kk + 3] << tshift), tpart[m]);
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
#pragma unroll
        for (int m = 0; m < FR; ++m) parts[warp][m][lane] = tpart[m];
        __syncthreads();
        if (warp < FR) {
#pragma unroll
            for (int w = 0; w < FWARPS; ++w)
                if (c0 + w < nchunks) ttotal += parts[w][warp][lane];
        }
        __syncthreads();
    }
    if (warp < FR) thin[warp][lane] = ttotal;
    // the loop ended on a barrier: the epilogue may reuse the x chunks
    chain_prologue<NT>(sm.e, thin, f, ln, col0, N, threadIdx.x, 32 * FWARPS);
    if (warp < M && col < N) {
        const float d = chain_at(sm.e, r_l, r_e, f.cb[ln], warp, lane);
        ol[(int64_t)warp * N + col] = fmaf(lora_scale, d, total * scale[col]);
    }
}

// Tile ids of ops/fused_qlora.py:_plan (ops/quant_mm.py's ids). bk: the
// plan's depth of one stage of the k sum, refused unless it is the route's
// own (64 bf16, 32 f32), so the plan that the CPU tests check is the order
// the kernel sums in. a_vec / b_vec: elements of x / bytes of q8 per copy,
// checked here against K, N and the pointers' alignment.
enum { F32_ROWS8 = 0, F32_TILE = 1, MMA_128x128 = 2, MMA_64x64 = 3, MMA_16x64 = 4 };

int launch_bf16(const Call& c, int tile, int bk, int a_vec, int b_vec) {
    if (bk != BK) return (int)cudaErrorInvalidValue;
    const uintptr_t xa = (uintptr_t)c.x, qa = (uintptr_t)c.q;
    const bool a_ok = a_vec == 1 || (a_vec == 8 && c.K % 8 == 0 && xa % 16 == 0) ||
                      (a_vec == 4 && c.K % 4 == 0 && xa % 8 == 0);
    const bool b_ok = b_vec == 1 || (b_vec == 16 && c.N % 16 == 0 && qa % 16 == 0);
    if (!a_ok || !b_ok) return (int)cudaErrorInvalidValue;
    // NCOL 24 holds r_l + r_e <= 12 (the main path's 8 + 4); 64 every rank pair
    const bool wide = 2 * (c.f.r_l + c.f.r_e) > 24;
    switch (tile) {
        case MMA_128x128: return (wide ? hses_fused_qlora_128x128_n64 : hses_fused_qlora_128x128_n24)(&c, a_vec, b_vec);
        case MMA_64x64: return (wide ? hses_fused_qlora_64x64_n64 : hses_fused_qlora_64x64_n24)(&c, a_vec, b_vec);
        case MMA_16x64: return (wide ? hses_fused_qlora_16x64_n64 : hses_fused_qlora_16x64_n24)(&c, a_vec, b_vec);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename NT>
int launch_f32(const Call& c, int tile, int bk) {
    if (bk != KC) return (int)cudaErrorInvalidValue;
    if (tile == F32_ROWS8) {
        if (c.rows_per_lane > FR) return (int)cudaErrorInvalidValue;
        const dim3 grid((c.N + 31) / 32, c.lanes);
        if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
        qlora_f32_rows_kernel<NT><<<grid, 32 * FWARPS, 0, c.stream>>>(
            (const float*)c.x, (const int8_t*)c.q, (const float*)c.scale, (float*)c.out, c.f,
            c.rows_per_lane, c.K, c.N, c.lora_scale);
    } else if (tile == F32_TILE) {
        const dim3 grid((c.N + FBN - 1) / FBN, (c.rows_per_lane + FBM - 1) / FBM, c.lanes);
        if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
        qlora_f32_tile_kernel<NT><<<grid, FTHREADS, 0, c.stream>>>(
            (const float*)c.x, (const int8_t*)c.q, (const float*)c.scale, (float*)c.out, c.f,
            c.rows_per_lane, c.K, c.N, c.lora_scale);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <typename T, typename NT>
int launch(const void* x, const void* q, const void* scale, void* out, const void* aw, const void* au,
           const void* av, const void* bw, const void* bu, const void* bv, const void* ca, const void* cb,
           int rows_per_lane, int lanes, int K, int N, int r_l, int r_e, long long au_ls, long long av_ls,
           long long bu_ls, long long bv_ls, float lora_scale, int tile, int bk, int a_vec, int b_vec,
           void* stream) {
    if (r_l < 1 || r_l > MAX_RL || r_e < 1 || r_e > MAX_RE) return (int)cudaErrorInvalidValue;
    if (rows_per_lane <= 0 || lanes <= 0 || N <= 0) return (int)cudaSuccess;
    Call c{x, q, scale, out,
           Factors{(const float*)aw, au, av, (const float*)bw, bu, bv, (const float*)ca, (const float*)cb,
                   au_ls, av_ls, bu_ls, bv_ls, r_l, r_e},
           sizeof(NT) == 4, rows_per_lane, lanes, K, N, lora_scale, (cudaStream_t)stream};
    if constexpr (sizeof(T) == 2) return launch_bf16(c, tile, bk, a_vec, b_vec);
    else return launch_f32<NT>(c, tile, bk);
}

}  // namespace

#if HSES_PART == 0

// x [lanes * rows_per_lane, K] and out [.., N] in x's dtype; q [K, N] s8;
// scale [N] f32; a.w [K, r_l] and b.w [r_l, N] f32; a.u [K, r_e],
// a.v [r_l, r_e], b.u [r_l, r_e], b.v [N, r_e] per lane (lane strides in
// elements) in the noise dtype; c_a, c_b [lanes] f32; then the plan (tile,
// bk, a_vec, b_vec; a_vec and b_vec unused by f32). Entry names:
// hses_fused_qlora_<x dtype>_<noise dtype>.
#define HSES_FUSED_QLORA_ENTRY(NAME, T, NT)                                                   \
    extern "C" int NAME(const void* x, const void* q, const void* scale, void* out,          \
                        const void* aw, const void* au, const void* av, const void* bw,      \
                        const void* bu, const void* bv, const void* ca, const void* cb,      \
                        int rows_per_lane, int lanes, int K, int N, int r_l, int r_e,        \
                        long long au_ls, long long av_ls, long long bu_ls, long long bv_ls,  \
                        float lora_scale, int tile, int bk, int a_vec, int b_vec,            \
                        void* stream) {                                                      \
        return launch<T, NT>(x, q, scale, out, aw, au, av, bw, bu, bv, ca, cb,              \
                             rows_per_lane, lanes, K, N, r_l, r_e, au_ls, av_ls, bu_ls,     \
                             bv_ls, lora_scale, tile, bk, a_vec, b_vec, stream);            \
    }

HSES_FUSED_QLORA_ENTRY(hses_fused_qlora_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
HSES_FUSED_QLORA_ENTRY(hses_fused_qlora_bf16_f32, __nv_bfloat16, float)
HSES_FUSED_QLORA_ENTRY(hses_fused_qlora_f32_bf16, float, __nv_bfloat16)
HSES_FUSED_QLORA_ENTRY(hses_fused_qlora_f32_f32, float, float)

// Dynamic shared memory of a bf16 tile's block, in bytes, for the thin
// slots of r_l + r_e <= 12 (wide = 0) or above (wide = 1); -1 for any other
// tile id (the f32 routes' shared memory is static and in ptxas's report).
extern "C" int hses_fused_qlora_smem(int tile, int wide) {
    switch (tile) {
        case MMA_128x128: return wide ? mma_smem<TileL, 64>() : mma_smem<TileL, 24>();
        case MMA_64x64: return wide ? mma_smem<TileM, 64>() : mma_smem<TileM, 24>();
        case MMA_16x64: return wide ? mma_smem<TileS, 64>() : mma_smem<TileS, 24>();
        default: return -1;
    }
}

#else
#define HSES_QLORA_TILE(NAME, T, NCOL)                                      \
    extern "C" int NAME(const void* call, int a_vec, int b_vec) {          \
        return launch_widths<T, NCOL>(*static_cast<const Call*>(call), a_vec, b_vec); \
    }
#if HSES_PART == 1
HSES_QLORA_TILE(hses_fused_qlora_128x128_n24, TileL, 24)
#elif HSES_PART == 2
HSES_QLORA_TILE(hses_fused_qlora_128x128_n64, TileL, 64)
#elif HSES_PART == 3
HSES_QLORA_TILE(hses_fused_qlora_64x64_n24, TileM, 24)
#elif HSES_PART == 4
HSES_QLORA_TILE(hses_fused_qlora_64x64_n64, TileM, 64)
#elif HSES_PART == 5
HSES_QLORA_TILE(hses_fused_qlora_16x64_n24, TileS, 24)
#elif HSES_PART == 6
HSES_QLORA_TILE(hses_fused_qlora_16x64_n64, TileS, 64)
#endif
#endif
