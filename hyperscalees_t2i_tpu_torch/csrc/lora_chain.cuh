// The perturbed-LoRA chain shared by csrc/lora_chain.cu (K2) and
// csrc/fused_qlora.cu (K3).
//
// For one member lane, with a_k = a.w + c_a * a.u @ a.v^T and
// b_k = b.w + c_b * b.u @ b.v^T (EGGROLL's factored perturbation of both LoRA
// factors), the chain computes (x @ a_k) @ b_k without forming a_k or b_k:
//
//   xw = x @ a.w            [rows, r_l]   } summed over din in the kernels'
//   xu = x @ a.u            [rows, r_e]   } K loops, from the x tile in smem
//   xa = xw + c_a * xu @ a.v^T            [rows, r_l]
//   xb = xa @ b.u                          [rows, r_e]
//   d[row, col] = xa[row] . b.w[:, col] + c_b * xb[row] . b.v[col]
//
// Everything is f32: the factors w (theta, f32) and u, v (the noise store,
// bf16 or f32) are widened as they are loaded, or, on the tensor cores, each
// value is split into bf16 hi + lo (thin_hi_lo). Rows of x are grouped
// lane-major: lane l owns rows [l * rows_per_lane, (l + 1) * rows_per_lane)
// and its own (u, v, c); w is shared by every lane. u and v of lane l start
// at l times their lane stride (in elements); inside a lane they are
// row-major [din or dout or r_l, r_e].
//
// The thin operand on the tensor cores (K2's and K3's bf16 routes): x @ a.w
// and x @ a.u are 2 * (r_l + r_e) columns of an mma.sync.m16n8k16 whose B
// operand is a k-major bf16 slot. A raw stage holds, per k row, the row of
// a.w (r_l f32 words) then the lane's row of a.u (its bytes, from word r_l),
// HALF words a row (load_thin_raw); split_thin_raw turns it into the slot,
// [BK][SROW] bf16, whose columns 2p and 2p + 1 hold hi and lo of factor
// column p < C = r_l + r_e and zeros up to 2 * HALF: one 32-bit word per
// (k, p), so the thread that holds one column's sum holds both and adds
// them in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace lora_chain {

constexpr int MAX_RL = 16;    // LoRA rank r_l
constexpr int MAX_RE = 16;    // EGGROLL noise rank r_e
constexpr int MAX_THIN = MAX_RL + MAX_RE;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

struct Factors {
    const float* aw;   // [din, r_l]
    const void* au;    // lane-strided [din, r_e]
    const void* av;    // lane-strided [r_l, r_e]
    const float* bw;   // [r_l, dout]
    const void* bu;    // lane-strided [r_l, r_e]
    const void* bv;    // lane-strided [dout, r_e]
    const float* ca;   // [lanes]
    const float* cb;   // [lanes]
    long long au_ls, av_ls, bu_ls, bv_ls;
    int r_l, r_e;
};

// Shared memory of the epilogue: xa and xb for the block's rows, and the
// block's column slices of b.w and b.v, plus the lane's a.v and b.u.
template <int ROWS, int COLS>
struct EpilogueSmem {
    float xa[ROWS][MAX_RL + 1];
    float xb[ROWS][MAX_RE + 1];
    float bw[MAX_RL][COLS];
    float bv[COLS][MAX_RE + 1];
    float av[MAX_RL][MAX_RE];
    float bu[MAX_RL][MAX_RE];
};

// One K-loop stage of the thin operands: rows [k0, k0 + BK) of a.w | a.u,
// laid out ts[kk][0 .. r_l) = a.w, ts[kk][r_l .. r_l + r_e) = a.u (lane's),
// zeros up to MAX_THIN.
template <typename NT, int BK>
__device__ __forceinline__ void load_thin_tile(float (*ts)[MAX_THIN], const Factors& f, int lane,
                                               int k0, int K, int tid, int nthreads) {
    const int R = f.r_l + f.r_e;
    const NT* au = (const NT*)f.au + (long long)lane * f.au_ls;
    for (int i = tid; i < BK * MAX_THIN; i += nthreads) {
        const int kk = i / MAX_THIN, j = i % MAX_THIN, k = k0 + kk;
        float v = 0.f;
        if (k < K && j < R)
            v = j < f.r_l ? f.aw[(long long)k * f.r_l + j] : to_f32(au[(long long)k * f.r_e + (j - f.r_l)]);
        ts[kk][j] = v;
    }
}

// The per-row sums of a block, the chain's f32 intermediates and the lane's
// small factors (K2's epilogue; K3 keeps them in EpilogueSmem).
template <int ROWS>
struct ChainRows {
    float thin[ROWS][MAX_THIN + 1];  // xw | xu
    float xa[ROWS][MAX_RL + 1];
    float xb[ROWS][MAX_RE + 1];
    float av[MAX_RL][MAX_RE];
    float bu[MAX_RL][MAX_RE];
};

// xa = xw + c_a * xu @ a.v^T and xb = xa @ b.u for ROWS rows from
// thin[row][0 .. r_l + r_e) = (xw | xu), each an FMA chain in ascending
// order. Starts after the caller's barrier over thin, av and bu; ends with
// a barrier. Every thread of the block calls it.
template <int ROWS, int THIN_LD>
__device__ __forceinline__ void chain_xa_xb(float (*xa)[MAX_RL + 1], float (*xb)[MAX_RE + 1],
                                            float (*av)[MAX_RE], float (*bu)[MAX_RE],
                                            float (*thin)[THIN_LD], int rl, int re, float ca,
                                            int tid, int nthreads) {
    for (int i = tid; i < ROWS * rl; i += nthreads) {
        const int r = i / rl, l = i % rl;
        float s = 0.f;
        for (int j = 0; j < re; ++j) s = fmaf(thin[r][rl + j], av[l][j], s);
        xa[r][l] = fmaf(ca, s, thin[r][l]);
    }
    __syncthreads();
    for (int i = tid; i < ROWS * re; i += nthreads) {
        const int r = i / re, j = i % re;
        float s = 0.f;
        for (int l = 0; l < rl; ++l) s = fmaf(xa[r][l], bu[l][j], s);
        xb[r][j] = s;
    }
    __syncthreads();
}

// From thin[row][0 .. r_l + r_e) = (xw | xu) of the block's rows, form xa and
// xb in smem and load the block's slices of b.w and b.v for columns
// [col0, col0 + COLS). Ends with a barrier; every thread of the block calls it.
template <typename NT, int ROWS, int COLS, int THIN_LD>
__device__ __forceinline__ void chain_prologue(EpilogueSmem<ROWS, COLS>& e, float (*thin)[THIN_LD],
                                               const Factors& f, int lane, int col0, int N,
                                               int tid, int nthreads) {
    const int rl = f.r_l, re = f.r_e;
    const NT* av = (const NT*)f.av + (long long)lane * f.av_ls;
    const NT* bu = (const NT*)f.bu + (long long)lane * f.bu_ls;
    const NT* bv = (const NT*)f.bv + (long long)lane * f.bv_ls;
    for (int i = tid; i < rl * re; i += nthreads) {
        e.av[i / re][i % re] = to_f32(av[i]);
        e.bu[i / re][i % re] = to_f32(bu[i]);
    }
    for (int i = tid; i < rl * COLS; i += nthreads) {
        const int l = i / COLS, c = i % COLS, gc = col0 + c;
        e.bw[l][c] = gc < N ? f.bw[(long long)l * N + gc] : 0.f;
    }
    for (int i = tid; i < COLS * re; i += nthreads) {
        const int c = i / re, j = i % re, gc = col0 + c;
        e.bv[c][j] = gc < N ? to_f32(bv[(long long)gc * re + j]) : 0.f;
    }
    __syncthreads();
    chain_xa_xb<ROWS>(e.xa, e.xb, e.av, e.bu, thin, rl, re, f.ca[lane], tid, nthreads);
}

// d[row, col] of the chain, row and col local to the block.
template <int ROWS, int COLS>
__device__ __forceinline__ float chain_at(const EpilogueSmem<ROWS, COLS>& e, int r_l, int r_e,
                                          float cb, int row, int col) {
    float s = 0.f, t = 0.f;
    for (int l = 0; l < r_l; ++l) s = fmaf(e.xa[row][l], e.bw[l][col], s);
    for (int j = 0; j < r_e; ++j) t = fmaf(e.xb[row][j], e.bv[col][j], t);
    return fmaf(cb, t, s);
}

// d of the 8 adjacent columns [col, col + 8) of one row, each summed in
// chain_at's order (so bitwise chain_at's value): b.w's row slices are read
// 16 bytes at a time. col % 4 == 0; ROWS even keeps e.bw 16-byte aligned.
template <int ROWS, int COLS>
__device__ __forceinline__ void chain_row8(const EpilogueSmem<ROWS, COLS>& e, int r_l, int r_e,
                                           float cb, int row, int col, float (&d)[8]) {
    static_assert(ROWS % 2 == 0 && COLS % 4 == 0, "e.bw rows must be 16-byte aligned");
    float s[8], t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = t[i] = 0.f;
    for (int l = 0; l < r_l; ++l) {
        const float a = e.xa[row][l];
        const float4 b0 = *reinterpret_cast<const float4*>(&e.bw[l][col]);
        const float4 b1 = *reinterpret_cast<const float4*>(&e.bw[l][col + 4]);
        s[0] = fmaf(a, b0.x, s[0]);
        s[1] = fmaf(a, b0.y, s[1]);
        s[2] = fmaf(a, b0.z, s[2]);
        s[3] = fmaf(a, b0.w, s[3]);
        s[4] = fmaf(a, b1.x, s[4]);
        s[5] = fmaf(a, b1.y, s[5]);
        s[6] = fmaf(a, b1.z, s[6]);
        s[7] = fmaf(a, b1.w, s[7]);
    }
    for (int j = 0; j < r_e; ++j) {
        const float b = e.xb[row][j];
#pragma unroll
        for (int i = 0; i < 8; ++i) t[i] = fmaf(b, e.bv[col + i][j], t[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = fmaf(cb, t[i], s[i]);
}

// d of 8 adjacent columns [col, col + 8) of R rows, each output in
// chain_row8's order (so bitwise its value), from row slices of b.w and of
// b.v^T (bvt[j][c] = b.v[c][j]) with row stride ld floats, both read 16
// bytes at a time and shared by the R rows. col % 4 == ld % 4 == 0.
template <int R>
__device__ __forceinline__ void chain_rows8_t(float (*xa)[MAX_RL + 1], float (*xb)[MAX_RE + 1],
                                              const float* bw, const float* bvt, int ld, int r_l, int r_e,
                                              float cb, int col, float (&d)[R][8]) {
    float s[R][8], t[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) s[r][i] = t[r][i] = 0.f;
    for (int l = 0; l < r_l; ++l) {
        const float4 b0 = *reinterpret_cast<const float4*>(bw + l * ld + col);
        const float4 b1 = *reinterpret_cast<const float4*>(bw + l * ld + col + 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float a = xa[r][l];
            s[r][0] = fmaf(a, b0.x, s[r][0]);
            s[r][1] = fmaf(a, b0.y, s[r][1]);
            s[r][2] = fmaf(a, b0.z, s[r][2]);
            s[r][3] = fmaf(a, b0.w, s[r][3]);
            s[r][4] = fmaf(a, b1.x, s[r][4]);
            s[r][5] = fmaf(a, b1.y, s[r][5]);
            s[r][6] = fmaf(a, b1.z, s[r][6]);
            s[r][7] = fmaf(a, b1.w, s[r][7]);
        }
    }
    for (int j = 0; j < r_e; ++j) {
        const float4 v0 = *reinterpret_cast<const float4*>(bvt + j * ld + col);
        const float4 v1 = *reinterpret_cast<const float4*>(bvt + j * ld + col + 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float b = xb[r][j];
            t[r][0] = fmaf(b, v0.x, t[r][0]);
            t[r][1] = fmaf(b, v0.y, t[r][1]);
            t[r][2] = fmaf(b, v0.z, t[r][2]);
            t[r][3] = fmaf(b, v0.w, t[r][3]);
            t[r][4] = fmaf(b, v1.x, t[r][4]);
            t[r][5] = fmaf(b, v1.y, t[r][5]);
            t[r][6] = fmaf(b, v1.z, t[r][6]);
            t[r][7] = fmaf(b, v1.w, t[r][7]);
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) d[r][i] = fmaf(cb, t[r][i], s[r][i]);
}

// ------------------------------------------------ the thin operand on the tensor cores

// hi = bf16(v) and lo = bf16(v - hi) of the f32 value with these bits, as
// one word: hi in the low half (slot column 2p), lo in the high (2p + 1).
// hi + lo keeps v to ~2^-16 relative; a value exact in bf16 has lo = 0.
__device__ __forceinline__ uint32_t thin_hi_lo(uint32_t bits) {
    const float v = __uint_as_float(bits);
    const __nv_bfloat16 hi = __float2bfloat16_rn(v), lo = __float2bfloat16_rn(v - __bfloat162float(hi));
    return (uint32_t)__bfloat16_as_ushort(hi) | (uint32_t)__bfloat16_as_ushort(lo) << 16;
}

// Rows [k0, k0 + BK) of a.w and of the lane's a.u (gu: its first byte) into
// the raw stage d (zeros past K), threads t = 0 .. NTHR - 1 of the caller's
// group. With quads (r_l, r_e multiples of 4 and both factors 16-byte
// aligned): 16-byte cp.async of a.w rows, 8-byte (bf16) or 16-byte (f32)
// ones of a.u rows, chunk c of row kk at t + i * NTHR = BK c + kk, so a warp
// copies one chunk column; the caller commits them. Otherwise plain 4- and
// 2-byte copies.
template <int BK, int HALF, int NTHR>
__device__ __forceinline__ void load_thin_raw(uint32_t* d, const Factors& f, const char* gu, bool au_f32,
                                              bool quads, int k0, int K, int t) {
    const int r_l = f.r_l, r_e = f.r_e;
    if (quads) {
        const int cw = r_l / 4, cn = cw + r_e / 4;
#pragma unroll
        for (int i = 0; i < (BK * HALF / 4 + NTHR - 1) / NTHR; ++i) {
            const int e = t + i * NTHR, c = e / BK, kk = e % BK, k = k0 + kk;
            if (c < cn) {
                const int n = k < K ? 1 : 0;
                if (c < cw) {
                    hses::cp_async16(d + kk * HALF + 4 * c, n ? f.aw + (int64_t)k * r_l + 4 * c : f.aw, 16 * n);
                } else if (au_f32) {
                    hses::cp_async16(d + kk * HALF + r_l + 4 * (c - cw),
                                     n ? gu + ((int64_t)k * r_e + 4 * (c - cw)) * 4 : gu, 16 * n);
                } else {
                    hses::cp_async8(d + kk * HALF + r_l + 2 * (c - cw),
                                    n ? gu + ((int64_t)k * r_e + 4 * (c - cw)) * 2 : gu, 8 * n);
                }
            }
        }
        return;
    }
    for (int i = t; i < BK * r_l; i += NTHR) {
        const int kk = i / r_l, w = i % r_l, k = k0 + kk;
        d[kk * HALF + w] = k < K ? __float_as_uint(f.aw[(int64_t)k * r_l + w]) : 0u;
    }
    const int uh = r_e * (au_f32 ? 2 : 1);  // 2-byte halves of an a.u row
    for (int i = t; i < BK * uh; i += NTHR) {
        const int kk = i / uh, j = i % uh, k = k0 + kk;
        reinterpret_cast<unsigned short*>(d + kk * HALF + r_l)[j] =
            k < K ? reinterpret_cast<const unsigned short*>(gu)[(int64_t)k * uh + j] : (unsigned short)0;
    }
}

// Raw stage rs into the slot s ([BK][SROW] bf16, SROW even): word (kk, p) =
// thin_hi_lo of factor value p, four adjacent words (a quad q) a thread,
// thread t + i * NTHR = BK q + kk (a warp splits one quad column: whole f32
// words, or bf16 a.u halves), 16-byte shared loads and stores. K2's; K3's
// ThinColumns::split is the same split written in place (calling this one
// from K3 moves its register allocation).
template <int BK, int HALF, int SROW, int NTHR>
__device__ __forceinline__ void split_thin_raw(uint32_t* s, const uint32_t* rs, int r_l, int C, bool au_f32,
                                               bool quads, int t) {
#pragma unroll
    for (int i = 0; i < (BK * HALF / 4 + NTHR - 1) / NTHR; ++i) {
        const int e = t + i * NTHR, q = e / BK, kk = e % BK, p0 = 4 * q;
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
        o.x = p0 < C ? thin_hi_lo(w[0]) : 0u;
        o.y = p0 + 1 < C ? thin_hi_lo(w[1]) : 0u;
        o.z = p0 + 2 < C ? thin_hi_lo(w[2]) : 0u;
        o.w = p0 + 3 < C ? thin_hi_lo(w[3]) : 0u;
        *reinterpret_cast<uint4*>(s + kk * (SROW / 2) + p0) = o;
    }
}

}  // namespace lora_chain
