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
// bf16 or f32) are widened as they are loaded. Rows of x are grouped
// lane-major: lane l owns rows [l * rows_per_lane, (l + 1) * rows_per_lane)
// and its own (u, v, c); w is shared by every lane. u and v of lane l start
// at l times their lane stride (in elements); inside a lane they are
// row-major [din or dout or r_l, r_e].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    const float ca = f.ca[lane];
    for (int i = tid; i < ROWS * rl; i += nthreads) {
        const int r = i / rl, l = i % rl;
        float s = 0.f;
        for (int j = 0; j < re; ++j) s = fmaf(thin[r][rl + j], e.av[l][j], s);
        e.xa[r][l] = fmaf(ca, s, thin[r][l]);
    }
    __syncthreads();
    for (int i = tid; i < ROWS * re; i += nthreads) {
        const int r = i / re, j = i % re;
        float s = 0.f;
        for (int l = 0; l < rl; ++l) s = fmaf(e.xa[r][l], e.bu[l][j], s);
        e.xb[r][j] = s;
    }
    __syncthreads();
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

}  // namespace lora_chain
