// Decode attention for Hopper (K4):
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h]) @ v[b, j, h]
// over the first kv_len positions j of a KV cache, with an optional bool key
// mask [B, L] (a masked key's logit is NEG_INF = -1e30, finite, so an
// all-masked row averages V uniformly over the kv_len prefix). f32 running
// max, sum and accumulator; the output is written once, in q's dtype.
//
// Replaces the TPU kernel hyperscalees_t2i_tpu/ops/attention.py:_flash_kernel
// (launched by _pallas_attention, entry decode_attention). There the kv axis
// is a sequential grid dimension whose steps carry the running (max, sum,
// weighted V) in VMEM scratch, over head-major copies of q, K and V padded
// to whole blocks. Here one block owns one (batch row, head, query tile) and
// walks the kv prefix in a loop of 64-position tiles; q, K, V and the output
// are read and written in place through their strides ([B, n, H, dh]
// layouts, no head-major or padding copy) and nothing past kv_len is read.
// The query tile is the fastest grid dimension, so the blocks of one (row,
// head) run side by side and their repeat reads of K and V hit the L2.
//
// What bounds it: bytes. For the VAR-d16 decode (32 rows, 16 heads, dh 64)
// the work per layer is 4 * nq * kv_len * dh flops over nq * dh query and
// 2 * kv_len * dh cache values per (row, head): at the last scale, 256
// queries against 680 keys, about 186 flops per bf16 byte moved, under the
// card's ~295 (bound 0.037 ms on an H100). The exponentials of the softmax
// (nq * kv_len per (row, head)) run on the special-function units, about a
// quarter of that time again. As built, the last scale takes 0.126 ms on an
// H100 at 700 W (PERF.md section 6): every warp reads the whole K and V tile
// from shared memory through ldmatrix for its 16 rows, about 1.5 GB of
// shared-memory reads at that scale, the busiest pipe; wgmma, whose
// B operand one warpgroup reads once for 64 rows, is the next step.
//
// bf16 (the VAR path; every bf16 shape takes this one route): FlashAttention-2
// on mma.sync. Each warp owns 16 query rows; a block has 1, 2, 4 or 8 warps
// (16 to 128 rows), chosen in Python (ops/attention.py:_plan) from nq by a
// measured rule. A warp wholly past nq skips the math and only helps stage
// the kv tiles, so the first scale's single query costs one warp's math.
// - q is staged once by cp.async and held in registers as A fragments
//   (ldmatrix); K and V tiles of 64 positions move through a 2- or 3-stage
//   cp.async ring, one barrier a tile. A position's dh values are
//   contiguous in the [B, L, H, dh] cache: 16-byte copies where dh, the
//   strides and the pointers allow, 8-byte or element copies otherwise
//   (the plan's copy widths, which the C entry checks). Shared rows are
//   padded by 16 bytes so the 8 rows of an ldmatrix fall on distinct banks.
//   A dh that is not a multiple of 16 is zero-padded to the next one in
//   shared memory; positions past kv_len are zero-filled with src_bytes 0
//   and never read (a NaN there would survive 0 * NaN inside an mma).
// - S = Q K^T as mma.sync.m16n8k16 bf16 -> f32, K's [position][dh] rows
//   serving as the col-major B fragment through plain ldmatrix.
// - The online softmax in registers: sm_scale * log2(e) folded into the
//   logits and 2^x on the special-function unit (ex2.approx); a row lives in
//   one quad of lanes (two shuffles for its max). A full unmasked tile takes
//   one FFMA a logit before the exponential; an edge tile (a mask, the
//   ragged last tile) scales each logit and keeps the f32 route's two cases:
//   positions past kv_len are absent (p = 0), masked keys inside the prefix
//   take the logit NEG_INF (the mask's bytes are read once a tile, by a warp
//   ballot).
// - O += P V: S's accumulator layout is the A-fragment layout of the next
//   mma, so P goes to bf16 fragments in registers (P rounded to bf16, its
//   f32 row sum kept); V is the B operand through ldmatrix.trans.
// - Epilogue: O / max(l, 1e-30), bf16, rows past nq not written.
//
// f32 (off the VAR-d16 path: the tiny VAR's card-vs-CPU check and f32
// checks): CUDA-core FMAs, 64-query tiles of 256 threads, thread (ty, tx) =
// (tid / 16, tid % 16) owning query rows 4 ty .. 4 ty + 3, logit columns
// tx + 16 c and output columns tx + 16 d; f32 tiles staged element by
// element, rows padded to dh + 1; expf on each logit.
//
// Bitwise invariance by construction: a query's output depends only on its
// q row, its (row, head) cache prefix, kv_len, its mask row and the kv tile
// width (64, fixed): the kv tiles are walked in order and every sum over a
// row stays inside the row's own lanes. It does not depend on B, nq, the
// query tile, the warp or the plan's rows, stages and copy widths.

#include "int8_mma.cuh"

#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BKV = 64;  // cache positions per kv tile, both routes
constexpr int MAX_DH = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Strides are in elements; the head dimension is contiguous in every tensor.
struct Args {
    const void* q;
    const void* k;
    const void* v;
    const unsigned char* mask;  // [B, L] bool, or null: no mask
    void* out;
    long long qsb, qsn, qsh;
    long long ksb, ksl, ksh;
    long long vsb, vsl, vsh;
    long long msb;
    long long osb, osn, osh;
    int nq, kv_len, dh;
    float scale;
};

// ---------------------------------------------------------------- bf16 route

extern __shared__ __align__(16) unsigned char attn_smem[];

// bf16 row stride in shared memory: dh padded to 16, plus 8 (16 bytes, so
// the 8 rows of an ldmatrix start on distinct banks)
__host__ __device__ constexpr int row_ld(int dhp) { return dhp + 8; }

size_t mma_smem_bytes(int rows, int dhp, int stages) {
    return sizeof(bf16) * (size_t)row_ld(dhp) * ((size_t)rows + 2 * (size_t)stages * BKV);
}

// Rows [0, rows) of a [*, dh] slice (row stride ld in elements) into shared
// rows of DHP columns, VEC elements a copy (8: 16-byte cp.async, 4: 8-byte,
// 1: element loads). Rows >= valid and columns >= dh are zero: their copies
// read nothing (src_bytes 0).
template <int DHP, int VEC>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long ld, int rows, int valid, int dh) {
    constexpr int CPR = DHP / VEC;  // copies a row
    for (int i = threadIdx.x; i < rows * CPR; i += blockDim.x) {
        const int r = i / CPR, c = (i % CPR) * VEC;
        bf16* d = dst + r * row_ld(DHP) + c;
        const bool in = r < valid && c < dh;
        const bf16* s = in ? src + r * ld + c : src;
        if constexpr (VEC == 8) hses::cp_async16(d, s, in ? 16 : 0);
        else if constexpr (VEC == 4) hses::cp_async8(d, s, in ? 8 : 0);
        else *d = in ? *s : __float2bfloat16(0.f);
    }
}

template <int DHP>
__device__ __forceinline__ void stage(int vec, bf16* dst, const bf16* src, long long ld, int rows, int valid,
                                      int dh) {
    if (vec == 8) stage_rows<DHP, 8>(dst, src, ld, rows, valid, dh);
    else if (vec == 4) stage_rows<DHP, 4>(dst, src, ld, rows, valid, dh);
    else stage_rows<DHP, 1>(dst, src, ld, rows, valid, dh);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the special-function unit (flush to zero: 2^-1e30 and 2^-inf are 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// DHP: dh padded to a multiple of 16. blockDim.x = 2 * rows (16 rows a warp).
template <int DHP>
__global__ void __launch_bounds__(256)
decode_attention_mma_kernel(Args a, int stages, int q_vec, int k_vec, int v_vec) {
    constexpr int LD = row_ld(DHP), KS = DHP / 16, NT = DHP / 8;
    const int rows = blockDim.x / 2;
    bf16* qs = reinterpret_cast<bf16*>(attn_smem);  // [rows][LD]
    bf16* ks = qs + rows * LD;                       // [stages][BKV][LD]
    bf16* vs = ks + stages * BKV * LD;               // [stages][BKV][LD]

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int q0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
    const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh + q0 * a.qsn;
    const bf16* k = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
    const bf16* v = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;
    const unsigned char* mask = a.mask ? a.mask + b * a.msb : nullptr;
    const int ntiles = (a.kv_len + BKV - 1) / BKV;
    const int wq0 = q0 + 16 * warp;  // the warp's first query
    const bool active = wq0 < a.nq;  // a warp wholly past nq only helps load

    auto load_kv = [&](int t) {
        const int kv0 = t * BKV, valid = min(BKV, a.kv_len - kv0), slot = (t % stages) * BKV * LD;
        stage<DHP>(k_vec, ks + slot, k + kv0 * a.ksl, a.ksl, BKV, valid, a.dh);
        stage<DHP>(v_vec, vs + slot, v + kv0 * a.vsl, a.vsl, BKV, valid, a.dh);
    };

    // q and the first stages - 1 tiles: one commit group each (q with tile 0)
    stage<DHP>(q_vec, qs, q, a.qsn, rows, a.nq - q0, a.dh);
    for (int t = 0; t < stages - 1; ++t) {
        if (t < ntiles) load_kv(t);
        hses::cp_async_commit();
    }

    uint32_t qf[KS][4];
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    // the thread's rows: lane / 4 (accumulator entries 0, 1; r = 0) and
    // lane / 4 + 8 (entries 2, 3; r = 1)
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const float sl2 = a.scale * LOG2E;
    const int cq = 2 * (lane & 3);  // the thread's first column of each n8 tile

    for (int t = 0; t < ntiles; ++t) {
        if (stages == 3) hses::cp_async_wait<1>();
        else hses::cp_async_wait<0>();
        __syncthreads();  // tile t landed for all; every warp is done with tile t - 1's slot
        if (t + stages - 1 < ntiles) load_kv(t + stages - 1);  // into that slot
        hses::cp_async_commit();
        if (!active) continue;
        if (t == 0) {
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
                hses::ldmatrix_x4(qf[kk], qs + (16 * warp + (lane & 15)) * LD + 16 * kk + (lane >> 4) * 8);
        }
        const bf16* kt = ks + (t % stages) * BKV * LD;
        const bf16* vt = vs + (t % stages) * BKV * LD;
        const int kv0 = t * BKV, ncols = min(BKV, a.kv_len - kv0);

        // S = Q K^T, 16 x 64: n8 tile j holds positions 8 j .. 8 j + 7
        float s[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
            for (int j = 0; j < 8; j += 2) {
                // matrices: positions 8 j + (0..7) and 8 j + 8 + (0..7), dh 16 kk + (0, 8)
                uint32_t kf[4];
                hses::ldmatrix_x4(kf, kt + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * kk +
                                          ((lane >> 3) & 1) * 8);
                hses::mma_bf16_16816(s[j], qf[kk], kf[0], kf[1]);
                hses::mma_bf16_16816(s[j + 1], qf[kk], kf[2], kf[3]);
            }
        }

        // An edge tile (a mask, the ragged last tile, or a scale <= 0) scales
        // each logit and gives a masked key NEG_INF and an absent one -inf
        // (p = 0); a full unmasked tile takes the row max of the raw logits
        // and one FFMA a logit before the exponential.
        const bool edge = mask != nullptr || ncols < BKV || !(sl2 > 0.f);
        float mx[2] = {NEG_INF, NEG_INF};
        if (edge) {
            unsigned long long allowed = ~0ull;  // one bit a position: unmasked
            if (mask) {
                const int p0 = kv0 + lane, p1 = kv0 + 32 + lane;
                const unsigned lo = __ballot_sync(0xffffffffu, p0 < a.kv_len && mask[p0] != 0);
                const unsigned hi = __ballot_sync(0xffffffffu, p1 < a.kv_len && mask[p1] != 0);
                allowed = (static_cast<unsigned long long>(hi) << 32) | lo;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = 8 * j + cq + (e & 1);
                    const float x = (allowed >> col) & 1 ? s[j][e] * sl2 : NEG_INF;
                    s[j][e] = col < ncols ? x : __int_as_float(0xff800000);  // -inf
                    mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
                }
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
        const float mul = edge ? 1.f : sl2;  // an edge tile's logits are scaled already
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], quad_max(mx[r]) * mul);
            alpha[r] = ex2(m[r] - m_new);
            m[r] = m_new;
            l[r] *= alpha[r];
        }
        // P as the A fragments of the four k16 steps over the tile's positions
        uint32_t pf[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) p[e] = ex2(fmaf(s[j][e], mul, -m[e >> 1]));
            l[0] += p[0] + p[1];
            l[1] += p[2] + p[3];
            pf[j >> 1][2 * (j & 1)] = pack_bf16x2(p[0], p[1]);
            pf[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(p[2], p[3]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            o[n][0] *= alpha[0];
            o[n][1] *= alpha[0];
            o[n][2] *= alpha[1];
            o[n][3] *= alpha[1];
        }
        // O += P V: V's [position][dh] rows are the k-major B operand
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int n = 0; n < NT; n += 2) {
                uint32_t vf[4];
                hses::ldmatrix_x4_trans(vf, vt + (16 * kk + (lane & 15)) * LD + 8 * n + (lane >> 4) * 8);
                hses::mma_bf16_16816(o[n], pf[kk], vf[0], vf[1]);
                hses::mma_bf16_16816(o[n + 1], pf[kk], vf[2], vf[3]);
            }
        }
    }
    hses::cp_async_wait<0>();  // no copy outlives the block
    if (!active) return;

    bf16* out = static_cast<bf16*>(a.out) + b * a.osb + h * a.osh;
    const bool pairs = ((reinterpret_cast<uintptr_t>(a.out) & 3) | ((a.osb | a.osn | a.osh) & 1)) == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
        const int row = wq0 + (lane >> 2) + 8 * r;
        if (row >= a.nq) continue;
        bf16* orow = out + row * a.osn;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int col = 8 * n + cq;
            if (col >= a.dh) continue;
            const float v0 = o[n][2 * r] / denom, v1 = o[n][2 * r + 1] / denom;
            if (pairs && col + 1 < a.dh) {
                *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
            } else {
                orow[col] = __float2bfloat16(v0);
                if (col + 1 < a.dh) orow[col + 1] = __float2bfloat16(v1);
            }
        }
    }
}

template <int DHP>
int launch_mma_dhp(const Args& a, int B, int H, int rows, int stages, int q_vec, int k_vec, int v_vec,
                   void* stream) {
    const size_t smem = mma_smem_bytes(rows, DHP, stages);
    cudaError_t err = hses::raise_smem_limit(decode_attention_mma_kernel<DHP>, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.nq + rows - 1) / rows, H, B);
    decode_attention_mma_kernel<DHP><<<grid, 2 * rows, smem, (cudaStream_t)stream>>>(a, stages, q_vec, k_vec,
                                                                                      v_vec);
    return (int)cudaGetLastError();
}

int launch_mma(const Args& a, int B, int H, int rows, int stages, int q_vec, int k_vec, int v_vec, void* stream) {
    switch ((a.dh + 15) / 16) {
        case 1: return launch_mma_dhp<16>(a, B, H, rows, stages, q_vec, k_vec, v_vec, stream);
        case 2: return launch_mma_dhp<32>(a, B, H, rows, stages, q_vec, k_vec, v_vec, stream);
        case 3: return launch_mma_dhp<48>(a, B, H, rows, stages, q_vec, k_vec, v_vec, stream);
        case 4: return launch_mma_dhp<64>(a, B, H, rows, stages, q_vec, k_vec, v_vec, stream);
        case 5: return launch_mma_dhp<80>(a, B, H, rows, stages, q_vec, k_vec, v_vec, stream);
        case 6: return launch_mma_dhp<96>(a, B, H, rows, stages, q_vec, k_vec, v_vec, stream);
        case 7: return launch_mma_dhp<112>(a, B, H, rows, stages, q_vec, k_vec, v_vec, stream);
        default: return launch_mma_dhp<128>(a, B, H, rows, stages, q_vec, k_vec, v_vec, stream);
    }
}

// ----------------------------------------------------------------- f32 route

constexpr int BQ = 64;        // queries per block
constexpr int THREADS = 256;
constexpr int RPT = 4;        // query rows per thread
constexpr int CPT = BKV / 16;  // logit columns per thread

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

size_t f32_smem_bytes(int dh) {
    const int ld = dh + 1;
    return sizeof(float) * ((size_t)BQ * ld + 2 * (size_t)BKV * ld + (size_t)BQ * (BKV + 1));
}

// DPT: output columns per thread (dh <= 16 * DPT)
template <int DPT>
__global__ void __launch_bounds__(THREADS)
decode_attention_f32_kernel(Args a) {
    extern __shared__ float smem[];
    const int dh = a.dh, ld = dh + 1;
    float* qs = smem;              // [BQ][ld]
    float* ks = qs + BQ * ld;      // [BKV][ld]
    float* vs = ks + BKV * ld;     // [BKV][ld]
    float* ps = vs + BKV * ld;     // [BQ][BKV + 1]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const float* q = (const float*)a.q + b * a.qsb + h * a.qsh;
    const float* k = (const float*)a.k + b * a.ksb + h * a.ksh;
    const float* v = (const float*)a.v + b * a.vsb + h * a.vsh;
    const unsigned char* mask = a.mask ? a.mask + b * a.msb : nullptr;

    for (int i = tid; i < BQ * dh; i += THREADS) {
        const int r = i / dh, c = i - (i / dh) * dh;
        qs[r * ld + c] = q0 + r < a.nq ? q[(long long)(q0 + r) * a.qsn + c] : 0.f;
    }

    float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[r][d] = 0.f;
    }

    for (int kv0 = 0; kv0 < a.kv_len; kv0 += BKV) {
        const int ncols = min(BKV, a.kv_len - kv0);
        __syncthreads();  // the previous tile's K, V and probabilities are consumed
        for (int i = tid; i < BKV * dh; i += THREADS) {
            const int r = i / dh, c = i - (i / dh) * dh;
            const bool in = r < ncols;
            const long long pos = kv0 + r;
            ks[r * ld + c] = in ? k[pos * a.ksl + c] : 0.f;
            vs[r * ld + c] = in ? v[pos * a.vsl + c] : 0.f;
        }
        __syncthreads();

        float s[RPT][CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
        for (int kk = 0; kk < dh; ++kk) {
            float qv[RPT], kv[CPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r) qv[r] = qs[(ty * RPT + r) * ld + kk];
#pragma unroll
            for (int c = 0; c < CPT; ++c) kv[c] = ks[(tx + 16 * c) * ld + kk];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
                for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        }

        // positions past kv_len are absent (probability 0); masked ones
        // inside it take the finite NEG_INF logit
        bool present[CPT], allowed[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const int col = tx + 16 * c;
            present[c] = col < ncols;
            allowed[c] = present[c] && (mask == nullptr || mask[kv0 + col] != 0);
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            float tmax = NEG_INF;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                s[r][c] = allowed[c] ? s[r][c] * a.scale : NEG_INF;
                if (present[c]) tmax = fmaxf(tmax, s[r][c]);
            }
            const float m_new = fmaxf(m[r], half_warp_max(tmax));
            const float alpha = expf(m[r] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const float p = present[c] ? expf(s[r][c] - m_new) : 0.f;
                ps[(ty * RPT + r) * (BKV + 1) + tx + 16 * c] = p;
                psum += p;
            }
            l[r] = alpha * l[r] + half_warp_sum(psum);
            m[r] = m_new;
#pragma unroll
            for (int d = 0; d < DPT; ++d) acc[r][d] *= alpha;
        }
        __syncwarp();  // a row group's probabilities were written by its own half-warp

        for (int c = 0; c < ncols; ++c) {
            float pr[RPT], vv[DPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r) pr[r] = ps[(ty * RPT + r) * (BKV + 1) + c];
#pragma unroll
            for (int d = 0; d < DPT; ++d) {
                const int col = tx + 16 * d;
                vv[d] = col < dh ? vs[c * ld + col] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
                for (int d = 0; d < DPT; ++d) acc[r][d] = fmaf(pr[r], vv[d], acc[r][d]);
        }
    }

    float* out = (float*)a.out + b * a.osb + h * a.osh;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int row = q0 + ty * RPT + r;
        if (row >= a.nq) continue;
        const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int d = 0; d < DPT; ++d) {
            const int col = tx + 16 * d;
            if (col < dh) out[(long long)row * a.osn + col] = acc[r][d] / denom;
        }
    }
}

template <int DPT>
int launch_f32_dpt(const Args& a, int B, int H, void* stream) {
    const size_t smem = f32_smem_bytes(a.dh);
    cudaError_t err = hses::raise_smem_limit(decode_attention_f32_kernel<DPT>, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.nq + BQ - 1) / BQ, H, B);
    decode_attention_f32_kernel<DPT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- entries

// A copy of vec elements (2-byte) from every (batch, position, head) row:
// dh, the three strides and the pointer must keep each copy aligned.
bool copy_ok(int vec, const void* p, long long s0, long long s1, long long s2, int dh) {
    if (vec == 1) return true;
    if (vec != 4 && vec != 8) return false;
    return dh % vec == 0 && s0 % vec == 0 && s1 % vec == 0 && s2 % vec == 0 &&
           reinterpret_cast<uintptr_t>(p) % (2 * vec) == 0;
}

int launch(bool is_bf16, const void* q, const void* k, const void* v, const void* mask, void* out,
           int B, int nq, int H, int dh, int kv_len,
           long long qsb, long long qsn, long long qsh,
           long long ksb, long long ksl, long long ksh,
           long long vsb, long long vsl, long long vsh, long long msb,
           long long osb, long long osn, long long osh, float scale,
           int rows, int bkv, int stages, int q_vec, int k_vec, int v_vec, void* stream) {
    if (dh < 1 || dh > MAX_DH || kv_len < 1 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
    if (bkv != BKV) return (int)cudaErrorInvalidValue;
    if (is_bf16) {
        if ((rows != 16 && rows != 32 && rows != 64 && rows != 128) || (stages != 2 && stages != 3))
            return (int)cudaErrorInvalidValue;
        if (!copy_ok(q_vec, q, qsb, qsn, qsh, dh) || !copy_ok(k_vec, k, ksb, ksl, ksh, dh) ||
            !copy_ok(v_vec, v, vsb, vsl, vsh, dh))
            return (int)cudaErrorInvalidValue;
    } else if (rows != BQ || stages != 1 || q_vec != 1 || k_vec != 1 || v_vec != 1) {
        return (int)cudaErrorInvalidValue;
    }
    if (B <= 0 || nq <= 0 || H <= 0) return (int)cudaSuccess;
    Args a{q, k, v, (const unsigned char*)mask, out, qsb, qsn, qsh, ksb, ksl, ksh,
           vsb, vsl, vsh, msb, osb, osn, osh, nq, kv_len, dh, scale};
    if (is_bf16) return launch_mma(a, B, H, rows, stages, q_vec, k_vec, v_vec, stream);
    return dh <= 64 ? launch_f32_dpt<4>(a, B, H, stream) : launch_f32_dpt<8>(a, B, H, stream);
}

}  // namespace

// Dynamic shared memory of one block: the bf16 route at (rows, dh, stages),
// or (bf16 = 0) the f32 route at dh.
extern "C" int hses_decode_attention_smem(int bf16_route, int rows, int dh, int stages) {
    if (!bf16_route) return (int)f32_smem_bytes(dh);
    return (int)mma_smem_bytes(rows, (dh + 15) / 16 * 16, stages);
}

// q [B, nq, H, dh], k and v [B, L, H, dh] (only the first kv_len positions
// are read), out [B, nq, H, dh], all in one dtype and addressed through the
// given (batch, position, head) strides in elements; mask [B, L] bytes with
// batch stride msb, or null. Then the plan (ops/attention.py:_plan): query
// rows per block, the kv tile, the ring's stages and the copy widths of q, k
// and v in elements; refused (cudaErrorInvalidValue) unless the route owns
// them and dh, the strides and the pointers allow the copies. Entry names:
// hses_decode_attention_<dtype>.
#define HSES_DECODE_ATTENTION_ENTRY(NAME, IS_BF16)                                                  \
    extern "C" int NAME(const void* q, const void* k, const void* v, const void* mask,               \
                        void* out, int B, int nq, int H, int dh, int kv_len,                         \
                        long long qsb, long long qsn, long long qsh,                                 \
                        long long ksb, long long ksl, long long ksh,                                 \
                        long long vsb, long long vsl, long long vsh, long long msb,                  \
                        long long osb, long long osn, long long osh, float scale,                    \
                        int rows, int bkv, int stages, int q_vec, int k_vec, int v_vec,              \
                        void* stream) {                                                              \
        return launch(IS_BF16, q, k, v, mask, out, B, nq, H, dh, kv_len, qsb, qsn, qsh,             \
                      ksb, ksl, ksh, vsb, vsl, vsh, msb, osb, osn, osh, scale,                       \
                      rows, bkv, stages, q_vec, k_vec, v_vec, stream);                               \
    }

HSES_DECODE_ATTENTION_ENTRY(hses_decode_attention_bf16, true)
HSES_DECODE_ATTENTION_ENTRY(hses_decode_attention_f32, false)
