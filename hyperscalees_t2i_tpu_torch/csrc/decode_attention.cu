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
// to whole blocks. Here one block owns one (batch row, head, 64-query tile)
// and walks the kv prefix in a loop of 64-position tiles; q, K, V and the
// output are read and written in place through their strides ([B, n, H, dh]
// layouts, no head-major or padding copy) and nothing past kv_len is read.
//
// Block layout: 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns
// query rows 4*ty .. 4*ty+3 of the tile, logit columns tx + 16*c of each kv
// tile and output columns tx + 16*d. The 16 threads of a row group are one
// half-warp, so row max and row sum reduce with shuffles and the probability
// tile is handed from the logit step to the P @ V step with __syncwarp.
// Shared memory (dynamic, f32): the q tile, the K and V tiles (rows padded
// to dh + 1 so column walks do not collide on banks) and the probabilities.
//
// What bounds it: bytes. For the VAR-d16 decode (32 rows, 16 heads, dh 64)
// the work per layer is 4 * nq * kv_len * dh flops over nq * dh query and
// 2 * kv_len * dh cache values per (row, head): at most 256 queries against
// 680 keys, about 128 flops per bf16 byte, under the card's ~295. The design
// reads the kv prefix once per 64-query tile (once for every scale but the
// last three) and keeps logits out of device memory. The logit and P @ V
// products run as f32 FMAs on the CUDA cores, each operand read from shared
// memory, so this simple kernel stays far from the bytes bound (on an H100,
// 1.58 ms against 0.037 ms at the last VAR-d16 scale); tensor cores
// (mma/wgmma over bf16 tiles), TMA loads and a kv split for long caches are
// the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BKV = 64;      // cache positions per kv tile
constexpr int THREADS = 256;
constexpr int RPT = 4;       // query rows per thread
constexpr int CPT = BKV / 16;  // logit columns per thread
constexpr int MAX_DH = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

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

size_t smem_bytes(int dh) {
    const int ld = dh + 1;
    return sizeof(float) * ((size_t)BQ * ld + 2 * (size_t)BKV * ld + (size_t)BQ * (BKV + 1));
}

// DPT: output columns per thread (dh <= 16 * DPT)
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(Args a) {
    extern __shared__ float smem[];
    const int dh = a.dh, ld = dh + 1;
    float* qs = smem;              // [BQ][ld]
    float* ks = qs + BQ * ld;      // [BKV][ld]
    float* vs = ks + BKV * ld;     // [BKV][ld]
    float* ps = vs + BKV * ld;     // [BQ][BKV + 1]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const T* q = (const T*)a.q + b * a.qsb + h * a.qsh;
    const T* k = (const T*)a.k + b * a.ksb + h * a.ksh;
    const T* v = (const T*)a.v + b * a.vsb + h * a.vsh;
    const unsigned char* mask = a.mask ? a.mask + b * a.msb : nullptr;

    for (int i = tid; i < BQ * dh; i += THREADS) {
        const int r = i / dh, c = i - (i / dh) * dh;
        qs[r * ld + c] = q0 + r < a.nq ? to_f32(q[(long long)(q0 + r) * a.qsn + c]) : 0.f;
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
            ks[r * ld + c] = in ? to_f32(k[pos * a.ksl + c]) : 0.f;
            vs[r * ld + c] = in ? to_f32(v[pos * a.vsl + c]) : 0.f;
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

    T* out = (T*)a.out + b * a.osb + h * a.osh;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int row = q0 + ty * RPT + r;
        if (row >= a.nq) continue;
        const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int d = 0; d < DPT; ++d) {
            const int col = tx + 16 * d;
            if (col < dh) out[(long long)row * a.osn + col] = from_f32<T>(acc[r][d] / denom);
        }
    }
}

template <typename T, int DPT>
int launch_dpt(const Args& a, int B, int H, void* stream) {
    const size_t smem = smem_bytes(a.dh);
    cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T, DPT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.nq + BQ - 1) / BQ, H, B);
    decode_attention_kernel<T, DPT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           int B, int nq, int H, int dh, int kv_len,
           long long qsb, long long qsn, long long qsh,
           long long ksb, long long ksl, long long ksh,
           long long vsb, long long vsl, long long vsh, long long msb,
           long long osb, long long osn, long long osh, float scale, void* stream) {
    if (dh < 1 || dh > MAX_DH || kv_len < 1 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
    if (B <= 0 || nq <= 0 || H <= 0) return (int)cudaSuccess;
    Args a{q, k, v, (const unsigned char*)mask, out, qsb, qsn, qsh, ksb, ksl, ksh,
           vsb, vsl, vsh, msb, osb, osn, osh, nq, kv_len, dh, scale};
    return dh <= 64 ? launch_dpt<T, 4>(a, B, H, stream) : launch_dpt<T, 8>(a, B, H, stream);
}

}  // namespace

// q [B, nq, H, dh], k and v [B, L, H, dh] (only the first kv_len positions
// are read), out [B, nq, H, dh], all in one dtype and addressed through the
// given (batch, position, head) strides in elements; mask [B, L] bytes with
// batch stride msb, or null. Entry names: hses_decode_attention_<dtype>.
#define HSES_DECODE_ATTENTION_ENTRY(NAME, T)                                                   \
    extern "C" int NAME(const void* q, const void* k, const void* v, const void* mask,          \
                        void* out, int B, int nq, int H, int dh, int kv_len,                    \
                        long long qsb, long long qsn, long long qsh,                            \
                        long long ksb, long long ksl, long long ksh,                            \
                        long long vsb, long long vsl, long long vsh, long long msb,             \
                        long long osb, long long osn, long long osh, float scale,               \
                        void* stream) {                                                         \
        return launch<T>(q, k, v, mask, out, B, nq, H, dh, kv_len, qsb, qsn, qsh,              \
                         ksb, ksl, ksh, vsb, vsl, vsh, msb, osb, osn, osh, scale, stream);     \
    }

HSES_DECODE_ATTENTION_ENTRY(hses_decode_attention_bf16, __nv_bfloat16)
HSES_DECODE_ATTENTION_ENTRY(hses_decode_attention_f32, float)
