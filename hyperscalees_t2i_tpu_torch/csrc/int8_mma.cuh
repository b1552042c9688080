// PTX building blocks of the tensor-core routes of the int8 dequant-matmul
// (int8_matmul.cu), the fused int8 + LoRA matmul (fused_qlora.cu), the LoRA
// chain (lora_chain.cu) and decode attention (decode_attention.cu):
// asynchronous global-to-shared copies, ldmatrix, the bf16 m16n8k16 mma
// with f32 accumulators, and s8 -> bf16 conversion.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <unordered_map>

namespace hses {

// Raise a kernel's dynamic shared memory limit above the default 48 KB once
// per kernel and size: a launch that needs no more than an earlier one set
// makes no call, so the launches a CUDA graph captures after its warm-up
// make none (the limit is the function's, not the stream's).
template <typename Kernel>
inline cudaError_t raise_smem_limit(Kernel kernel, int bytes) {
    static std::unordered_map<const void*, int> limit;  // per kernel, the bytes set so far
    if (bytes <= 48 * 1024) return cudaSuccess;
    int& have = limit[reinterpret_cast<const void*>(kernel)];
    if (bytes <= have) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) have = bytes;
    return e;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 (or 8) bytes from global to shared memory without passing through
// registers. src_bytes < size zero-fills the rest; with src_bytes == 0 the
// source is not read at all (the ragged edges of a tile).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
// Thread t receives row t/4, columns 2(t%4), 2(t%4)+1 of each matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}
// Two 8x8 b16 matrices, transposed; lanes 8i..8i+7 give the row addresses
// of matrix i. Thread t receives rows 2(t%4), 2(t%4)+1, column t/4 of each:
// from a k-major [k][n] tile, the col-major B fragment of mma.m16n8k16.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)) : "memory");
}
// Four 8x8 b16 matrices, transposed: two ldmatrix_x2_trans in one. From a
// k-major [k][n] tile with lanes 0-15 at rows k .. k + 15 of column n and
// lanes 16-31 at the same rows of column n + 8, r[0], r[1] are the col-major
// B fragment of n8 tile n and r[2], r[3] that of n8 tile n + 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}
// d[16x8] += a[16x16] (row-major fragment) @ b[16x8] (col-major fragment),
// bf16 inputs, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four s8 (one 32-bit word, byte 0 first) to four bf16 (two bf16x2 words).
// Each byte, offset to u8 (s + 128), becomes the low mantissa byte of the
// f32 2^23 + u; subtracting 2^23 + 128 leaves s exactly. |s| <= 128 needs at
// most 8 significant bits, so the f32's low 16 bits are zero and its top
// half is the exact bf16.
__device__ __forceinline__ void s8x4_to_bf16x4(uint32_t v, uint32_t& lo, uint32_t& hi) {
    const uint32_t u = v ^ 0x80808080u;
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
    lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

}  // namespace hses
