// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes `extern "C"` launchers that take raw pointers and
// a cudaStream_t as void*, launch on that stream without synchronising, and
// return cudaGetLastError() so the Python wrapper can raise on a refused
// launch. Element types: float (code 0) and __nv_bfloat16 (code 1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pmt {

enum DType { DT_F32 = 0, DT_BF16 = 1 };

constexpr float NEG_INF = -1e30f;  // finite "minus infinity", as in the JAX kernels

// true -inf (for argmax seeds; the attention kernels use the finite NEG_INF)
__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// Round an fp32 value through T (identity for float): the "compute dtype"
// rounding that the bf16 paths apply at fixed points.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// 16-byte read-only loads widened to fp32 (4 floats or 8 bf16 values)
__device__ __forceinline__ void widen(uint4 u, float* o) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        o[2 * i] = __uint_as_float(w[i] << 16);
        o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}
__device__ __forceinline__ void ld16(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float* o) {
    widen(__ldg(reinterpret_cast<const uint4*>(p)), o);
}

// 16-byte shared-memory loads widened to fp32 (4 floats or 8 bf16 values)
__device__ __forceinline__ void lds16(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void lds16(const __nv_bfloat16* p, float* o) {
    widen(*reinterpret_cast<const uint4*>(p), o);
}

// 16-byte asynchronous copies global -> shared (cp.async, in groups)
__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
// the same with `src_bytes` (0..16) read and the rest of the 16 bytes zero-filled
__device__ __forceinline__ void cp16(void* smem, const void* gmem, int src_bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// A split thread-block-cluster barrier: arrive (relaxed) early, wait before
// the first access to a peer's shared memory, so no CTA writes into one that
// has not started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// ---------------------------------------------------------------- tensor cores (mma.sync)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: each lane gives the address of one 16-byte row of an 8x8 b16
// matrix (lanes 8i..8i+7 matrix i); lane l receives the 32-bit word (l % 4)
// of row l / 4 of each matrix (.trans: of each matrix transposed)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {  // lanes 0-15 give the addresses
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16x8 fp32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32 (fp32 operands split as hi + lo, both tf32; about
// 2^-21 per product): the small terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah, const uint32_t* al, const uint32_t* bh,
                                           const uint32_t* bl) {
    mma_tf32(c, al, bh);
    mma_tf32(c, ah, bl);
    mma_tf32(c, ah, bh);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
}

// ---------------------------------------------------------------- bulk copies (cp.async.bulk + mbarrier)

// Bulk asynchronous copies global -> shared (cp.async.bulk: the SM's copy
// engine moves a contiguous run of 16-byte multiples; one instruction, no
// per-thread issue slots), completing on a shared-memory mbarrier that
// counts the bytes.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
// the one arrival of the barrier's phase, expecting `bytes` of copies
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    unsigned done = 0;
    while (!done)
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}
// shared memory read by threads is about to be written by the copy engine
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace pmt
