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

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace pmt
