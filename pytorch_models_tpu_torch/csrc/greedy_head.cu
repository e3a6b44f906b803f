// Fused greedy head: out[b] = argmax_v (x[b] . emb[v]) without writing logits.
//
// Replaces pytorch_models_tpu/ops/greedy_head.py `greedy_argmax_tied` (the
// Pallas kernel streaming the tied embedding in vocab chunks with a running
// (best value, best index) in VMEM scratch).
//
// What bounds it on the H100: bytes. The (V, d) embedding is read once per
// step (GPT-2: 50257 x 768 = 77 MB fp32, 39 MB bf16) for 2*B FLOPs per
// element; the logits a matmul + argmax would write and read back are what
// this kernel saves. The design: pass 1 gives each block a chunk of CHUNK
// vocab rows; its 8 warps take rows in turn, a warp reads one row once
// (coalesced) and dots it with every batch row held in shared memory as
// fp32. Blocks run in no order, so each writes its chunk's (value, index)
// per batch row, and pass 2 (one block per batch row) reduces the chunks.
// Both passes use the same order: larger value wins, then smaller index —
// so ties go to the lowest index like jnp.argmax. In bf16 each
// fp32-accumulated score is rounded to bf16 before comparing, as the XLA
// head matmul would round its logits. Ragged vocab edge: rows >= V are
// never visited.
#include <climits>

#include "common.cuh"

namespace {

constexpr int NW = 8;       // warps per block in pass 1
constexpr int CHUNK = 128;  // vocab rows per block in pass 1
constexpr int BG = 8;       // batch rows scored per sweep of an embedding row

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
    return s > bs || (s == bs && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(NW * 32)
greedy_chunk_kernel(const T* __restrict__ x, const T* __restrict__ emb, float* __restrict__ part_val,
                    int* __restrict__ part_idx, int b, int v, int d, int n_chunks) {
    extern __shared__ float smem[];
    float* xs = smem;                                   // (b, d) fp32
    float* best_v = xs + static_cast<int64_t>(b) * d;   // (NW, b)
    int* best_i = reinterpret_cast<int*>(best_v + NW * b);  // (NW, b)

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int i = threadIdx.x; i < b * d; i += blockDim.x) xs[i] = pmt::to_f32(x[i]);
    for (int i = threadIdx.x; i < NW * b; i += blockDim.x) {
        best_v[i] = pmt::neg_inf();
        best_i[i] = INT_MAX;
    }
    __syncthreads();

    const int row0 = blockIdx.x * CHUNK;
    const int row_end = min(row0 + CHUNK, v);
    for (int row = row0 + warp; row < row_end; row += NW) {
        const T* er = emb + static_cast<int64_t>(row) * d;
        for (int b0 = 0; b0 < b; b0 += BG) {
            float acc[BG];
#pragma unroll
            for (int i = 0; i < BG; ++i) acc[i] = 0.f;
            for (int c = lane; c < d; c += 32) {
                const float w = pmt::to_f32(er[c]);
#pragma unroll
                for (int i = 0; i < BG; ++i)
                    if (b0 + i < b) acc[i] += xs[(b0 + i) * d + c] * w;
            }
#pragma unroll
            for (int i = 0; i < BG; ++i) {
                const float s = pmt::round_to<T>(pmt::warp_sum(acc[i]));
                if (lane == 0 && b0 + i < b) {
                    const int slot = warp * b + b0 + i;
                    if (better(s, row, best_v[slot], best_i[slot])) {
                        best_v[slot] = s;
                        best_i[slot] = row;
                    }
                }
            }
        }
    }
    __syncthreads();

    for (int r = threadIdx.x; r < b; r += blockDim.x) {
        float bv = pmt::neg_inf();
        int bi = INT_MAX;
        for (int w = 0; w < NW; ++w) {
            if (better(best_v[w * b + r], best_i[w * b + r], bv, bi)) {
                bv = best_v[w * b + r];
                bi = best_i[w * b + r];
            }
        }
        part_val[static_cast<int64_t>(r) * n_chunks + blockIdx.x] = bv;
        part_idx[static_cast<int64_t>(r) * n_chunks + blockIdx.x] = bi;
    }
}

constexpr int R_THREADS = 256;

__global__ void __launch_bounds__(R_THREADS)
greedy_reduce_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                     int64_t* __restrict__ out, int n_chunks) {
    __shared__ float sv[R_THREADS];
    __shared__ int si[R_THREADS];
    const int r = blockIdx.x;
    float bv = pmt::neg_inf();
    int bi = INT_MAX;
    for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
        const float s = part_val[static_cast<int64_t>(r) * n_chunks + c];
        const int i = part_idx[static_cast<int64_t>(r) * n_chunks + c];
        if (better(s, i, bv, bi)) {
            bv = s;
            bi = i;
        }
    }
    sv[threadIdx.x] = bv;
    si[threadIdx.x] = bi;
    __syncthreads();
    for (int stride = R_THREADS / 2; stride > 0; stride >>= 1) {
        if (threadIdx.x < stride) {
            const int o = threadIdx.x + stride;
            if (better(sv[o], si[o], sv[threadIdx.x], si[threadIdx.x])) {
                sv[threadIdx.x] = sv[o];
                si[threadIdx.x] = si[o];
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) out[r] = si[0];
}

template <typename T>
int launch(const void* x, const void* emb, float* pv, int* pi, int64_t* out, int b, int v, int d, int n_chunks,
           cudaStream_t s) {
    const size_t smem = (static_cast<size_t>(b) * d + 2 * NW * b) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(greedy_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    greedy_chunk_kernel<T><<<n_chunks, NW * 32, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(emb),
                                                           pv, pi, b, v, d, n_chunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    greedy_reduce_kernel<<<b, R_THREADS, 0, s>>>(pv, pi, out, n_chunks);
    return 0;
}

}  // namespace

extern "C" int pmt_greedy_chunk_rows() { return CHUNK; }

// x (B, d); emb (V, d); part_val/part_idx (B, n_chunks) scratch; out (B,) int64.
extern "C" int pmt_greedy_argmax_tied(const void* x, const void* emb, void* part_val, void* part_idx, void* out,
                                      int b, int v, int d, int n_chunks, int dtype, void* stream) {
    cudaStream_t s = pmt::as_stream(stream);
    float* pv = static_cast<float*>(part_val);
    int* pi = static_cast<int*>(part_idx);
    int64_t* o = static_cast<int64_t*>(out);
    int rc = dtype == pmt::DT_F32 ? launch<float>(x, emb, pv, pi, o, b, v, d, n_chunks, s)
                                  : launch<__nv_bfloat16>(x, emb, pv, pi, o, b, v, d, n_chunks, s);
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
}
