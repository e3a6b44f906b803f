// Merged-head scaled dot-product attention, dense or causal, no bias.
//
// Replaces pytorch_models_tpu/ops/encoder_attention.py `encoder_attention`
// (the Pallas flash kernels `_kernel_single` and `_kernel`). q (B, Lq, H*D),
// k/v (B, Lk, H*D) stay in the projections' merged-head layout; the scores
// never reach device memory.
//
// What bounds it on the H100: arithmetic. At GPT-2's L = 1024 it does
// 4 * L^2 * D FLOPs per (row, head) against 3 * L * D elements read, far
// above the memory ridge — so a fast version needs the tensor cores (wgmma),
// which this first kernel does not use yet. The design is a simple flash
// kernel: one block per (q tile of BQ rows, head, batch row), one thread per
// query row holding its q and fp32 accumulator in registers. The block walks
// the key range in tiles of BK keys staged in shared memory as fp32 (every
// thread reads the same key element, a broadcast), with an fp32 online
// softmax per query: scores, tile max, one rescale of the accumulator per
// tile, then P @ V. Causal blocks stop at their last query's position.
// Ragged edges: keys >= Lk are masked and their V rows staged as zeros; query
// rows >= Lq compute nothing. The finite NEG_INF / safe-max rule matches the
// JAX kernel, so a fully masked row yields zeros, not NaN.
#include "common.cuh"

namespace {

constexpr int BQ = 64;  // queries (threads) per block
constexpr int BK = 32;  // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
encoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         T* __restrict__ out, int lq, int lk, int n_heads, float scale, int causal) {
    __shared__ float ks[BK][D];
    __shared__ float vs[BK][D];

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int qi = q0 + threadIdx.x;
    const int hd = n_heads * D;
    const bool active = qi < lq;

    float qv[D], acc[D];
    if (active) {
        const T* qr = q + (static_cast<int64_t>(b) * lq + qi) * hd + h * D;
#pragma unroll
        for (int c = 0; c < D; ++c) qv[c] = pmt::to_f32(qr[c]);
    }
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    float m = pmt::NEG_INF, l = 0.f;

    const int k_end = causal ? min(lk, q0 + BQ) : lk;
    const T* kb = k + static_cast<int64_t>(b) * lk * hd + h * D;
    const T* vb = v + static_cast<int64_t>(b) * lk * hd + h * D;
    for (int kt = 0; kt < k_end; kt += BK) {
        __syncthreads();  // the previous tile's readers are done
        for (int i = threadIdx.x; i < BK * D; i += BQ) {
            const int r = i / D, c = i % D, j = kt + r;
            const bool ok = j < lk;
            ks[r][c] = ok ? pmt::to_f32(kb[static_cast<int64_t>(j) * hd + c]) : 0.f;
            vs[r][c] = ok ? pmt::to_f32(vb[static_cast<int64_t>(j) * hd + c]) : 0.f;
        }
        __syncthreads();
        if (!active) continue;

        float s[BK];
        float mt = pmt::NEG_INF;
#pragma unroll
        for (int r = 0; r < BK; ++r) {
            float dot = 0.f;
#pragma unroll
            for (int c = 0; c < D; ++c) dot += qv[c] * ks[r][c];
            const int j = kt + r;
            const bool ok = j < lk && (!causal || j <= qi);
            s[r] = ok ? dot * scale : pmt::NEG_INF;
            mt = fmaxf(mt, s[r]);
        }
        const float m_new = fmaxf(m, mt);
        const float m_safe = fmaxf(m_new, pmt::NEG_INF / 2);  // fully masked rows stay finite
        const float alpha = expf(m - m_safe);
        l *= alpha;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
        for (int r = 0; r < BK; ++r) {
            const float p = expf(s[r] - m_safe);
            l += p;
#pragma unroll
            for (int c = 0; c < D; ++c) acc[c] += p * vs[r][c];
        }
        m = m_new;
    }

    if (active) {
        const float inv = 1.f / (l == 0.f ? 1.f : l);
        T* orow = out + (static_cast<int64_t>(b) * lq + qi) * hd + h * D;
#pragma unroll
        for (int c = 0; c < D; ++c) orow[c] = pmt::from_f32<T>(acc[c] * inv);
    }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out, int b, int lq, int lk, int n_heads,
            float scale, int causal, cudaStream_t s) {
    dim3 grid((lq + BQ - 1) / BQ, n_heads, b);
    encoder_attention_kernel<T, D><<<grid, BQ, 0, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                       static_cast<const T*>(v), static_cast<T*>(out), lq, lk,
                                                       n_heads, scale, causal);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b, int lq, int lk, int n_heads,
             int head_dim, float scale, int causal, cudaStream_t s) {
    // head_dim 64: every family of the JAX package (another width is one more instantiation)
    if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
    launch<T, 64>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
    return 0;
}

}  // namespace

// q (B, Lq, H*D); k, v (B, Lk, H*D); out (B, Lq, H*D); causal masks j > i.
extern "C" int pmt_encoder_attention(const void* q, const void* k, const void* v, void* out, int b, int lq, int lk,
                                     int n_heads, int head_dim, float scale, int causal, int dtype, void* stream) {
    if (b <= 0 || lq <= 0) return 0;
    cudaStream_t s = pmt::as_stream(stream);
    int rc = dtype == pmt::DT_F32
                 ? dispatch<float>(q, k, v, out, b, lq, lk, n_heads, head_dim, scale, causal, s)
                 : dispatch<__nv_bfloat16>(q, k, v, out, b, lq, lk, n_heads, head_dim, scale, causal, s);
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
}
