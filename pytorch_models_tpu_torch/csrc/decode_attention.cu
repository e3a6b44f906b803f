// Single-position decode attention against a merged-head KV cache.
//
// Replaces pytorch_models_tpu/ops/decode_attention.py `decode_attention`
// (the Pallas prefix-streaming kernel). Row b, head h attends to cache
// positions [pad[b], end[b]) with an fp32 online softmax; an empty range
// yields zeros (the JAX kernel's `l == 0 -> 1` guard). An optional additive
// fp32 bias in key-major layout, (1, L, H) shared or (B, L, H) per row (T5's
// rel-pos decode bias; the JAX kernel's `bias` operand without its 128-lane
// padding), is added to each score after the q scale, before the softmax:
// the warp's lanes read the key's one float together (one broadcast load).
//
// What bounds it on the H100: bytes. Each step reads the valid K/V prefix
// once (2 * len * H*D * itemsize per row) and does 2 FLOPs per byte-ish —
// far below the ~295 FLOP/byte ridge. The design streams only the valid
// range (never the padded cache tail), one block per (head, row) with 8
// warps; each warp walks every 8th key, a lane holding D/32 contiguous
// elements of q, k, v and the accumulator, so a warp reads a key's head
// slice as one contiguous run. Per-warp (max, sum, acc) states merge through
// shared memory at the end. Simple by design: no tensor cores and no async
// copies yet.
#include "common.cuh"

namespace {

constexpr int NW = 8;  // warps per block

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ out, const int* __restrict__ ends, int end_scalar,
                        const int* __restrict__ pads, const float* __restrict__ bias, int bias_bstride, int l_max,
                        int n_heads, float scale) {
    constexpr int E = D / 32;  // elements per lane
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int hd = n_heads * D;

    int end = ends ? ends[b] : end_scalar;
    int pad = pads ? pads[b] : 0;
    end = min(end, l_max);
    pad = max(pad, 0);

    // q scaled in fp32, then rounded to the compute dtype (the JAX kernel's rule)
    float qv[E];
    const T* qrow = q + static_cast<int64_t>(b) * hd + h * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) qv[e] = pmt::round_to<T>(pmt::to_f32(qrow[e]) * scale);

    float m = pmt::NEG_INF, l = 0.f, acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;

    const int64_t base = static_cast<int64_t>(b) * l_max * hd + h * D + lane * E;
    const float* brow = bias ? bias + static_cast<int64_t>(b) * bias_bstride + h : nullptr;  // key j at j * H
    for (int j = pad + warp; j < end; j += NW) {
        const T* kr = k + base + static_cast<int64_t>(j) * hd;
        const T* vr = v + base + static_cast<int64_t>(j) * hd;
        // the key's bias is loaded with its K/V, off the score's dependent path
        const float bj = brow ? __ldg(brow + static_cast<int64_t>(j) * n_heads) : 0.f;
        float kv[E], vv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
            kv[e] = pmt::to_f32(kr[e]);
            vv[e] = pmt::to_f32(vr[e]);
        }
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += qv[e] * kv[e];
        s = pmt::warp_sum(s) + bj;
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        l = l * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = acc[e] * alpha + p * vv[e];
        m = m_new;
    }

    __shared__ float sm_m[NW], sm_l[NW];
    __shared__ float sm_acc[NW][D];
    if (lane == 0) {
        sm_m[warp] = m;
        sm_l[warp] = l;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
    __syncthreads();

    for (int c = threadIdx.x; c < D; c += blockDim.x) {
        float mx = pmt::NEG_INF;
#pragma unroll
        for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w]);
        float lsum = 0.f, a = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float f = sm_l[w] > 0.f ? expf(sm_m[w] - mx) : 0.f;  // empty warps weigh nothing
            lsum += sm_l[w] * f;
            a += sm_acc[w][c] * f;
        }
        if (lsum == 0.f) lsum = 1.f;  // empty [pad, end): zeros, as the JAX kernel
        out[static_cast<int64_t>(b) * hd + h * D + c] = pmt::from_f32<T>(a / lsum);
    }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, const int* ends, int end_scalar,
             const int* pads, const float* bias, int bias_bstride, int b, int l_max, int n_heads, int head_dim,
             float scale, cudaStream_t s) {
    // head_dim 64: every family of the JAX package (another width is one more instantiation)
    if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
    decode_attention_kernel<T, 64><<<dim3(n_heads, b), NW * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
        ends, end_scalar, pads, bias, bias_bstride, l_max, n_heads, scale);
    return 0;
}

}  // namespace

// q (B, 1, H*D); k, v (B, L, H*D); out (B, 1, H*D). ends/pads: (B,) int32 or
// null (then every row ends at end_scalar / starts at 0). bias: null or fp32
// key-major (., L, H), row b at b * bias_bstride (0: one row shared).
extern "C" int pmt_decode_attention(const void* q, const void* k, const void* v, void* out, const void* ends,
                                    int end_scalar, const void* pads, const void* bias, int bias_bstride, int b,
                                    int l_max, int n_heads, int head_dim, float scale, int dtype, void* stream) {
    cudaStream_t s = pmt::as_stream(stream);
    const int* e = static_cast<const int*>(ends);
    const int* p = static_cast<const int*>(pads);
    const float* bs = static_cast<const float*>(bias);
    int rc = dtype == pmt::DT_F32
                 ? dispatch<float>(q, k, v, out, e, end_scalar, p, bs, bias_bstride, b, l_max, n_heads, head_dim,
                                   scale, s)
                 : dispatch<__nv_bfloat16>(q, k, v, out, e, end_scalar, p, bs, bias_bstride, b, l_max, n_heads,
                                           head_dim, scale, s);
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
}
