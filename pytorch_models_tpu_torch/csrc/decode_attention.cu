// Single-position decode attention against a merged-head KV cache (K2).
//
// Replaces pytorch_models_tpu/ops/decode_attention.py `decode_attention`
// (the Pallas prefix-streaming kernel). Row b, head h attends to cache
// positions [pad[b], end[b]) with an fp32 online softmax; an empty range
// yields zeros (the JAX kernel's `l == 0 -> 1` guard). An optional additive
// fp32 bias in key-major layout, (1, L, H) shared or (B, L, H) per row (T5's
// rel-pos decode bias; the JAX kernel's `bias` operand without its 128-lane
// padding), is added to each score after the q scale, before the softmax.
//
// What bounds it on the H100: bytes. Each step reads the valid K/V prefix
// once (2 * len * H*D * itemsize per row) at ~1 FLOP per byte, far below the
// ~295 FLOP/byte ridge. One query per (row, head) (M = 1) leaves a tensor-core
// tile 15 of 16 rows empty, so what matters is parallelism and bytes in
// flight. The design is a flash-decoding split over a thread-block cluster:
//   - grid (cluster, H, B), a cluster of up to 8 CTAs per (row, head), its
//     size chosen on the host from the grid and L alone (about two waves of
//     the 132 SMs, at least 256 cache slots per CTA), never from ends/pads;
//   - each CTA takes a contiguous slice of the valid keys and streams it in
//     tiles of 64 keys x 64 dims through shared memory, double-buffered with
//     cp.async 16-byte copies (rows XOR-swizzled by 16-byte chunk, so a key
//     per thread and a dim per thread both read without bank conflicts);
//   - one key per thread: a full 64-wide dot from shared memory, no warp
//     reduction per key; an online softmax over the tiles; P @ V with a dim
//     per thread over half the tile's keys;
//   - the CTAs' (m, l, acc[64]) merge by log-sum-exp on rank 0 through
//     distributed shared memory.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NTH = 128;
constexpr int TK = 64;              // keys per tile
constexpr int D = 64;               // head dim
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MIN_SLOTS = 256;      // cache slots per CTA at least
constexpr int WAVE_CTAS = 2 * 132;  // two waves of the H100's SMs

int cluster_size(int b, int l_max, int n_heads) {
    const int units = b * n_heads;
    const int by_grid = std::max(1, (WAVE_CTAS + units - 1) / units);
    const int by_len = std::max(1, (l_max + MIN_SLOTS - 1) / MIN_SLOTS);
    return std::min(MAX_CLUSTER, std::min(by_grid, by_len));
}

// element (key j, dim d) of a swizzled tile row: 16-byte chunk (d / E) ^ (j % 8)
template <typename T>
__device__ __forceinline__ int swz(int j, int d) {
    constexpr int E = 16 / sizeof(T);
    return j * D + (((d / E) ^ (j % 8)) * E) + d % E;
}

template <typename T>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* k, const T* v, int64_t base, int hd, int j0,
                                          int nk) {
    constexpr int E = 16 / sizeof(T), CH = D / E;  // 16-byte chunks per key row
    for (int c = threadIdx.x; c < nk * CH; c += NTH) {
        const int jj = c / CH, ch = c % CH;
        const int64_t g = base + static_cast<int64_t>(j0 + jj) * hd + ch * E;
        const int s = jj * D + ((ch ^ (jj % 8)) * E);
        pmt::cp16(ks + s, k + g);
        pmt::cp16(vs + s, v + g);
    }
}

template <typename T>
__global__ void __launch_bounds__(NTH)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ out, const int* __restrict__ ends, int end_scalar,
                        const int* __restrict__ pads, const float* __restrict__ bias, int bias_bstride, int l_max,
                        int n_heads, float scale, int chunk) {
    constexpr int E = 16 / sizeof(T);
    extern __shared__ __align__(16) char dyn[];
    T* kt = reinterpret_cast<T*>(dyn);  // [2][TK * D] K tiles, then [2][TK * D] V tiles
    T* vt = kt + 2 * TK * D;
    __shared__ float qs[D];
    __shared__ float pt[TK];
    __shared__ float red[2][NTH / 32];
    __shared__ float acc_hi[D];
    __shared__ float mg_m[MAX_CLUSTER], mg_l[MAX_CLUSTER], mg_acc[MAX_CLUSTER][D];  // rank 0: the parts
    cg::cluster_group cluster = cg::this_cluster();
    const int cs = static_cast<int>(gridDim.x), rank = static_cast<int>(blockIdx.x);
    if (cs > 1) pmt::cluster_arrive_relaxed();
    const int h = blockIdx.y, b = blockIdx.z;
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int hd = n_heads * D;
    const int hi = min(ends ? ends[b] : end_scalar, l_max);
    const int lo = pads ? max(pads[b], 0) : 0;
    const int start = max(lo, rank * chunk), stop = min(hi, (rank + 1) * chunk);  // this CTA's keys
    const int n_tiles = start < stop ? (stop - start + TK - 1) / TK : 0;
    const int64_t base = static_cast<int64_t>(b) * l_max * hd + h * D;
    const float* brow = bias ? bias + static_cast<int64_t>(b) * bias_bstride + h : nullptr;  // key j at j * H

    if (n_tiles > 0) load_tile(kt, vt, k, v, base, hd, start, min(TK, stop - start));
    pmt::cp_commit();
    // q scaled in fp32, then rounded to the compute dtype (the JAX kernel's rule)
    if (t < D) qs[t] = pmt::round_to<T>(pmt::to_f32(q[static_cast<int64_t>(b) * hd + h * D + t]) * scale);
    __syncthreads();
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qs[d];

    float m = pmt::NEG_INF, l = 0.f, acc = 0.f;  // acc: dim t % 64 over keys of half t / 64
    const int dcol = t % D, half = t / D;
    for (int i = 0; i < n_tiles; ++i) {
        const int buf = i & 1, j0 = start + i * TK, nk = min(TK, stop - j0);
        // the key's bias is loaded before the tile's wait, off the score's dependent path
        const float bj = brow && t < nk ? __ldg(brow + static_cast<int64_t>(j0 + t) * n_heads) : 0.f;
        if (i + 1 < n_tiles) {
            const int j1 = j0 + TK;
            load_tile(kt + (buf ^ 1) * TK * D, vt + (buf ^ 1) * TK * D, k, v, base, hd, j1, min(TK, stop - j1));
            pmt::cp_commit();
            pmt::cp_wait<1>();
        } else {
            pmt::cp_wait<0>();
        }
        __syncthreads();
        const T* kb = kt + buf * TK * D;
        const T* vb = vt + buf * TK * D;
        // one key per thread: the full 64-wide dot from shared memory
        float s = pmt::NEG_INF;
        if (t < nk) {
            float dot = 0.f;
#pragma unroll
            for (int ch = 0; ch < D / E; ++ch) {
                float kv[E];
                pmt::lds16(kb + t * D + ((ch ^ (t % 8)) * E), kv);
#pragma unroll
                for (int e = 0; e < E; ++e) dot = fmaf(qr[ch * E + e], kv[e], dot);
            }
            s = dot + bj;
        }
        float mx = s;
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (lane == 0) red[0][warp] = mx;
        __syncthreads();
        float m_tile = red[0][0];
        for (int w = 1; w < NTH / 32; ++w) m_tile = fmaxf(m_tile, red[0][w]);
        const float m_new = fmaxf(m, m_tile);
        const float alpha = expf(m - m_new);
        const float p = t < nk ? expf(s - m_new) : 0.f;
        if (t < TK) pt[t] = p;
        float ps = p;
        for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
        if (lane == 0) red[1][warp] = ps;
        __syncthreads();
        float psum = 0.f;
        for (int w = 0; w < NTH / 32; ++w) psum += red[1][w];
        l = l * alpha + psum;
        float a = 0.f;
        for (int jj = half * (TK / 2); jj < min(nk, (half + 1) * (TK / 2)); ++jj)
            a = fmaf(pt[jj], pmt::to_f32(vb[swz<T>(jj, dcol)]), a);
        acc = acc * alpha + a;
        m = m_new;
        __syncthreads();  // the buffer is refilled next
    }
    if (half == 1) acc_hi[dcol] = acc;
    __syncthreads();
    if (cs == 1) {  // a cluster of one (a short cache or a full grid): no merge
        if (t < D)
            out[static_cast<int64_t>(b) * hd + h * D + t] = pmt::from_f32<T>((acc + acc_hi[t]) / (l == 0.f ? 1.f : l));
        return;
    }
    pmt::cluster_wait();  // every CTA of the cluster runs: rank 0's shared memory may be written
    float* r_m = cluster.map_shared_rank(mg_m, 0);
    float* r_l = cluster.map_shared_rank(mg_l, 0);
    float* r_acc = cluster.map_shared_rank(&mg_acc[0][0], 0);
    if (t < D) r_acc[rank * D + t] = acc + acc_hi[t];
    if (t == 0) {
        r_m[rank] = m;
        r_l[rank] = l;
    }
    cluster.sync();
    if (rank != 0 || t >= D) return;
    float mx = pmt::NEG_INF;
    for (int c = 0; c < cs; ++c)
        if (mg_l[c] > 0.f) mx = fmaxf(mx, mg_m[c]);
    float lsum = 0.f, a = 0.f;
    for (int c = 0; c < cs; ++c) {
        if (mg_l[c] == 0.f) continue;  // an empty part weighs nothing
        const float f = expf(mg_m[c] - mx);
        lsum += mg_l[c] * f;
        a += mg_acc[c][t] * f;
    }
    if (lsum == 0.f) lsum = 1.f;  // empty [pad, end): zeros, as the JAX kernel
    out[static_cast<int64_t>(b) * hd + h * D + t] = pmt::from_f32<T>(a / lsum);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, const int* ends, int end_scalar, const int* pads,
           const float* bias, int bias_bstride, int b, int l_max, int n_heads, float scale, cudaStream_t s) {
    const int cs = cluster_size(b, l_max, n_heads);
    const int chunk = (l_max + cs - 1) / cs;
    const int smem = static_cast<int>(4 * TK * D * sizeof(T));  // two K and two V tiles
    static bool attr_set = false;  // above 48 KB (fp32) dynamic shared memory needs the opt-in
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs, n_heads, b);
    cfg.blockDim = dim3(NTH);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T>, static_cast<const T*>(q),
                                       static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
                                       ends, end_scalar, pads, bias, bias_bstride, l_max, n_heads, scale, chunk);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// The cluster size the launch takes for this grid and cache length.
extern "C" int pmt_decode_attention_cluster(int b, int l_max, int n_heads) { return cluster_size(b, l_max, n_heads); }

// q (B, 1, H*D); k, v (B, L, H*D); out (B, 1, H*D). ends/pads: (B,) int32 or
// null (then every row ends at end_scalar / starts at 0). bias: null or fp32
// key-major (., L, H), row b at b * bias_bstride (0: one row shared).
extern "C" int pmt_decode_attention(const void* q, const void* k, const void* v, void* out, const void* ends,
                                    int end_scalar, const void* pads, const void* bias, int bias_bstride, int b,
                                    int l_max, int n_heads, int head_dim, float scale, int dtype, void* stream) {
    // head_dim 64: every decoder of the JAX package (another width is one more instantiation)
    if (head_dim != D) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = pmt::as_stream(stream);
    const int* e = static_cast<const int*>(ends);
    const int* p = static_cast<const int*>(pads);
    const float* bs = static_cast<const float*>(bias);
    if (dtype == pmt::DT_F32)
        return launch<float>(q, k, v, out, e, end_scalar, p, bs, bias_bstride, b, l_max, n_heads, scale, s);
    return launch<__nv_bfloat16>(q, k, v, out, e, end_scalar, p, bs, bias_bstride, b, l_max, n_heads, scale, s);
}
