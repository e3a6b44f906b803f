// Single-position decode attention over an int8 KV cache (K6).
//
// Replaces pytorch_models_tpu/ops/int8_kv.py `int8_decode_attention` (the
// Pallas kernel at its `pl.pallas_call`): one query per row against int8
// K/V caches (B, Lk, H*D) with per-key fp32 scales (B, Lk), over keys
// [pad_b, end_b), optionally folding this step's unquantized K/V in as the
// current position (self-attention decode; the cache holds [0, pos); its K
// quantized by its own row's absmax, or by a per-row scale cur_ks (B,) that
// a tensor-parallel rank holding a width shard takes from the full row), and
// optionally adding a key-major (Lk, H) fp32 bias (T5's rel-pos decode bias;
// at the current position its row ends[0]). The arithmetic is the oracle's,
// spelled out in csrc/int8_attn.cuh (whose sequential unit the fused decode
// step keeps; this kernel shares its helpers).
//
// What bounds it on the H100: bytes. A step reads each valid key's int8 K
// and V once (2 * keys * H*D bytes, half of bf16) plus 8 bytes of scales,
// and does ~4 int8 operations per byte, far below the card's int8 ridge.
// What holds a (row, head) back is parallelism and bytes in flight, so the
// design splits each (row, head)'s 128-key blocks over a thread-block
// cluster of up to 8 CTAs (grid (cluster, H, B)) and merges exactly through
// distributed shared memory:
//   - each CTA owns a contiguous run of the row's blocks [pad/128,
//     ceil(end/128)) and stages their int8 K, V and scales into shared
//     memory with cp.async 16-byte copies, all issued up front (K first);
//   - scores by __dp4a (exact in int32), four threads per key, and each
//     block's max, which goes to rank 0's shared memory;
//   - after a cluster barrier every CTA reads the prefix max of the earlier
//     blocks: max is exact, so these are the very running maxima of the
//     sequential walk, and each block computes its own p, alpha, sum p, its
//     absmax and int8 levels and its int32 P @ V from shared memory, and
//     writes (m_new, alpha, sum, ps, pv[64]) to rank 0;
//   - after a second barrier rank 0 folds the blocks in ascending order,
//     acc = acc * alpha + ps * pv, l = alpha * l + sum, as the oracle does,
//     then the current position and the output.
// A row longer than one round's 16 blocks walks rounds; rank 0 carries the
// running max from round to round, and its record buffers alternate, so a
// round needs two cluster barriers. Blocks outside [pad, end) are skipped
// (the oracle gives them p_i8 = 0 and alpha 0 before the range, 1 after it);
// a CTA with no block still joins every barrier. The cluster size comes
// from Lk and the grid alone (about four waves of the 132 SMs), never from
// ends/pads, so the launch reads nothing back from the device.
// M = 1 (one query per (row, head)): a tensor-core tile would waste 15 of
// its 16 rows, and the bound is bytes; P @ V is int32 multiply-adds from
// shared memory.
#include <cooperative_groups.h>

#include <algorithm>

#include "int8_attn.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NTH = 256;
constexpr int BK = pmt::I8_BK;      // keys per quantization block
constexpr int D = pmt::I8_D;        // head dim
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int ROUND_BLOCKS = 16;    // blocks of one round over the cluster (rank 0's records)
constexpr int MAX_OWN = 4;          // blocks a CTA stages per round
constexpr int WAVE_CTAS = 4 * 132;  // four waves of the H100's SMs

struct Stage {  // one owned block, in dynamic shared memory
    int8_t k[BK * D];
    int8_t v[BK * D];
    float ks[BK];
    float vs[BK];
    float sc[BK];  // scores
    int8_t pi[BK];  // int8 probabilities
};

struct Records {  // one round's per-block records, in rank 0's shared memory
    float bmax[ROUND_BLOCKS];
    float st[ROUND_BLOCKS][4];  // m_new, alpha, sum p, ps
    int pv[ROUND_BLOCKS][D];
};

// The launch plan: cluster size and blocks a CTA stages per round, from the
// grid and Lk alone.
void plan(int b, int l_k, int n_heads, int* cluster, int* own) {
    const int n_blk = l_k / BK;
    const int units = b * n_heads;
    int cs = std::min(MAX_CLUSTER, std::max(1, (WAVE_CTAS + units - 1) / units));
    cs = std::min(cs, std::max(n_blk, 1));
    int r = std::min((n_blk + cs - 1) / cs, std::min(MAX_OWN, ROUND_BLOCKS / cs));
    r = std::max(r, 1);
    *cluster = std::min(cs, std::max(1, (n_blk + r - 1) / r));
    *own = r;
}

template <typename T>
__global__ void __launch_bounds__(NTH)
int8_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
                      const float* __restrict__ ks, const float* __restrict__ vs, const int* __restrict__ ends,
                      int end_scalar, const int* __restrict__ pads, const T* __restrict__ cur_k,
                      const T* __restrict__ cur_v, const float* __restrict__ cur_ks, const float* __restrict__ bias,
                      T* __restrict__ out, int l_k,
                      int n_heads, float scale, int own) {
    extern __shared__ __align__(16) char dyn[];
    __shared__ Records rec[2];
    __shared__ float m_run;  // rank 0: the running max after the folded rounds
    __shared__ float bm[ROUND_BLOCKS];
    __shared__ int qi[D];
    __shared__ float red[2 * (NTH / 32)];
    __shared__ int pvp[4][D];
    cg::cluster_group cluster = cg::this_cluster();
    pmt::cluster_arrive_relaxed();  // every CTA has started once the matching wait returns

    Stage* stage = reinterpret_cast<Stage*>(dyn);
    const int cs = static_cast<int>(gridDim.x), rank = static_cast<int>(blockIdx.x);
    const int h = blockIdx.y, b = blockIdx.z;
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int hd = n_heads * D;
    const int hi = min(ends ? ends[b] : end_scalar, l_k);
    const int lo = pads ? max(pads[b], 0) : 0;
    const int first = lo / BK, n_row = max((hi + BK - 1) / BK - first, 0);  // the row's blocks
    const int64_t row = static_cast<int64_t>(b) * l_k;
    const int8_t* kbase = kq + row * hd + h * D;
    const int8_t* vbase = vq + row * hd + h * D;
    Records* rec0 = cluster.map_shared_rank(&rec[0], 0);
    float* m_run0 = cluster.map_shared_rank(&m_run, 0);

    // q, quantized per (row, head): every CTA computes the same levels
    float qv = 0.f;
    if (t < D) qv = __fmul_rn(pmt::ldcg_f(q + static_cast<int64_t>(b) * hd + h * D + t), scale);
    const float sq = pmt::i8_scale(pmt::i8_block_max<NTH>(t < D ? fabsf(qv) : 0.f, red));
    if (t < D) qi[t] = pmt::i8_level(qv, sq);
    if (rank == 0 && t == 0) m_run = pmt::NEG_INF;
    __syncthreads();
    int qpk[4];  // this thread's 16 q levels as packed bytes (four threads per key)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        const int c = (t % 4) * 16 + w * 4;
        unsigned u = 0;
        for (int e = 0; e < 4; ++e) u |= (static_cast<unsigned>(qi[c + e]) & 0xffu) << (8 * e);
        qpk[w] = static_cast<int>(u);
    }

    // spread the row's blocks evenly: `per` blocks per CTA per round
    const int per = n_row > 0 ? min(own, (n_row + cs - 1) / cs) : 1;
    const int per_round = cs * per;
    const int rounds = (n_row + per_round - 1) / per_round;
    float acc = 0.f, l = 0.f, m = pmt::NEG_INF;  // rank 0's fold (acc: column t < 64)
    bool waited = false;
    for (int round = 0; round < rounds; ++round) {
        Records& rr = rec0[round & 1];
        const int r_first = first + round * per_round;                   // the round's first block
        const int n_round = min(per_round, first + n_row - r_first);     // blocks in this round
        const int mine0 = rank * per;                                    // my first block, round-local
        const int n_mine = max(0, min(per, n_round - mine0));
        // 1. stage K (+ scales), then V (+ scales), all copies in flight at once
        for (int i = 0; i < n_mine; ++i) {
            const int j0 = (r_first + mine0 + i) * BK;
            for (int c = t; c < BK * 4; c += NTH)
                pmt::cp16(stage[i].k + c * 16, kbase + static_cast<int64_t>(j0 + c / 4) * hd + (c % 4) * 16);
            if (t < BK / 4) pmt::cp16(stage[i].ks + t * 4, ks + row + j0 + t * 4);
        }
        pmt::cp_commit();
        for (int i = 0; i < n_mine; ++i) {
            const int j0 = (r_first + mine0 + i) * BK;
            for (int c = t; c < BK * 4; c += NTH)
                pmt::cp16(stage[i].v + c * 16, vbase + static_cast<int64_t>(j0 + c / 4) * hd + (c % 4) * 16);
            if (t < BK / 4) pmt::cp16(stage[i].vs + t * 4, vs + row + j0 + t * 4);
        }
        pmt::cp_commit();
        pmt::cp_wait<1>();
        __syncthreads();
        // 2. scores, four threads per key, 16 bytes each; NEG_INF outside [lo, hi)
        for (int i = 0; i < n_mine; ++i) {
            const int j0 = (r_first + mine0 + i) * BK;
            for (int k0 = 0; k0 < BK; k0 += NTH / 4) {
                const int kk = k0 + t / 4, j = j0 + kk;
                const int4 kv = *reinterpret_cast<const int4*>(stage[i].k + kk * D + (t % 4) * 16);
                int dot = __dp4a(kv.x, qpk[0], 0);
                dot = __dp4a(kv.y, qpk[1], dot);
                dot = __dp4a(kv.z, qpk[2], dot);
                dot = __dp4a(kv.w, qpk[3], dot);
                dot += __shfl_xor_sync(0xffffffffu, dot, 1);
                dot += __shfl_xor_sync(0xffffffffu, dot, 2);
                if (t % 4 == 0) {
                    float s = pmt::NEG_INF;
                    if (j >= lo && j < hi) {
                        s = __fmul_rn(__fmul_rn(__int2float_rn(dot), stage[i].ks[kk]), sq);
                        if (bias) s = __fadd_rn(s, __ldg(bias + static_cast<int64_t>(j) * n_heads + h));
                    }
                    stage[i].sc[kk] = s;
                }
            }
        }
        __syncthreads();
        if (!waited) {
            pmt::cluster_wait();  // every CTA of the cluster runs: its shared memory may be written
            waited = true;
        }
        // block maxima to rank 0: warp i reduces block i
        if (warp < n_mine) {
            float v = pmt::NEG_INF;
            for (int kk = lane; kk < BK; kk += 32) v = fmaxf(v, stage[warp].sc[kk]);
            for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
            if (lane == 0) rr.bmax[mine0 + warp] = v;
        }
        cluster.sync();  // barrier 1: the round's block maxima and the running max are in
        if (t < n_round) bm[t] = rr.bmax[t];
        const float m_before = *m_run0;
        pmt::cp_wait<0>();
        __syncthreads();
        // 3. per block: p against its running max, its levels, sum p; two blocks per pass
        for (int i0 = 0; i0 < n_mine; i0 += 2) {
            const int i = i0 + t / BK, kk = t % BK;
            const bool live = i < n_mine;
            float p = 0.f, pe = 0.f, m_prev = pmt::NEG_INF, m_new = pmt::NEG_INF, m_safe = 0.f;
            if (live) {
                m_prev = m_before;
                for (int k = 0; k < mine0 + i; ++k) m_prev = fmaxf(m_prev, bm[k]);
                m_new = fmaxf(m_prev, bm[mine0 + i]);
                m_safe = fmaxf(m_new, pmt::NEG_INF / 2);
                const int j = (r_first + mine0 + i) * BK + kk;
                p = expf(stage[i].sc[kk] - m_safe);
                pe = j < hi && j >= lo ? __fmul_rn(p, stage[i].vs[kk]) : 0.f;  // masked keys: p is 0
            }
            float ps_sum = p, pe_max = fabsf(pe);
            for (int o = 16; o > 0; o >>= 1) {
                ps_sum += __shfl_xor_sync(0xffffffffu, ps_sum, o);
                pe_max = fmaxf(pe_max, __shfl_xor_sync(0xffffffffu, pe_max, o));
            }
            if (lane == 0) {
                red[warp] = ps_sum;
                red[NTH / 32 + warp] = pe_max;
            }
            __syncthreads();
            if (live) {
                const int w0 = (t / BK) * (BK / 32);  // the block's four warps
                float sum = 0.f, pm = 0.f;
                for (int w = 0; w < BK / 32; ++w) {
                    sum += red[w0 + w];
                    pm = fmaxf(pm, red[NTH / 32 + w0 + w]);
                }
                const float ps = pmt::i8_scale(pm);
                stage[i].pi[kk] = static_cast<int8_t>(pmt::i8_level(pe, ps));
                if (kk == 0) {
                    float* s4 = rr.st[mine0 + i];
                    s4[0] = m_new;
                    s4[1] = expf(m_prev - m_safe);  // alpha
                    s4[2] = sum;
                    s4[3] = ps;
                }
            }
            __syncthreads();
        }
        // 4. int32 P @ V per block from shared memory: 64 columns x 4 quarters of 32 keys
        for (int i = 0; i < n_mine; ++i) {
            const int c = t % D, part = t / D;
            const int8_t* pi = stage[i].pi + part * 32;
            const int8_t* vc = stage[i].v + part * 32 * D + c;
            int pv = 0;
#pragma unroll 8
            for (int jj = 0; jj < 32; ++jj) pv += static_cast<int>(pi[jj]) * static_cast<int>(vc[jj * D]);
            pvp[part][c] = pv;
            __syncthreads();
            if (t < D) rr.pv[mine0 + i][t] = pvp[0][t] + pvp[1][t] + pvp[2][t] + pvp[3][t];
            __syncthreads();
        }
        cluster.sync();  // barrier 2: the round's records are in
        if (rank == 0) {  // the ordered fold, one step per block, as the oracle's walk
            for (int k = 0; k < n_round; ++k) {
                const float alpha = rr.st[k][1];
                if (t < D) acc = __fadd_rn(__fmul_rn(acc, alpha), __fmul_rn(rr.st[k][3], __int2float_rn(rr.pv[k][t])));
                l = __fadd_rn(__fmul_rn(alpha, l), rr.st[k][2]);
                m = rr.st[k][0];
            }
            if (t == 0) m_run = m;  // read by the next round after its barrier 1
        }
    }
    if (!waited) pmt::cluster_wait();
    if (rank != 0) return;  // nothing reads a peer's shared memory from here on

    if (cur_k) {
        // this step's K, quantized with the cache-write rule: absmax over the whole H*D row, or, on a
        // tensor-parallel rank that holds a width shard of the row, the full row's scale passed in (cur_ks)
        const T* kr = cur_k + static_cast<int64_t>(b) * hd;
        float kc_s;
        if (cur_ks) {
            kc_s = cur_ks[b];
        } else {
            float am = 0.f;
            for (int c = t; c < hd; c += NTH) am = fmaxf(am, fabsf(pmt::ldcg_f(kr + c)));
            kc_s = pmt::i8_scale(pmt::i8_block_max<NTH>(am, red));
        }
        const int kl = t < D ? pmt::i8_level(pmt::ldcg_f(kr + h * D + t), kc_s) : 0;
        const int dot = pmt::i8_block_isum<NTH>(t < D ? kl * qi[t] : 0, red);
        float s_cur = __fmul_rn(__fmul_rn(__int2float_rn(dot), kc_s), sq);
        if (bias) {
            const int cur_pos = ends ? ends[0] : end_scalar;  // the oracle's bias row of the current position
            s_cur = __fadd_rn(s_cur, bias[static_cast<int64_t>(cur_pos) * n_heads + h]);
        }
        const float m_new = fmaxf(m, s_cur);
        const float p_cur = expf(s_cur - m_new), alpha = expf(m - m_new);
        l = __fadd_rn(__fmul_rn(alpha, l), p_cur);
        const T* vr = cur_v + static_cast<int64_t>(b) * hd + h * D;
        if (t < D) acc = __fadd_rn(__fmul_rn(acc, alpha), __fmul_rn(p_cur, pmt::ldcg_f(vr + t)));
    } else if (l == 0.f) {
        l = 1.f;
    }
    if (t < D) out[static_cast<int64_t>(b) * hd + h * D + t] = pmt::from_f32<T>(__fdiv_rn(acc, l));
}

template <typename T>
int launch(const void* q, const int8_t* kq, const int8_t* vq, const float* ks, const float* vs, const int* ends,
           int end_scalar, const int* pads, const void* cur_k, const void* cur_v, const float* cur_ks, const float* bias,
           void* out, int b,
           int l_k, int n_heads, float scale, cudaStream_t s) {
    int cs, own;
    plan(b, l_k, n_heads, &cs, &own);
    const size_t smem = static_cast<size_t>(own) * sizeof(Stage);
    static bool attr_set = false;  // above 48 KB dynamic shared memory needs the opt-in, once per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(int8_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(MAX_OWN * sizeof(Stage)));
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
    cudaError_t e = cudaLaunchKernelEx(&cfg, int8_attention_kernel<T>, static_cast<const T*>(q), kq, vq, ks, vs, ends,
                                       end_scalar, pads, static_cast<const T*>(cur_k), static_cast<const T*>(cur_v),
                                       cur_ks, bias, static_cast<T*>(out), l_k, n_heads, scale, own);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// The cluster size the launch takes for this grid and cache length.
extern "C" int pmt_int8_attention_cluster(int b, int l_k, int n_heads) {
    int cs, own;
    plan(b, l_k, n_heads, &cs, &own);
    return cs;
}

extern "C" int pmt_int8_attention(const void* q, const void* kq, const void* vq, const void* ks, const void* vs,
                                  const void* ends, int end_scalar, const void* pads, const void* cur_k,
                                  const void* cur_v, const void* cur_ks, const void* bias, void* out, int b, int l_k,
                                  int n_heads,
                                  float scale, int dtype, void* stream) {
    auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
    auto f32 = [](const void* p) { return static_cast<const float*>(p); };
    auto i32 = [](const void* p) { return static_cast<const int*>(p); };
    const cudaStream_t s = pmt::as_stream(stream);
    if (dtype == pmt::DT_F32)
        return launch<float>(q, i8(kq), i8(vq), f32(ks), f32(vs), i32(ends), end_scalar, i32(pads), cur_k, cur_v,
                             f32(cur_ks), f32(bias), out, b, l_k, n_heads, scale, s);
    return launch<__nv_bfloat16>(q, i8(kq), i8(vq), f32(ks), f32(vs), i32(ends), end_scalar, i32(pads), cur_k, cur_v,
                                 f32(cur_ks), f32(bias), out, b, l_k, n_heads, scale, s);
}
