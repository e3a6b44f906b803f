// One (row, head) of single-position attention over an int8 KV cache: the
// arithmetic of pytorch_models_tpu/ops/int8_kv.py (`_kernel`, pinned by its
// `_int8_attention_oracle_impl`): the sequential unit of the fused decode
// step's int8 attention phases (csrc/decode_step.cu); the per-op kernel
// (csrc/int8_kv.cu) splits the same arithmetic over a cluster and shares the
// helpers.
//
// The arithmetic, in the oracle's order (every f32 product and sum is
// rounded on its own: __fmul_rn / __fadd_rn keep nvcc from contracting a
// product and a sum into one fma, which the oracle never does):
//   q: qs = f32(q) * scale; sq = (absmax == 0 ? 1 : absmax) * (1/127) over
//      the head's 64 values; q_i8 = clip(rint(qs / sq), -127, 127);
//   keys in 128-key blocks from lo/128 to ceil(hi/128), in ascending order:
//      s = (f32(dot_i32(k_i8, q_i8)) * k_s[j]) * sq [+ bias[j, h]], NEG_INF
//      outside [lo, hi); m_new = max(m, max s); m_safe = max(m_new, NEG_INF/2);
//      p = exp(s - m_safe); alpha = exp(m - m_safe); l = alpha * l + sum p;
//      p_eff = p * v_s[j] quantized per block against its own absmax (ps);
//      acc = acc * alpha + ps * f32(dot_i32(p_i8, v_i8)); m = m_new.
//   The probabilities are quantized per 128-key block against the running
//   max, so the block boundaries are part of the result: a unit walks its
//   blocks in order. Within a chunk of NTH keys the scores, the blocks'
//   maxima, p and the int8 P @ V run in parallel (the running max of a block
//   is a prefix max over the chunk's block maxima); only the (acc, l, m)
//   fold is sequential, one step per block.
//   current position (self-attention): K quantized with the cache-write rule
//      (absmax over the whole H*D row), scored like a cached key [+ its
//      bias], V in full precision: m_new = max(m, s); p = exp(s - m_new);
//      alpha = exp(m - m_new); l = alpha * l + p; acc = acc * alpha + p * v.
//   out = acc / (l == 0 ? 1 : l): an empty range gives zeros.
// Int8 dot products are exact in int32 (__dp4a for the scores). The only
// sums whose order differs from the oracle's are the blocks' sum of p (an
// fp32 rounding of l): the int8 levels themselves depend only on elementwise
// values.
#pragma once

#include "common.cuh"

namespace pmt {

constexpr int I8_BK = 128;  // keys per quantization block
constexpr int I8_D = 64;    // head dim served

__device__ __forceinline__ float i8_scale(float absmax) {
    return __fmul_rn(absmax == 0.f ? 1.f : absmax, 1.0f / 127.0f);
}
__device__ __forceinline__ int i8_level(float x, float s) {
    return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
}

template <typename T>
__device__ __forceinline__ float ldcg_f(const T* p);
template <>
__device__ __forceinline__ float ldcg_f<float>(const float* p) { return __ldcg(p); }
template <>
__device__ __forceinline__ float ldcg_f<__nv_bfloat16>(const __nv_bfloat16* p) {
    return __uint_as_float(static_cast<unsigned>(__ldcg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// shared memory the unit needs, in bytes
template <int NTH>
__host__ __device__ constexpr int i8_unit_smem() {
    return NTH * 4 + NTH + 4 * I8_D + (NTH / 32) * 8 * 4 + (NTH / I8_BK) * (8 * 4 + 2 * I8_D * 4) + 64;
}

struct I8Cur {                // the current position of a self-attention step
    const void* k;            // (H*D) row of this step's K, compute dtype
    const void* v;            // the head's 64 values of this step's V
    float bias;               // its bias, 0 without one
    int8_t* kq_out;           // if set: the quantized K head slice is written here (cache slot pos)
    int8_t* vq_out;           // and V's
    float* ks_out;            // if set: the K / V row scales at pos (one unit per row writes them)
    float* vs_out;
};

// Block-wide reductions over NTH threads through `red` (NTH/32 floats);
// every thread gets the result.
template <int NTH>
__device__ __forceinline__ float i8_block_max(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    __syncthreads();
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    float r = red[0];
    for (int w = 1; w < NTH / 32; ++w) r = fmaxf(r, red[w]);
    return r;
}
template <int NTH>
__device__ __forceinline__ int i8_block_isum(int v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    __syncthreads();
    if (threadIdx.x % 32 == 0) reinterpret_cast<int*>(red)[threadIdx.x / 32] = v;
    __syncthreads();
    int r = 0;
    for (int w = 0; w < NTH / 32; ++w) r += reinterpret_cast<int*>(red)[w];
    return r;
}

// One unit: head h of one row. `q` points at the head's 64 values; `kq`/`vq`
// at the head's slice of key 0 of the row's (Lk, H*D) int8 cache; `ks`/`vs`
// at the row's (Lk,) scales; keys [lo, hi) are valid; `bias`: key-major
// (Lk, H) fp32 with `bias_h` = h, or null; `cur`: the current position, or
// null. Writes the head's 64 outputs (compute dtype) to `out`. All NTH
// threads must call it; `smem` holds i8_unit_smem<NTH>() bytes.
template <typename T, int NTH>
__device__ void i8_attention_unit(const T* q, float scale, const int8_t* kq, const int8_t* vq, const float* ks,
                                  const float* vs, int hd, int lo, int hi, const float* bias, int n_heads, int bias_h,
                                  const I8Cur* cur, T* out, char* smem) {
    static_assert(NTH % I8_BK == 0 && NTH >= 2 * I8_D, "whole blocks per chunk");
    constexpr int NB = NTH / I8_BK;  // blocks per chunk
    constexpr int NWU = NTH / 32;
    const int t = threadIdx.x;
    float* sc = reinterpret_cast<float*>(smem);                 // (NTH) scores
    int8_t* pi = reinterpret_cast<int8_t*>(sc + NTH);           // (NTH) int8 probabilities
    int* qi = reinterpret_cast<int*>(pi + NTH);                 // (64) q_i8 as int
    float* wr = reinterpret_cast<float*>(qi + I8_D);            // (NWU, 8) warp partials
    float* bst = wr + NWU * 8;                                  // (NB, 8) block stats
    int* pvp = reinterpret_cast<int*>(bst + NB * 8);            // (NB, 2, 64) P @ V halves

    // ---- q, quantized per (row, head)
    float qv = 0.f;
    if (t < I8_D) qv = __fmul_rn(ldcg_f(q + t), scale);
    const float sq = i8_scale(i8_block_max<NTH>(t < I8_D ? fabsf(qv) : 0.f, wr));
    if (t < I8_D) qi[t] = i8_level(qv, sq);
    __syncthreads();
    int qpk[4];  // this thread's 16 q levels as packed bytes, for __dp4a (4 threads per key)
    {
        const int part = t % 4;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const int c = part * 16 + w * 4;
            unsigned u = 0;
            for (int e = 0; e < 4; ++e) u |= (static_cast<unsigned>(qi[c + e]) & 0xffu) << (8 * e);
            qpk[w] = static_cast<int>(u);
        }
    }

    float m = NEG_INF, l = 0.f, acc = 0.f;  // acc: column t (t < 64)
    const int first = max(lo, 0) / I8_BK, n_blk = (hi + I8_BK - 1) / I8_BK;
    for (int c0 = first * I8_BK; c0 < n_blk * I8_BK; c0 += NTH) {
        const int nb = min(NB, n_blk - c0 / I8_BK);
        // scores: four threads per key, 16 bytes each
        for (int k0 = 0; k0 < nb * I8_BK; k0 += NTH / 4) {
            const int kk = k0 + t / 4, j = c0 + kk;
            int dot = 0;
            const bool ok = kk < nb * I8_BK && j >= lo && j < hi;
            if (ok) {
                const int4 kv = __ldcg(reinterpret_cast<const int4*>(kq + static_cast<int64_t>(j) * hd + (t % 4) * 16));
                dot = __dp4a(kv.x, qpk[0], dot);
                dot = __dp4a(kv.y, qpk[1], dot);
                dot = __dp4a(kv.z, qpk[2], dot);
                dot = __dp4a(kv.w, qpk[3], dot);
            }
            dot += __shfl_xor_sync(0xffffffffu, dot, 1);
            dot += __shfl_xor_sync(0xffffffffu, dot, 2);
            if (kk < nb * I8_BK && t % 4 == 0) {
                float s = NEG_INF;
                if (ok) {
                    s = __fmul_rn(__fmul_rn(__int2float_rn(dot), __ldcg(ks + j)), sq);
                    if (bias) s = __fadd_rn(s, __ldg(bias + static_cast<int64_t>(j) * n_heads + bias_h));
                }
                sc[kk] = s;
            }
        }
        __syncthreads();
        // thread t owns key c0 + t, of block kb = t / 128 (4 warps per block)
        const int kb = t / I8_BK, j = c0 + t;
        const bool live = kb < nb;
        const float s = live ? sc[t] : NEG_INF;
        float v = s;
        for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (t % 32 == 0) wr[(t / 32) * 8] = v;
        __syncthreads();
        // the block's max, then its running max: a prefix over the chunk's blocks
        float m_prev = m, m_new = m;
        for (int i = 0; i <= min(kb, nb - 1); ++i) {
            float bm = wr[(i * 4) * 8];
            for (int w = 1; w < 4; ++w) bm = fmaxf(bm, wr[(i * 4 + w) * 8]);
            m_prev = m_new;
            m_new = fmaxf(m_new, bm);
        }
        const float m_safe = fmaxf(m_new, NEG_INF / 2);
        float p = 0.f, pe = 0.f;
        if (live) {
            p = expf(s - m_safe);
            pe = j < hi && j >= lo ? __fmul_rn(p, __ldcg(vs + j)) : 0.f;  // masked keys: p is 0
        }
        float ps_sum = p, pe_max = fabsf(pe);
        for (int o = 16; o > 0; o >>= 1) {
            ps_sum += __shfl_xor_sync(0xffffffffu, ps_sum, o);
            pe_max = fmaxf(pe_max, __shfl_xor_sync(0xffffffffu, pe_max, o));
        }
        if (t % 32 == 0) {
            wr[(t / 32) * 8 + 1] = ps_sum;
            wr[(t / 32) * 8 + 2] = pe_max;
        }
        __syncthreads();
        if (live && t % I8_BK == 0) {  // one thread per block: its stats
            float sum = 0.f, pm = 0.f;
            for (int w = 0; w < 4; ++w) {
                sum += wr[(kb * 4 + w) * 8 + 1];
                pm = fmaxf(pm, wr[(kb * 4 + w) * 8 + 2]);
            }
            bst[kb * 8 + 0] = m_new;
            bst[kb * 8 + 1] = expf(m_prev - m_safe);  // alpha
            bst[kb * 8 + 2] = sum;
            bst[kb * 8 + 3] = i8_scale(pm);           // ps
        }
        __syncthreads();
        if (live) pi[t] = static_cast<int8_t>(i8_level(pe, bst[kb * 8 + 3]));
        __syncthreads();
        // int8 P @ V: per block, 128 threads = 64 columns x 2 halves of 64 keys
        if (live) {
            const int c = t % I8_D, half = (t % I8_BK) / I8_D;
            int pv = 0;
            const int jb = kb * I8_BK + half * I8_D;
            for (int jj = 0; jj < I8_D; ++jj) {
                const int pj = pi[jb + jj];
                const int jk = c0 + jb + jj;
                if (pj != 0) pv += pj * static_cast<int>(__ldcg(reinterpret_cast<const signed char*>(
                                                 vq + static_cast<int64_t>(jk) * hd + c)));
            }
            pvp[(kb * 2 + half) * I8_D + c] = pv;
        }
        __syncthreads();
        // the sequential fold, one step per block
        for (int i = 0; i < nb; ++i) {
            const float alpha = bst[i * 8 + 1];
            if (t < I8_D) {
                const int pv = pvp[(i * 2) * I8_D + t] + pvp[(i * 2 + 1) * I8_D + t];
                acc = __fadd_rn(__fmul_rn(acc, alpha), __fmul_rn(bst[i * 8 + 3], __int2float_rn(pv)));
            }
            l = __fadd_rn(__fmul_rn(alpha, l), bst[i * 8 + 2]);
            m = bst[i * 8 + 0];
        }
        __syncthreads();
    }

    if (cur) {
        // this step's K, quantized with the cache-write rule: absmax over the whole H*D row
        const T* kr = static_cast<const T*>(cur->k);
        float am = 0.f;
        for (int c = t; c < hd; c += NTH) am = fmaxf(am, fabsf(ldcg_f(kr + c)));
        const float kc_s = i8_scale(i8_block_max<NTH>(am, wr));
        const int h_off = bias_h * I8_D;
        int kl = 0;
        if (t < I8_D) kl = i8_level(ldcg_f(kr + h_off + t), kc_s);
        const int dot = i8_block_isum<NTH>(t < I8_D ? kl * qi[t] : 0, wr);
        float s_cur = __fmul_rn(__fmul_rn(__int2float_rn(dot), kc_s), sq);
        s_cur = __fadd_rn(s_cur, cur->bias);
        const float m_new = fmaxf(m, s_cur);
        const float p_cur = expf(s_cur - m_new), alpha = expf(m - m_new);
        l = __fadd_rn(__fmul_rn(alpha, l), p_cur);
        const T* vr = static_cast<const T*>(cur->v);
        if (t < I8_D) acc = __fadd_rn(__fmul_rn(acc, alpha), __fmul_rn(p_cur, ldcg_f(vr + t)));
        if (cur->kq_out) {  // the cache write at pos: K and V quantized per row
            if (t < I8_D) cur->kq_out[t] = static_cast<int8_t>(kl);
            const T* vfull = vr - h_off;
            float vm = 0.f;
            for (int c = t; c < hd; c += NTH) vm = fmaxf(vm, fabsf(ldcg_f(vfull + c)));
            const float v_s = i8_scale(i8_block_max<NTH>(vm, wr));
            if (t < I8_D) cur->vq_out[t] = static_cast<int8_t>(i8_level(ldcg_f(vr + t), v_s));
            if (cur->ks_out && t == 0) {
                *cur->ks_out = kc_s;
                *cur->vs_out = v_s;
            }
        }
    } else if (l == 0.f) {
        l = 1.f;
    }
    if (t < I8_D) out[t] = from_f32<T>(__fdiv_rn(acc, l));
    __syncthreads();
}

}  // namespace pmt
