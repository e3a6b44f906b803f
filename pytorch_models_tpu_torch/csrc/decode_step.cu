// Fused greedy decode step: the whole decoder layer stack for one token
// [+ a cross-attention phase] [+ the final norm and the greedy head] in ONE
// kernel launch.
//
// Replaces pytorch_models_tpu/ops/decode_step.py `fused_decode_step` and
// `fused_cross_decode_step` (both reaching the Pallas call of `_call_fused`)
// in their base variant (pre-norm LayerNorm, biased projections, GELU exact
// or tanh), the cross-attention phase over (L, B, Lx, H*D) caches with
// per-row lengths, T5's variant (`norm="rms"`: RMSNorm without mean
// subtraction; `gated`: GEGLU over fc1 = [wi_0 | wi_1]; `sbias`: a key-major
// (Lp, H) fp32 rel-pos bias added to the self-attention scores), and the
// greedy head over a (V, d) table (tied, or an untied classifier the caller
// transposed once). Its int8 serving variants:
//   - w8a16 (`wt_int8`): int8 weight matrices with per-output-column fp32
//     scales; an int8 tile widens exactly to fp32, the sum is fp32, then
//     `acc * s_col + bias`, rounded once (the JAX kernel's `stream` and its
//     scale lines);
//   - w8a8 (`a8`, int8 weights): each phase quantizes its input per row
//     (absmax over the whole row: d for QKV, H*D for O, dff for fc2), sums
//     int8 x int8 in int32 (exact), then `(f32(acc) * r_scale) * s_col +
//     bias`; every block reads the whole input row already, so each forms
//     the row absmax itself, with no extra barrier;
//   - a8 head (`head_a8`): a per-vocab-row int8 table with fp32 row scales;
//     the normed hidden state quantized per row (its scale, constant in a
//     row, is never applied); score `f32(dot_i32) * emb_s[v]`, not rounded;
//   - int8 self-KV (`kv_int8`) and cross-KV (`kvx_int8`): attention over
//     int8 caches with per-key fp32 scales, csrc/int8_attn.cuh's arithmetic
//     (shared with the per-op kernel csrc/int8_kv.cu), one unit per (row,
//     head) walking its 128-key blocks in order (the probabilities are
//     quantized per block against the running max, so the keys are not split
//     across blocks). Self: the QKV phase writes this step's K/V to scratch;
//     after the barrier, each unit sees the whole row, forms the row absmax,
//     scores the current key from the quantized K (and the unquantized V),
//     and writes the quantized K/V head slice and (head 0) the row scales at
//     `pos`. T5's self bias is added after dequantization, at cached keys
//     and at `pos`. Cross: keys [0, len_b), no current position, an empty row
//     gives zeros;
//   - the embed phase (`embed`): layer 0 reads `tok_emb[id] + pos_emb[p]`
//     (fp32 sum, one rounding; ids clamped to the tables) instead of `x`.
// The JAX kernel's `eager` flag only orders the TPU's DMA requests; its
// counterpart here is the L2 prefetch below.
//
// What bounds it on the H100: bytes. At batch <= 8 a step reads every layer
// weight once (GPT-2 small bf16: 170 MB + a 77 MB head) and does 2*B FLOPs
// per weight element, far below the ~295 FLOP/byte ridge; the self-KV
// prefix and Whisper's 1,500-key cross cache (197 MB bf16 at B=8) are read
// once too. The eager per-op step it replaces is bound by the host instead:
// ~600 launches per step.
//
// The design: one persistent kernel, launched cooperatively with as many
// blocks as fit on the card at once (the occupancy API's blocks per SM x
// SMs), whose phases are separated by grid-wide barriers. The TPU kernel's
// sequential (layers [+ head]) grid with a VMEM weight ring becomes a loop
// over layers inside every block. Per layer:
//   (a) every block recomputes LN1 of the (B, d) residual into shared memory
//       (tiny; saves a barrier), then blocks split the 3*H*D columns of wqkv
//       into column slabs; a block's warps split the rows of its slab and
//       read them as coalesced 16-byte loads, reduce across warps in shared
//       memory (one fixed order: deterministic), add the fp32 bias and round
//       once. q goes to scratch, k/v into the stacked cache at `pos`.
//   (b) attention, one unit per (row, head, key split): an fp32 online
//       softmax over [min(pad_b, pos), pos] (self) or [0, len_b) (cross);
//       eight lanes hold a key's 64 values, so a warp scores four keys per
//       load. Units write (max, sum, acc) partials; the next phase merges
//       them while it loads its input, so splitting the key range across
//       blocks costs no extra barrier.
//   (c) O projection + bias + residual, by column slab.
//   (d) cross only: LN_c + q_c projection | cross attention | O_c + residual.
//   (e) LN2 + fc1 + bias + GELU into (B, dff) scratch | fc2 + bias + residual.
//       GEGLU: fc1 writes the raw (B, 2*dff) pair (a + bias | g), and the fc2
//       phase applies round(gelu(a)) * g while it loads its input, as (b)'s
//       partials are merged by (c): no extra barrier.
// Head: final LN; each block scores a contiguous vocab chunk (rounded to
// bf16 in bf16, as the logits of a bf16 head matmul would be) and keeps the
// best (value, lowest index) per row | block 0 reduces the blocks' bests with
// the same total order as csrc/greedy_head.cu.
// Each weight matrix is prefetched into L2 two matrices ahead of its phase.
// All products run on CUDA cores with fp32 accumulation; tensor cores, TMA
// weight streaming and a software-pipelined weight ring are later work.
// Measured on an H100 80GB HBM3 (700 W; chip_smoke.py), the step runs at ~9x
// its byte bound and takes about as long in fp32 as in bf16: the limit is
// latency (each phase's grid barrier and its chain of dependent L2/HBM round
// trips), not bandwidth, so fewer phases and deeper load pipelines come first.
//
// Data written inside the kernel (residual, q, partials, the MLP hidden, the
// cache slot at `pos`) is read back with ld.global.cg (L2, never a stale L1
// line); weights, biases and the cross cache take the read-only path.
#include <cooperative_groups.h>

#include <climits>
#include <type_traits>

#include "int8_attn.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int MB = 8;        // largest batch served
constexpr int HEAD_D = 64;   // head dim served
constexpr int MAX_LPR = 4;   // lanes per weight row in a matvec slab
constexpr int MAX_SPLIT = 16;

// Must match ops/decode_step.py `_Args` field for field.
struct Args {
    const void* x;
    void* x_out;
    const void *wqkv, *bqkv, *wo, *bo, *w1, *b1, *w2, *b2;
    const void *ln1_s, *ln1_b, *ln2_s, *ln2_b;
    const void *wqc, *bqc, *woc, *boc, *lnc_s, *lnc_b;
    void *k_cache, *v_cache;
    const void* pads;
    const void *xk, *xv, *xlens;
    const void* sbias;  // key-major (l_max, n_heads) fp32 self bias, or null
    const void *emb, *fn_s, *fn_b;
    void* tok;
    void* workspace;
    void* stream;
    // int8 serving: per-output-column fp32 weight scales (L, N) of wqkv, wo, w1, w2, wqc, woc; the self and
    // cross caches' per-key fp32 scales (L, B, Lp|Lx); the a8 head's per-row scales (V); the embed phase's
    // tables (rows, d) and (B,) int32 ids
    const void *s_qkv, *s_o, *s_1, *s_2, *s_qc, *s_oc;
    void *ks, *vs;
    const void *xks, *xvs;
    const void* emb_s;
    const void *tok_emb, *pos_emb, *tok_ids, *pos_ids;
    int n_layers, b, d, hd, dff, n_heads, l_max, lx, pos, vocab, act, dtype, has_cross, has_head;
    int norm, gated;  // norm 0: LayerNorm, 1: RMSNorm; gated: GEGLU MLP
    int wt_int8, a8, kv_int8, kvx_int8, head_a8, embed, tok_rows, pos_rows;
    float eps, scale;
};

struct Plan {
    int grid, split;
    int lpr_qkv, lpr_hd, lpr_d, lpr_ff, lpr_2;  // lanes per row: qkv, q_c, o/o_c, fc1, fc2
    size_t off_q, off_h, off_pm, off_pl, off_pacc, off_hv, off_hi, off_kn, off_vn, ws_bytes;
    size_t smem, extra;
};

// ---------------------------------------------------------------- loads

// 16-byte loads widened to fp32: read-only path (weights; common.cuh) and L2
// path (data written inside this kernel)
using pmt::ld16;
using pmt::widen;
__device__ __forceinline__ void ld16cg(const float* p, float* o) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void ld16cg(const __nv_bfloat16* p, float* o) {
    widen(__ldcg(reinterpret_cast<const uint4*>(p)), o);
}
__device__ __forceinline__ float ldcg1(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg1(const __nv_bfloat16* p) {
    return __uint_as_float(static_cast<unsigned>(__ldcg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// 8 consecutive values (one lane's share of a 64-wide head), from L2
template <typename T>
__device__ __forceinline__ void ld8cg(const T* p, float* o) {
#pragma unroll
    for (int i = 0; i < 8; i += 16 / sizeof(T)) ld16cg(p + i, o + i);
}

// weights per lane load: 16 bytes of fp32 / bf16, 8 bytes of int8 (8 int8
// accumulators per row keep a slab's sums in registers, as bf16's 8 do)
template <typename W>
struct WVec {
    static constexpr int V = 16 / sizeof(W);
};
template <>
struct WVec<int8_t> {
    static constexpr int V = 8;
};
__device__ __forceinline__ void ldw(const float* p, float* o) { ld16(p, o); }
__device__ __forceinline__ void ldw(const __nv_bfloat16* p, float* o) { ld16(p, o); }
template <typename A>
__device__ __forceinline__ void ldw(const int8_t* p, A* o) {  // exact: int8 -> int or fp32
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        o[i] = static_cast<A>(static_cast<int8_t>(u.x >> (8 * i)));
        o[4 + i] = static_cast<A>(static_cast<int8_t>(u.y >> (8 * i)));
    }
}
__device__ __forceinline__ float mac(float acc, float x, float w) { return fmaf(x, w, acc); }
__device__ __forceinline__ int mac(int acc, int x, int w) { return acc + x * w; }

__device__ __forceinline__ float gelu(float x, int tanh_form) {
    if (tanh_form) {
        const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
        return 0.5f * x * (1.f + tanhf(inner));
    }
    return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
    return s > bs || (s == bs && i < bi);
}

// ---------------------------------------------------------------- inputs

// Phase inputs are read from L2 with 16-byte loads, several in flight per
// thread: one scalar load per iteration would make each phase wait out tens
// of L2 round trips in a row.

// xs[b, :] = round_T(norm(x[b, :]) * s + bias) as fp32, statistics in fp32:
// LayerNorm, or with `rms` RMSNorm (mean taken as 0: no mean subtraction);
// ld(b, c, v) reads x[b, c .. c + 16 bytes of T)
template <typename T, typename Ld>
__device__ void load_ln_from(Ld ld, const float* s, const float* bias, int B, int d, float eps, int rms, float* xs) {
    constexpr int VEC = 16 / sizeof(T);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int b = warp; b < B; b += NW) {
        float* row = xs + b * d;
        float sum = 0.f;
#pragma unroll 4
        for (int c = lane * VEC; c < d; c += 32 * VEC) {
            float v[VEC];
            ld(b, c, v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                row[c + e] = v[e];
                sum += v[e];
            }
        }
        const float mean = rms ? 0.f : pmt::warp_sum(sum) / d;
        __syncwarp();
        float sq = 0.f;
        for (int c = lane; c < d; c += 32) {
            const float t = row[c] - mean;
            sq += t * t;
        }
        const float rstd = rsqrtf(pmt::warp_sum(sq) / d + eps);
#pragma unroll 4
        for (int c = lane * 4; c < d; c += 128) {
            const float4 sv = __ldg(reinterpret_cast<const float4*>(s + c));
            const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c));
            row[c] = pmt::round_to<T>((row[c] - mean) * rstd * sv.x + bv.x);
            row[c + 1] = pmt::round_to<T>((row[c + 1] - mean) * rstd * sv.y + bv.y);
            row[c + 2] = pmt::round_to<T>((row[c + 2] - mean) * rstd * sv.z + bv.z);
            row[c + 3] = pmt::round_to<T>((row[c + 3] - mean) * rstd * sv.w + bv.w);
        }
    }
    __syncthreads();
}

template <typename T>
__device__ void load_ln(const T* x, const float* s, const float* bias, int B, int d, float eps, int rms, float* xs) {
    load_ln_from<T>([=](int b, int c, float* v) { ld16cg(x + static_cast<int64_t>(b) * d + c, v); }, s, bias, B, d,
                    eps, rms, xs);
}

// w8a8: xs[b, :] -> its int8 levels (as fp32) against the row's own absmax;
// rsc[b] = the row's scale
__device__ void quantize_xs(float* xs, int B, int K, float* rsc) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int b = warp; b < B; b += NW) {
        float* row = xs + b * K;
        float am = 0.f;
        for (int c = lane; c < K; c += 32) am = fmaxf(am, fabsf(row[c]));
        for (int o = 16; o > 0; o >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
        const float r = pmt::i8_scale(am);
        for (int c = lane; c < K; c += 32) row[c] = static_cast<float>(pmt::i8_level(row[c], r));
        if (lane == 0) rsc[b] = r;
    }
    __syncthreads();
}

// GEGLU input of fc2: xs[b, k] = round_T(round_T(gelu(a)) * g) from the
// (B, 2*dff) pair h[b] = [a | g] that fc1 wrote
template <typename T>
__device__ void load_gated(const T* h, int B, int dff, int act, float* xs) {
    constexpr int VEC = 16 / sizeof(T);
#pragma unroll 2
    for (int i = threadIdx.x * VEC; i < B * dff; i += NT * VEC) {
        const int b = i / dff, k = i % dff;  // dff % 64 == 0: a 16-byte run stays in one row
        float a[VEC], g[VEC];
        ld16cg(h + static_cast<int64_t>(b) * 2 * dff + k, a);
        ld16cg(h + static_cast<int64_t>(b) * 2 * dff + dff + k, g);
#pragma unroll
        for (int e = 0; e < VEC; ++e) xs[i + e] = pmt::round_to<T>(pmt::round_to<T>(gelu(a[e], act)) * g[e]);
    }
    __syncthreads();
}

template <typename T>
__device__ void load_plain(const T* h, int n, float* xs) {
    constexpr int VEC = 16 / sizeof(T);
#pragma unroll 4
    for (int i = threadIdx.x * VEC; i < n; i += NT * VEC) {
        float v[VEC];
        ld16cg(h + i, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) xs[i + e] = v[e];
    }
    __syncthreads();
}

// ctx[b, h*64 + e] = round_T(merge over splits of the attention partials):
// first each (row, head)'s split weights exp(m_s - M) / L into `wsm`, then
// the weighted sum of the splits' accumulators
template <typename T>
__device__ void load_merge(const float* pm, const float* pl, const float* pacc, int B, int H, int S, float* xs,
                           float* wsm) {
    for (int u = threadIdx.x; u < B * H; u += NT) {
        float mx = pmt::NEG_INF;
        for (int s = 0; s < S; ++s)
            if (ldcg1(pl + u * S + s) > 0.f) mx = fmaxf(mx, ldcg1(pm + u * S + s));
        float l = 0.f;
        for (int s = 0; s < S; ++s) {
            const float ls = ldcg1(pl + u * S + s);
            if (ls > 0.f) l += ls * expf(ldcg1(pm + u * S + s) - mx);
        }
        const float inv = l > 0.f ? 1.f / l : 0.f;  // an empty range gives zeros
        for (int s = 0; s < S; ++s) {
            const float ls = ldcg1(pl + u * S + s);
            wsm[u * S + s] = ls > 0.f ? expf(ldcg1(pm + u * S + s) - mx) * inv : 0.f;
        }
    }
    __syncthreads();
    const int hd = H * HEAD_D;
#pragma unroll 2
    for (int i = threadIdx.x * 4; i < B * hd; i += NT * 4) {
        const int u = (i / hd) * H + (i % hd) / HEAD_D, e = i % HEAD_D;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s = 0; s < S; ++s) {
            float v[4];
            ld16cg(pacc + static_cast<int64_t>(u * S + s) * HEAD_D + e, v);
            const float w = wsm[u * S + s];
#pragma unroll
            for (int j = 0; j < 4; ++j) a[j] = fmaf(v[j], w, a[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) xs[i + j] = pmt::round_to<T>(a[j]);
    }
    __syncthreads();
}

// ---------------------------------------------------------------- matvec

// out[b, n] = sum_k xs[b, k] * W[k, n] for this block's column slabs of
// lpr * VEC columns; epi(b, n, fp32 sum) finishes each output. W is fp32,
// bf16 or int8 (widened exactly); with INT (w8a8) xs holds int8 levels and
// the sums are int32, exact, converted to fp32 once for epi.
template <bool INT, typename W, typename Epi>
__device__ void matvec(const W* __restrict__ Wm, int K, int N, int B, int lpr, const float* xs, float* red, Epi epi) {
    using A = typename std::conditional<INT, int, float>::type;
    constexpr int VEC = WVec<W>::V;
    constexpr int UNROLL = 16 / VEC;
    const int sw = lpr * VEC, rpw = 32 / lpr;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int rg = lane / lpr, cl = lane % lpr;
    const int stride = NW * rpw;
    const int n_slabs = N / sw;
    A* redA = reinterpret_cast<A*>(red);
    for (int slab = blockIdx.x; slab < n_slabs; slab += gridDim.x) {
        const int c0 = slab * sw;
        A acc[MB][VEC];
#pragma unroll
        for (int b = 0; b < MB; ++b)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[b][e] = 0;
        const W* wp = Wm + c0 + cl * VEC;
        int r = warp * rpw + rg;
        for (; r + (UNROLL - 1) * stride < K; r += UNROLL * stride) {
            A w[UNROLL][VEC];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) ldw(wp + static_cast<int64_t>(r + u * stride) * N, w[u]);
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
#pragma unroll
                for (int b = 0; b < MB; ++b)
                    if (b < B) {
                        const A xv = static_cast<A>(xs[b * K + r + u * stride]);
#pragma unroll
                        for (int e = 0; e < VEC; ++e) acc[b][e] = mac(acc[b][e], xv, w[u][e]);
                    }
        }
        for (; r < K; r += stride) {
            A w[VEC];
            ldw(wp + static_cast<int64_t>(r) * N, w);
#pragma unroll
            for (int b = 0; b < MB; ++b)
                if (b < B) {
                    const A xv = static_cast<A>(xs[b * K + r]);
#pragma unroll
                    for (int e = 0; e < VEC; ++e) acc[b][e] = mac(acc[b][e], xv, w[e]);
                }
        }
        // rows of one warp: lanes that share a column sit lpr apart
        for (int o = lpr; o < 32; o <<= 1)
#pragma unroll
            for (int b = 0; b < MB; ++b)
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], o);
        if (rg == 0)
#pragma unroll
            for (int b = 0; b < MB; ++b)
                if (b < B)
#pragma unroll
                    for (int e = 0; e < VEC; ++e) redA[(warp * MB + b) * sw + cl * VEC + e] = acc[b][e];
        __syncthreads();
        for (int t = threadIdx.x; t < B * sw; t += NT) {
            const int b = t / sw, c = t % sw;
            A v = 0;
            for (int w = 0; w < NW; ++w) v += redA[(w * MB + b) * sw + c];
            epi(b, c0 + c, static_cast<float>(v));
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------- attention

// Units (row b, head h, key split s) over keys [start_b, end_b) of a
// (B, Lk, H*64) cache, [+ sb[j * H + h], a key-major fp32 bias shared by the
// rows, on key j's score]; writes (max, sum, unnormalised acc) partials.
template <typename T, typename Range>
__device__ void attention(const T* q, const T* kc, const T* vc, int Lk, int B, int H, int S, float scale, Range range,
                          const float* sb, float* pm, float* pl, float* pacc, float* sm) {
    const int hd = H * HEAD_D;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int grp = lane / 8, e0 = (lane % 8) * 8;
    float* sm_m = sm;
    float* sm_l = sm + NW;
    float* sm_acc = sm + 2 * NW;  // (NW, 64)
    const int n_units = B * H * S;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int s = u % S, h = (u / S) % H, b = u / (S * H);
        int start, end;
        range(b, start, end);
        const int chunk = (end - start + S - 1) / S;
        const int lo = start + s * chunk, hi = min(end, lo + chunk);

        float qv[8];
        const T* qp = q + static_cast<int64_t>(b) * hd + h * HEAD_D + e0;
#pragma unroll
        for (int i = 0; i < 8; ++i) qv[i] = pmt::round_to<T>(ldcg1(qp + i) * scale);

        float m = pmt::NEG_INF, l = 0.f, acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
        const int64_t base = static_cast<int64_t>(b) * Lk * hd + h * HEAD_D + e0;
        for (int jb = lo + warp * 4; jb < hi; jb += NW * 8) {  // warp-uniform trip count; 2 keys per group
            float kv[2][8], vv[2][8];
            bool ok[2];
#pragma unroll
            for (int t = 0; t < 2; ++t) {
                const int j = jb + grp + t * NW * 4;
                ok[t] = j < hi;
                if (ok[t]) {
                    ld8cg(kc + base + static_cast<int64_t>(j) * hd, kv[t]);
                    ld8cg(vc + base + static_cast<int64_t>(j) * hd, vv[t]);
                } else {
#pragma unroll
                    for (int i = 0; i < 8; ++i) kv[t][i] = vv[t][i] = 0.f;
                }
            }
#pragma unroll
            for (int t = 0; t < 2; ++t) {
                float sc = 0.f;
#pragma unroll
                for (int i = 0; i < 8; ++i) sc = fmaf(qv[i], kv[t][i], sc);
                sc += __shfl_xor_sync(0xffffffffu, sc, 1);
                sc += __shfl_xor_sync(0xffffffffu, sc, 2);
                sc += __shfl_xor_sync(0xffffffffu, sc, 4);
                if (ok[t]) {
                    if (sb) sc += __ldg(sb + static_cast<int64_t>(jb + grp + t * NW * 4) * H + h);
                    const float m_new = fmaxf(m, sc);
                    const float alpha = expf(m - m_new), p = expf(sc - m_new);
                    l = l * alpha + p;
#pragma unroll
                    for (int i = 0; i < 8; ++i) acc[i] = acc[i] * alpha + p * vv[t][i];
                    m = m_new;
                }
            }
        }
        // merge the warp's four key groups, then the warps
        for (int o = 8; o < 32; o <<= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, m, o), l2 = __shfl_xor_sync(0xffffffffu, l, o);
            const float mx = fmaxf(m, m2);
            const float f1 = l > 0.f ? expf(m - mx) : 0.f, f2 = l2 > 0.f ? expf(m2 - mx) : 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = acc[i] * f1 + __shfl_xor_sync(0xffffffffu, acc[i], o) * f2;
            l = l * f1 + l2 * f2;
            m = mx;
        }
        if (lane == 0) {
            sm_m[warp] = m;
            sm_l[warp] = l;
        }
        if (lane < 8)
#pragma unroll
            for (int i = 0; i < 8; ++i) sm_acc[warp * HEAD_D + e0 + i] = acc[i];
        __syncthreads();
        if (threadIdx.x < HEAD_D) {
            float mx = pmt::NEG_INF;
            for (int w = 0; w < NW; ++w)
                if (sm_l[w] > 0.f) mx = fmaxf(mx, sm_m[w]);
            float ls = 0.f, a = 0.f;
            for (int w = 0; w < NW; ++w) {
                const float f = sm_l[w] > 0.f ? expf(sm_m[w] - mx) : 0.f;
                ls += sm_l[w] * f;
                a += sm_acc[w * HEAD_D + threadIdx.x] * f;
            }
            pacc[static_cast<int64_t>(u) * HEAD_D + threadIdx.x] = a;
            if (threadIdx.x == 0) {
                pm[u] = mx;
                pl[u] = ls;
            }
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------- L2 prefetch

// The step's weight matrices in the order its phases read them: per layer
// qkv, o, [q_c, o_c,] fc1, fc2. Weights do not depend on the data, so each
// is prefetched into L2 (50 MB) two matrices ahead of its phase, spread over
// every thread of the grid: the HBM reads overlap the phases and barriers
// before it, and the phase itself reads from L2. This is the TPU kernel's
// next-phase weight warm-up, done with prefetch.global.L2.
template <typename T>
__device__ void prefetch_weights(const Args& a, int i) {
    const int per = a.has_cross ? 6 : 4;
    const int l = i / per, k = i % per;
    if (l >= a.n_layers) return;
    const int d = a.d, hd = a.hd, dff = a.dff;
    const void* base;
    int64_t n;
    const int kind = a.has_cross ? k : (k < 2 ? k : k + 2);  // 0 qkv, 1 o, 2 q_c, 3 o_c, 4 fc1, 5 fc2
    switch (kind) {
        case 0: base = a.wqkv, n = static_cast<int64_t>(d) * 3 * hd; break;
        case 1: base = a.wo, n = static_cast<int64_t>(hd) * d; break;
        case 2: base = a.wqc, n = static_cast<int64_t>(d) * hd; break;
        case 3: base = a.woc, n = static_cast<int64_t>(hd) * d; break;
        case 4: base = a.w1, n = static_cast<int64_t>(d) * dff * (a.gated ? 2 : 1); break;
        default: base = a.w2, n = static_cast<int64_t>(dff) * d; break;
    }
    const char* p = static_cast<const char*>(base) + l * n * static_cast<int64_t>(sizeof(T));
    const int64_t bytes = n * static_cast<int64_t>(sizeof(T));
    for (int64_t off = (static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x) * 128; off < bytes;
         off += static_cast<int64_t>(gridDim.x) * NT * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p + off));
}

// ---------------------------------------------------------------- kernel

template <typename T, typename W>
__global__ void __launch_bounds__(NT, 1) decode_step_kernel(Args a, Plan p) {
    extern __shared__ float smem[];
    cg::grid_group grid = cg::this_grid();
    const int B = a.b, d = a.d, hd = a.hd, dff = a.dff, H = a.n_heads, Lp = a.l_max, pos = a.pos;
    const int kmax = max(max(d, hd), dff);
    float* xs = smem;
    float* red = smem + B * kmax;
    float* rsc = red + p.extra / 4;  // (MB) w8a8 row scales of the phase input

    char* ws = static_cast<char*>(a.workspace);
    T* qs = reinterpret_cast<T*>(ws + p.off_q);
    T* hbuf = reinterpret_cast<T*>(ws + p.off_h);
    T* kn = reinterpret_cast<T*>(ws + p.off_kn);  // int8 self-KV: this step's K/V, before quantization
    T* vn = reinterpret_cast<T*>(ws + p.off_vn);
    float* pm = reinterpret_cast<float*>(ws + p.off_pm);
    float* pl = reinterpret_cast<float*>(ws + p.off_pl);
    float* pacc = reinterpret_cast<float*>(ws + p.off_pacc);
    const T* x_in = static_cast<const T*>(a.x);
    T* xr = static_cast<T*>(a.x_out);
    const int* pads = static_cast<const int*>(a.pads);
    const int* xlens = static_cast<const int*>(a.xlens);
    const float* sbias = static_cast<const float*>(a.sbias);
    const int a8 = a.a8;
    auto fp = [](const void* ptr) { return static_cast<const float*>(ptr); };
    auto wt = [](const void* ptr) { return static_cast<const W*>(ptr); };
    // a column's sum -> its dequantized fp32 value: w8a8 row scale, then the int8 weights' column scale
    auto deq = [=](int b, int c, float v, const float* s) {
        if (a8) v = __fmul_rn(v, rsc[b]);
        if (s) v = __fmul_rn(v, __ldg(s + c));
        return v;
    };
    auto scales = [&](const void* s, int l, int n) { return s ? fp(s) + static_cast<int64_t>(l) * n : nullptr; };
    // xs -> out columns: fp32 / bf16 / int8 weights, or w8a8's int8 x int8 over the row-quantized xs
    auto mv = [&](const W* w, int K, int N, int lpr, auto epi) {
        if constexpr (std::is_same<W, int8_t>::value) {
            if (a8) {
                quantize_xs(xs, B, K, rsc);
                matvec<true>(w, K, N, B, lpr, xs, red, epi);
                return;
            }
        }
        matvec<false>(w, K, N, B, lpr, xs, red, epi);
    };
    // the embed phase's layer-0 input: round_T(tok[id] + pos[p]), the sum in fp32
    const T* tok_tab = static_cast<const T*>(a.tok_emb);
    const T* pos_tab = static_cast<const T*>(a.pos_emb);
    const int* tok_ids = static_cast<const int*>(a.tok_ids);
    const int* pos_ids = static_cast<const int*>(a.pos_ids);
    auto x0 = [=](int b, int c) {
        const int id = min(max(__ldg(tok_ids + b), 0), a.tok_rows - 1);
        const float v = pmt::to_f32(tok_tab[static_cast<int64_t>(id) * d + c]);
        if (!pos_tab) return v;
        const int pr = min(max(__ldg(pos_ids + b), 0), a.pos_rows - 1);
        return pmt::round_to<T>(__fadd_rn(v, pmt::to_f32(pos_tab[static_cast<int64_t>(pr) * d + c])));
    };
    // self-attention over an int8 cache (a.kv_int8) or a cross cache (kvx): one unit per (row, head); the
    // context replaces q in qs
    auto int8_units = [&](const int8_t* kq, const int8_t* vq, const float* ks, const float* vs, int lk, bool self,
                          int8_t* kq_w, int8_t* vq_w, float* ks_w, float* vs_w) {
        for (int u = blockIdx.x; u < B * H; u += gridDim.x) {
            const int b = u / H, h = u % H;
            const int64_t row = static_cast<int64_t>(b) * lk;
            T* q = qs + static_cast<int64_t>(b) * hd + h * HEAD_D;
            pmt::I8Cur cur{};
            int lo = 0, hi;
            if (self) {
                lo = pads ? max(__ldg(pads + b), 0) : 0;
                hi = pos;
                cur.k = kn + static_cast<int64_t>(b) * hd;
                cur.v = vn + static_cast<int64_t>(b) * hd + h * HEAD_D;
                cur.bias = sbias ? __ldg(sbias + static_cast<int64_t>(pos) * H + h) : 0.f;
                cur.kq_out = kq_w + (row + pos) * hd + h * HEAD_D;
                cur.vq_out = vq_w + (row + pos) * hd + h * HEAD_D;
                if (h == 0) cur.ks_out = ks_w + row + pos, cur.vs_out = vs_w + row + pos;
            } else {
                hi = min(max(__ldg(xlens + b), 0), lk);
            }
            pmt::i8_attention_unit<T, NT>(q, a.scale, kq + row * hd + h * HEAD_D, vq + row * hd + h * HEAD_D, ks + row,
                                          vs + row, hd, lo, hi, self ? sbias : nullptr, H, h, self ? &cur : nullptr, q,
                                          reinterpret_cast<char*>(red));
        }
    };

    int mv_i = 0;  // matrices read so far; the one two ahead is prefetched at each phase's start
    prefetch_weights<W>(a, 0);
    prefetch_weights<W>(a, 1);
    for (int l = 0; l < a.n_layers; ++l) {
        const T* xp = l == 0 ? x_in : xr;  // the residual entering this layer
        const bool emb0 = l == 0 && a.embed;
        const int64_t kv_off = static_cast<int64_t>(l) * B * Lp * hd;

        // residual += round(acc + bias), in the compute dtype
        auto residual = [&](const T* src, const float* bias, const float* s, bool from_embed) {
            return [=](int b, int c, float v) {
                const int64_t i = static_cast<int64_t>(b) * d + c;
                const float x = from_embed ? x0(b, c) : ldcg1(src + i);
                xr[i] = pmt::from_f32<T>(x + pmt::round_to<T>(deq(b, c, v, s) + __ldg(bias + c)));
            };
        };

        // (a) LN1 + QKV; k/v land in the cache at pos (int8 self-KV: in scratch, quantized by the attention units)
        prefetch_weights<W>(a, mv_i++ + 2);
        if (emb0)
            load_ln_from<T>(
                [=](int b, int c, float* v) {
                    for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e) v[e] = x0(b, c + e);
                },
                fp(a.ln1_s), fp(a.ln1_b), B, d, a.eps, a.norm, xs);
        else
            load_ln(xp, fp(a.ln1_s) + l * d, fp(a.ln1_b) + l * d, B, d, a.eps, a.norm, xs);
        const float* bqkv = fp(a.bqkv) + static_cast<int64_t>(l) * 3 * hd;
        const float* s_qkv = scales(a.s_qkv, l, 3 * hd);
        T* kc = static_cast<T*>(a.k_cache) + kv_off;
        T* vc = static_cast<T*>(a.v_cache) + kv_off;
        const int kv_int8 = a.kv_int8;
        mv(wt(a.wqkv) + static_cast<int64_t>(l) * d * 3 * hd, d, 3 * hd, p.lpr_qkv, [=](int b, int c, float v) {
            const T y = pmt::from_f32<T>(deq(b, c, v, s_qkv) + __ldg(bqkv + c));
            if (c < hd)
                qs[b * hd + c] = y;
            else if (kv_int8)
                (c < 2 * hd ? kn : vn)[b * hd + (c - hd) % hd] = y;
            else if (c < 2 * hd)
                kc[(static_cast<int64_t>(b) * Lp + pos) * hd + c - hd] = y;
            else
                vc[(static_cast<int64_t>(b) * Lp + pos) * hd + c - 2 * hd] = y;
        });
        grid.sync();

        // (b) self-attention over [min(pad_b, pos), pos]
        if (kv_int8) {
            int8_t* kq = static_cast<int8_t*>(a.k_cache) + kv_off;
            int8_t* vq = static_cast<int8_t*>(a.v_cache) + kv_off;
            float* ks = static_cast<float*>(a.ks) + static_cast<int64_t>(l) * B * Lp;
            float* vs = static_cast<float*>(a.vs) + static_cast<int64_t>(l) * B * Lp;
            int8_units(kq, vq, ks, vs, Lp, true, kq, vq, ks, vs);
        } else {
            attention<T>(qs, kc, vc, Lp, B, H, p.split, a.scale,
                         [=](int b, int& start, int& end) {
                             start = pads ? min(max(__ldg(pads + b), 0), pos) : 0;
                             end = pos + 1;
                         },
                         sbias, pm, pl, pacc, red);
        }
        grid.sync();

        // (c) O projection + residual
        prefetch_weights<W>(a, mv_i++ + 2);
        if (kv_int8)
            load_plain(static_cast<const T*>(qs), B * hd, xs);
        else
            load_merge<T>(pm, pl, pacc, B, H, p.split, xs, red);
        mv(wt(a.wo) + static_cast<int64_t>(l) * hd * d, hd, d, p.lpr_d,
           residual(xp, fp(a.bo) + l * d, scales(a.s_o, l, d), emb0));
        grid.sync();

        if (a.has_cross) {
            // (d) LN_c + q_c | cross-attention over [0, len_b) | O_c + residual
            prefetch_weights<W>(a, mv_i++ + 2);
            load_ln(static_cast<const T*>(xr), fp(a.lnc_s) + l * d, fp(a.lnc_b) + l * d, B, d, a.eps, a.norm, xs);
            const float* bqc = fp(a.bqc) + static_cast<int64_t>(l) * hd;
            const float* s_qc = scales(a.s_qc, l, hd);
            mv(wt(a.wqc) + static_cast<int64_t>(l) * d * hd, d, hd, p.lpr_hd, [=](int b, int c, float v) {
                qs[b * hd + c] = pmt::from_f32<T>(deq(b, c, v, s_qc) + __ldg(bqc + c));
            });
            grid.sync();
            const int lx = a.lx;
            const int64_t xoff = static_cast<int64_t>(l) * B * lx * hd;
            if (a.kvx_int8) {
                const int64_t soff = static_cast<int64_t>(l) * B * lx;
                int8_units(static_cast<const int8_t*>(a.xk) + xoff, static_cast<const int8_t*>(a.xv) + xoff,
                           fp(a.xks) + soff, fp(a.xvs) + soff, lx, false, nullptr, nullptr, nullptr, nullptr);
            } else {
                attention<T>(qs, static_cast<const T*>(a.xk) + xoff, static_cast<const T*>(a.xv) + xoff, lx, B, H,
                             p.split, a.scale,
                             [=](int b, int& start, int& end) {
                                 start = 0;
                                 end = min(max(__ldg(xlens + b), 0), lx);
                             },
                             nullptr, pm, pl, pacc, red);
            }
            grid.sync();
            prefetch_weights<W>(a, mv_i++ + 2);
            if (a.kvx_int8)
                load_plain(static_cast<const T*>(qs), B * hd, xs);
            else
                load_merge<T>(pm, pl, pacc, B, H, p.split, xs, red);
            mv(wt(a.woc) + static_cast<int64_t>(l) * hd * d, hd, d, p.lpr_d,
               residual(xr, fp(a.boc) + l * d, scales(a.s_oc, l, d), false));
            grid.sync();
        }

        // (e) LN2 + fc1 + GELU | fc2 + residual (GEGLU: fc1 writes the pair, fc2's load gates it)
        prefetch_weights<W>(a, mv_i++ + 2);
        load_ln(static_cast<const T*>(xr), fp(a.ln2_s) + l * d, fp(a.ln2_b) + l * d, B, d, a.eps, a.norm, xs);
        const float* b1 = fp(a.b1) + static_cast<int64_t>(l) * dff;
        const int act = a.act, gated = a.gated, n1 = gated ? 2 * dff : dff;
        const float* s_1 = scales(a.s_1, l, n1);
        mv(wt(a.w1) + static_cast<int64_t>(l) * d * n1, d, n1, p.lpr_ff, [=](int b, int c, float v) {
            v = deq(b, c, v, s_1);
            if (gated)
                hbuf[b * n1 + c] = pmt::from_f32<T>(c < dff ? v + __ldg(b1 + c) : v);
            else
                hbuf[b * dff + c] = pmt::from_f32<T>(gelu(pmt::round_to<T>(v + __ldg(b1 + c)), act));
        });
        grid.sync();
        prefetch_weights<W>(a, mv_i++ + 2);
        if (gated)
            load_gated(static_cast<const T*>(hbuf), B, dff, act, xs);
        else
            load_plain(static_cast<const T*>(hbuf), B * dff, xs);
        mv(wt(a.w2) + static_cast<int64_t>(l) * dff * d, dff, d, p.lpr_2,
           residual(xr, fp(a.b2) + l * d, scales(a.s_2, l, d), false));
        grid.sync();
    }
    if (!a.has_head) return;

    // head: final LN, then each block's vocab chunk -> best (value, index) per row
    float* hv = reinterpret_cast<float*>(ws + p.off_hv);
    int* hi = reinterpret_cast<int*>(ws + p.off_hi);
    load_ln(static_cast<const T*>(xr), fp(a.fn_s), fp(a.fn_b), B, d, a.eps, a.norm, xs);
    {
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, grp = lane / 8, gl = lane % 8;
        const int chunk = (a.vocab + gridDim.x - 1) / gridDim.x;
        const int r0 = blockIdx.x * chunk, r1 = min(a.vocab, r0 + chunk);
        float bv[MB];
        int bi[MB];
#pragma unroll
        for (int b = 0; b < MB; ++b) bv[b] = pmt::neg_inf(), bi[b] = INT_MAX;
        float* sv = red;                                    // (NW * 4, MB)
        int* si = reinterpret_cast<int*>(red + NW * 4 * MB);  // (NW * 4, MB)
        if (a.head_a8) {
            // w8a8 head: the hidden state's int8 levels against its row absmax (the row scale is never
            // applied: it does not move a row's argmax), packed four to an int for __dp4a; score
            // f32(dot_i32) * emb_s[v]
            int* xq = reinterpret_cast<int*>(red + NW * 4 * MB * 2);  // (B, d / 4)
            quantize_xs(xs, B, d, rsc);
            for (int i = threadIdx.x; i < B * d / 4; i += NT) {
                unsigned u = 0;
                for (int e = 0; e < 4; ++e)
                    u |= (static_cast<unsigned>(static_cast<int>(xs[4 * i + e])) & 0xffu) << (8 * e);
                xq[i] = static_cast<int>(u);
            }
            __syncthreads();
            const int8_t* emb = static_cast<const int8_t*>(a.emb);
            const float* emb_s = fp(a.emb_s);
            const int d4 = d / 4;
            for (int rb = r0 + warp * 4; rb < r1; rb += NW * 4) {  // warp-uniform trip count
                const int r = rb + grp;
                const bool ok = r < r1;
                int acc[MB];
#pragma unroll
                for (int b = 0; b < MB; ++b) acc[b] = 0;
                if (ok) {
                    for (int c0 = gl * 16; c0 < d; c0 += 8 * 16) {
                        const int4 w = __ldg(reinterpret_cast<const int4*>(emb + static_cast<int64_t>(r) * d + c0));
#pragma unroll
                        for (int b = 0; b < MB; ++b)
                            if (b < B) {
                                const int* xb = xq + b * d4 + c0 / 4;
                                acc[b] = __dp4a(w.x, xb[0], acc[b]);
                                acc[b] = __dp4a(w.y, xb[1], acc[b]);
                                acc[b] = __dp4a(w.z, xb[2], acc[b]);
                                acc[b] = __dp4a(w.w, xb[3], acc[b]);
                            }
                    }
                }
                const float es = ok ? __ldg(emb_s + r) : 0.f;
#pragma unroll
                for (int b = 0; b < MB; ++b) {
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 1);
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 2);
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 4);
                    const float sc = __fmul_rn(__int2float_rn(acc[b]), es);
                    if (ok && better(sc, r, bv[b], bi[b])) bv[b] = sc, bi[b] = r;
                }
            }
        } else {
            constexpr int VEC = 16 / sizeof(T);
            const T* emb = static_cast<const T*>(a.emb);
            for (int rb = r0 + warp * 4; rb < r1; rb += NW * 4) {  // warp-uniform trip count
                const int r = rb + grp;
                const bool ok = r < r1;
                float acc[MB];
#pragma unroll
                for (int b = 0; b < MB; ++b) acc[b] = 0.f;
                if (ok) {
                    for (int c0 = gl * VEC; c0 < d; c0 += 4 * 8 * VEC) {  // four 16-byte loads in flight
                        float w[4][VEC];
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            const int c = c0 + u * 8 * VEC;
                            if (c < d)
                                ld16(emb + static_cast<int64_t>(r) * d + c, w[u]);
                            else
#pragma unroll
                                for (int e = 0; e < VEC; ++e) w[u][e] = 0.f;
                        }
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            const int c = min(c0 + u * 8 * VEC, d - VEC);  // past the row end w is 0
#pragma unroll
                            for (int b = 0; b < MB; ++b)
                                if (b < B)
#pragma unroll
                                    for (int e = 0; e < VEC; ++e) acc[b] = fmaf(xs[b * d + c + e], w[u][e], acc[b]);
                        }
                    }
                }
#pragma unroll
                for (int b = 0; b < MB; ++b) {
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 1);
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 2);
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 4);
                    const float sc = pmt::round_to<T>(acc[b]);
                    if (ok && better(sc, r, bv[b], bi[b])) bv[b] = sc, bi[b] = r;
                }
            }
        }
        __syncthreads();
        if (gl == 0)
#pragma unroll
            for (int b = 0; b < MB; ++b) {
                sv[(warp * 4 + grp) * MB + b] = bv[b];
                si[(warp * 4 + grp) * MB + b] = bi[b];
            }
        __syncthreads();
        if (threadIdx.x < B) {
            const int b = threadIdx.x;
            float v = pmt::neg_inf();
            int i = INT_MAX;
            for (int g = 0; g < NW * 4; ++g)
                if (better(sv[g * MB + b], si[g * MB + b], v, i)) v = sv[g * MB + b], i = si[g * MB + b];
            hv[b * gridDim.x + blockIdx.x] = v;
            hi[b * gridDim.x + blockIdx.x] = i;
        }
    }
    grid.sync();
    if (blockIdx.x != 0) return;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int b = warp; b < B; b += NW) {
        float v = pmt::neg_inf();
        int i = INT_MAX;
        for (int g = lane; g < static_cast<int>(gridDim.x); g += 32) {
            const float gv = ldcg1(hv + b * gridDim.x + g);
            const int gi = __ldcg(hi + b * gridDim.x + g);
            if (better(gv, gi, v, i)) v = gv, i = gi;
        }
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, o);
            const int oi = __shfl_xor_sync(0xffffffffu, i, o);
            if (better(ov, oi, v, i)) v = ov, i = oi;
        }
        if (lane == 0) static_cast<int64_t*>(a.tok)[b] = i;
    }
}

// ---------------------------------------------------------------- host side

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// lanes per weight row for a (K, N) matvec over `grid` blocks: the fewest
// load round trips in a row (slab rounds x (unrolled row rounds + one for
// the reduction)); ties to the wider slab
int pick_lpr(int n, int k, int vec, int grid) {
    const int unroll = 16 / vec;
    int best = 1;
    long best_cost = -1;
    for (int lpr = 1; lpr <= MAX_LPR; lpr *= 2) {
        if (n % (lpr * vec)) continue;
        const long slabs = n / (lpr * vec);
        const long iters = (k + NW * (32 / lpr) - 1) / (NW * (32 / lpr));
        const long cost = (slabs + grid - 1) / grid * ((iters + unroll - 1) / unroll + 1);
        if (best_cost < 0 || cost <= best_cost) best = lpr, best_cost = cost;
    }
    return best;
}

template <typename T, typename W>
int plan(const Args& a, Plan& p) {
    constexpr int VEC = WVec<W>::V;
    if (a.b < 1 || a.b > MB || a.hd != a.n_heads * HEAD_D || a.d % 64 || a.hd % 64 || a.dff % 64)
        return static_cast<int>(cudaErrorInvalidValue);
    const int kmax = a.d > a.dff ? (a.d > a.hd ? a.d : a.hd) : (a.dff > a.hd ? a.dff : a.hd);
    size_t extra = static_cast<size_t>(NW) * MB * MAX_LPR * VEC * 4;  // matvec reduction
    const size_t attn = static_cast<size_t>(NW) * (2 + HEAD_D) * 4;
    const size_t head = static_cast<size_t>(NW) * 4 * MB * 8 + (a.head_a8 ? static_cast<size_t>(a.b) * a.d : 0);
    const size_t i8 = pmt::i8_unit_smem<NT>();
    extra = extra > attn ? extra : attn;
    extra = extra > head ? extra : head;
    extra = extra > i8 ? extra : i8;
    p.extra = align256(extra);
    p.smem = static_cast<size_t>(a.b) * kmax * 4 + p.extra + MB * 4;

    static size_t attr_smem = 0;
    static int per_sm = 0, sms = 0;
    if (attr_smem != p.smem) {
        int dev = 0, coop = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(decode_step_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(p.smem));
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_step_kernel<T, W>, NT, p.smem);
        if (e != cudaSuccess) {
            cudaGetLastError();  // a refused plan answers the caller; it must not fail the next launch's check
            return static_cast<int>(e);
        }
        if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);  // grid cannot be co-resident
        attr_smem = p.smem;
    }
    p.grid = per_sm * sms;
    const int units = a.b * a.n_heads;
    p.split = p.grid / units;
    p.split = p.split < 1 ? 1 : (p.split > MAX_SPLIT ? MAX_SPLIT : p.split);
    while (p.split > 1 && static_cast<size_t>(units) * p.split * 4 > extra) --p.split;  // merge weights fit
    if (static_cast<size_t>(units) * 4 > extra) return static_cast<int>(cudaErrorInvalidValue);
    p.lpr_qkv = pick_lpr(3 * a.hd, a.d, VEC, p.grid);
    p.lpr_hd = pick_lpr(a.hd, a.d, VEC, p.grid);
    p.lpr_d = pick_lpr(a.d, a.hd, VEC, p.grid);
    p.lpr_ff = pick_lpr(a.gated ? 2 * a.dff : a.dff, a.d, VEC, p.grid);
    p.lpr_2 = pick_lpr(a.d, a.dff, VEC, p.grid);

    const size_t n_units = static_cast<size_t>(units) * p.split;
    size_t off = 0;
    p.off_q = off, off += align256(static_cast<size_t>(a.b) * a.hd * sizeof(T));
    p.off_h = off, off += align256(static_cast<size_t>(a.b) * a.dff * (a.gated ? 2 : 1) * sizeof(T));
    p.off_kn = off, off += align256(static_cast<size_t>(a.b) * a.hd * sizeof(T));
    p.off_vn = off, off += align256(static_cast<size_t>(a.b) * a.hd * sizeof(T));
    p.off_pm = off, off += align256(n_units * 4);
    p.off_pl = off, off += align256(n_units * 4);
    p.off_pacc = off, off += align256(n_units * HEAD_D * 4);
    p.off_hv = off, off += align256(static_cast<size_t>(a.b) * p.grid * 4);
    p.off_hi = off, off += align256(static_cast<size_t>(a.b) * p.grid * 4);
    p.ws_bytes = off;
    return 0;
}

template <typename T, typename W>
int launch(const Args& a) {
    Plan p;
    int rc = plan<T, W>(a, p);
    if (rc != 0) return rc;
    Args args = a;
    void* params[] = {&args, &p};
    cudaError_t e = cudaLaunchCooperativeKernel(decode_step_kernel<T, W>, dim3(p.grid), dim3(NT), params, p.smem,
                                                pmt::as_stream(a.stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int plan_for(const Args& a, Plan& p) {
    return a.wt_int8 ? plan<T, int8_t>(a, p) : plan<T, T>(a, p);
}

}  // namespace

// Workspace bytes the step needs (<= 0: a CUDA error code, negated), and the
// grid it will run as (written to grid_out).
extern "C" int pmt_decode_step_workspace(const void* args, void* grid_out) {
    const Args& a = *static_cast<const Args*>(args);
    Plan p;
    const int rc = a.dtype == pmt::DT_F32 ? plan_for<float>(a, p) : plan_for<__nv_bfloat16>(a, p);
    if (rc != 0) return -rc;
    *static_cast<int*>(grid_out) = p.grid;
    return static_cast<int>(p.ws_bytes);
}

extern "C" int pmt_decode_step(const void* args) {
    const Args& a = *static_cast<const Args*>(args);
    if (a.dtype == pmt::DT_F32) return a.wt_int8 ? launch<float, int8_t>(a) : launch<float, float>(a);
    return a.wt_int8 ? launch<__nv_bfloat16, int8_t>(a) : launch<__nv_bfloat16, __nv_bfloat16>(a);
}
