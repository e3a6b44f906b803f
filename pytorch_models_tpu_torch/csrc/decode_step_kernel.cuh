// The fused decode step's kernel and host side (see decode_step.cuh), included
// by each instantiation's source: decode_step_<dtype>_<w>_g<MAXG>.cu.
#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "decode_step.cuh"
#include "int8_attn.cuh"

namespace pmt_k7 {

namespace cg = cooperative_groups;

namespace {

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

// weights per lane load, a column unit: 16 bytes of fp32 / bf16, 8 bytes of
// int8 (8 columns, as bf16's). The unit-major weights keep a unit's K rows
// contiguous, and blocks take runs of units.
template <typename W>
struct WVec {
    static constexpr int V = 16 / sizeof(W);
};
template <>
struct WVec<int8_t> {
    static constexpr int V = 8;
};
// a lane's weights from the shared-memory ring
__device__ __forceinline__ void ldw(const float* p, float* o) { pmt::lds16(p, o); }
__device__ __forceinline__ void ldw(const __nv_bfloat16* p, float* o) { pmt::lds16(p, o); }
template <typename A>
__device__ __forceinline__ void ldw(const int8_t* p, A* o) {  // exact: int8 -> int or fp32
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        o[i] = static_cast<A>(static_cast<int8_t>(u.x >> (8 * i)));
        o[4 + i] = static_cast<A>(static_cast<int8_t>(u.y >> (8 * i)));
    }
}
__device__ __forceinline__ float mac(float acc, float x, float w) { return fmaf(x, w, acc); }
__device__ __forceinline__ int mac(int acc, int x, int w) { return acc + x * w; }

// The MLP's activation of a compute-dtype value x, in fp32 (the caller rounds): code 0 exact (erf) GELU,
// 1 tanh GELU, 2 relu, 3 silu, 4 identity (ops/decode_step.py `_ACT_CODES`). silu is x * sigmoid(x) with the
// sigmoid's exp, sum and reciprocal each rounded to T, as XLA expands the JAX kernel's bf16 logistic (bit for
// bit the JAX kernel in interpret mode); in fp32 the roundings are exact.
template <typename T>
__device__ __forceinline__ float act_fn(float x, int code) {
    switch (code) {
    case 0: return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
    case 1: return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case 2: return x > 0.f ? x : 0.f;
    case 3: {
        const float e = pmt::round_to<T>(expf(-x));
        return x * pmt::round_to<T>(1.f / pmt::round_to<T>(1.f + e));
    }
    default: return x;
    }
}

__device__ __forceinline__ long long globaltimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// bulk copies: pmt::bulk_copy and the mbarrier helpers (common.cuh)
using pmt::bulk_copy;
using pmt::fence_async_shared;
using pmt::mbar_expect;
using pmt::mbar_init;
using pmt::mbar_wait;

using pmt::better;

// ---------------------------------------------------------------- inputs

// Phase inputs are read from L2 with 16-byte loads, several in flight per
// thread: one scalar load per iteration would make each phase wait out tens
// of L2 round trips in a row.

// xs[b, :] = round_T(norm(x[b, :]) * s + bias) as fp32, statistics in fp32:
// LayerNorm, or with `rms` RMSNorm (mean taken as 0: no mean subtraction);
// ld(b, c, v) reads x[b, c .. c + 16 bytes of T). s and bias are the staged
// norm parameters in shared memory: `ready()` (every thread calls it) waits
// for them after every row is in and its statistics are taken. Up to RPW
// * NW rows: warp w holds rows w, w + NW, ... (their loads in flight
// together); a row's statistics are one warp's, in one order, whichever
// warp holds it.
template <typename T, int RPW, typename Ld, typename Ready>
__device__ void load_ln_from(Ld ld, const float* s, const float* bias, int B, int d, float eps, int rms, float* xs,
                             int xst, Ready ready) {
    constexpr int VEC = 16 / sizeof(T);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float mean[RPW], rstd[RPW], sum[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int b = warp + i * NW;
        sum[i] = 0.f;
        if (b < B) {
#pragma unroll 4
            for (int c = lane * VEC; c < d; c += 32 * VEC) {
                float v[VEC];
                ld(b, c, v);
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    xs[b * xst + c + e] = v[e];
                    sum[i] += v[e];
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int b = warp + i * NW;
        mean[i] = rstd[i] = 0.f;
        if (b < B) {
            const float* row = xs + b * xst;
            mean[i] = rms ? 0.f : pmt::warp_sum(sum[i]) / d;
            __syncwarp();
            float sq = 0.f;
            for (int c = lane; c < d; c += 32) {
                const float t = row[c] - mean[i];
                sq += t * t;
            }
            rstd[i] = rsqrtf(pmt::warp_sum(sq) / d + eps);
        }
    }
    ready();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int b = warp + i * NW;
        if (b < B) {
            float* row = xs + b * xst;
#pragma unroll 4
            for (int c = lane * 4; c < d; c += 128) {
                const float4 sv = *reinterpret_cast<const float4*>(s + c);
                const float4 bv = *reinterpret_cast<const float4*>(bias + c);
                row[c] = pmt::round_to<T>((row[c] - mean[i]) * rstd[i] * sv.x + bv.x);
                row[c + 1] = pmt::round_to<T>((row[c + 1] - mean[i]) * rstd[i] * sv.y + bv.y);
                row[c + 2] = pmt::round_to<T>((row[c + 2] - mean[i]) * rstd[i] * sv.z + bv.z);
                row[c + 3] = pmt::round_to<T>((row[c + 3] - mean[i]) * rstd[i] * sv.w + bv.w);
            }
        }
    }
    __syncthreads();
}

template <typename T, int RPW, typename Ready>
__device__ void load_ln(const T* x, const float* s, const float* bias, int B, int d, float eps, int rms, float* xs,
                        int xst, Ready ready) {
    load_ln_from<T, RPW>([=](int b, int c, float* v) { ld16cg(x + static_cast<int64_t>(b) * d + c, v); }, s, bias, B, d,
                    eps, rms, xs, xst, ready);
}

// w8a8: xs[b, :] -> its int8 levels (as fp32) against the row's own absmax;
// rsc[b] = the row's scale
__device__ void quantize_xs(float* xs, int xst, int B, int K, float* rsc) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int b = warp; b < B; b += NW) {
        float* row = xs + b * xst;
        float am = 0.f;
        for (int c = lane; c < K; c += 32) am = fmaxf(am, fabsf(row[c]));
        for (int o = 16; o > 0; o >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
        const float r = pmt::i8_scale(am);
        for (int c = lane; c < K; c += 32) row[c] = static_cast<float>(pmt::i8_level(row[c], r));
        if (lane == 0) rsc[b] = r;
    }
    __syncthreads();
}

// GEGLU input of fc2: xs[b, k] = round_T(round_T(act(a)) * g) from the
// (B, 2*dff) pair h[b] = [a | g] that fc1 wrote
template <typename T>
__device__ void load_gated(const T* h, int B, int dff, int act, float* xs, int xst) {
    constexpr int VEC = 16 / sizeof(T);
#pragma unroll 2
    for (int i = threadIdx.x * VEC; i < B * dff; i += NT * VEC) {
        const int b = i / dff, k = i % dff;  // dff % 64 == 0: a 16-byte run stays in one row
        float a[VEC], g[VEC];
        ld16cg(h + static_cast<int64_t>(b) * 2 * dff + k, a);
        ld16cg(h + static_cast<int64_t>(b) * 2 * dff + dff + k, g);
#pragma unroll
        for (int e = 0; e < VEC; ++e) xs[b * xst + k + e] = pmt::round_to<T>(pmt::round_to<T>(act_fn<T>(a[e], act)) * g[e]);
    }
    __syncthreads();
}

// xs[b, :n] = h[b, :] for the (B, n) rows of h
template <typename T>
__device__ void load_plain(const T* h, int B, int n, float* xs, int xst) {
    constexpr int VEC = 16 / sizeof(T);
#pragma unroll 4
    for (int i = threadIdx.x * VEC; i < B * n; i += NT * VEC) {
        float v[VEC];
        ld16cg(h + i, v);
        const int b = i / n, k = i - b * n;  // n % 64 == 0: a 16-byte run stays in one row
#pragma unroll
        for (int e = 0; e < VEC; ++e) xs[b * xst + k + e] = v[e];
    }
    __syncthreads();
}

// ctx[b, h*64 + e] = round_T(merge over splits of the attention partials):
// first each (row, head)'s split weights exp(m_s - M) / L into `wsm`, then
// the weighted sum of the splits' accumulators
template <typename T>
__device__ void load_merge(const float* pm, const float* pl, const float* pacc, int B, int H, int S, float* xs,
                           int xst, float* wsm) {
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
        for (int j = 0; j < 4; ++j) xs[(i / hd) * xst + i % hd + j] = pmt::round_to<T>(a[j]);
    }
    __syncthreads();
}

// The phase inputs of the tensor-core launches (bf16 above one row group, TC): the same values as the loads
// above, into bf16 rows of K values, exact: every value a phase input holds is rounded to bf16 before the product
// (the norms' outputs and the raw residual they read, the merged attention context, the MLP hidden and its GEGLU
// gate; w8a8's int8 levels), so xs holds twice the rows of fp32. A lane moves one 16-byte chunk of 8 values at a
// time. The chunks of row b are XOR-swizzled by b & 7, so the 8 rows one ldmatrix reads at one chunk sit in 8
// distinct bank groups (k % 64 == 0: a row is a whole number of 8-chunk runs).
__device__ __forceinline__ int xs_at(int k, int b, int c) { return b * k + (((c >> 3) ^ (b & 7)) << 3) + (c & 7); }
__device__ __forceinline__ void xs_get8(const __nv_bfloat16* xs, int k, int b, int c, float* v) {
    pmt::lds16(xs + xs_at(k, b, c), v);
}
__device__ __forceinline__ void xs_put8(__nv_bfloat16* xs, int k, int b, int c, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(xs + xs_at(k, b, c)) = make_uint4(w[0], w[1], w[2], w[3]);
}

// load_ln_from into TC rows (d wide): up to 2 * NW rows, a row one warp's, its statistics summed in
// load_ln_from's order (the same bits)
template <typename Ld, typename Ready>
__device__ void load_ln_tc(Ld ld, const float* s, const float* bias, int B, int d, float eps, int rms,
                           __nv_bfloat16* xs, Ready ready) {
    constexpr int RPW = (MB + NW - 1) / NW;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float mean[RPW], rstd[RPW], sum[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int b = warp + i * NW;
        sum[i] = 0.f;
        if (b < B) {
#pragma unroll 4
            for (int c = lane * 8; c < d; c += 256) {
                float v[8];
                ld(b, c, v);
                xs_put8(xs, d, b, c, v);
#pragma unroll
                for (int e = 0; e < 8; ++e) sum[i] += v[e];
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int b = warp + i * NW;
        mean[i] = rstd[i] = 0.f;
        if (b < B) {
            mean[i] = rms ? 0.f : pmt::warp_sum(sum[i]) / d;
            __syncwarp();
            float sq = 0.f;
            for (int c = lane; c < d; c += 32) {  // load_ln_from's order, so a row's statistics keep their bits
                const float t = __bfloat162float(xs[xs_at(d, b, c)]) - mean[i];
                sq += t * t;
            }
            rstd[i] = rsqrtf(pmt::warp_sum(sq) / d + eps);
        }
    }
    ready();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int b = warp + i * NW;
        if (b < B) {
#pragma unroll 4
            for (int c = lane * 8; c < d; c += 256) {
                float v[8], sv[8], bv[8];
                xs_get8(xs, d, b, c, v);
                pmt::lds16(s + c, sv), pmt::lds16(s + c + 4, sv + 4);
                pmt::lds16(bias + c, bv), pmt::lds16(bias + c + 4, bv + 4);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    v[e] = pmt::round_to<__nv_bfloat16>((v[e] - mean[i]) * rstd[i] * sv[e] + bv[e]);
                xs_put8(xs, d, b, c, v);
            }
        }
    }
    __syncthreads();
}

// quantize_xs over TC rows of K (the levels are exact in bf16)
__device__ void quantize_tc(__nv_bfloat16* xs, int K, int B, float* rsc) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int b = warp; b < B; b += NW) {
        float am = 0.f;
        for (int c = lane * 8; c < K; c += 256) {
            float v[8];
            xs_get8(xs, K, b, c, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) am = fmaxf(am, fabsf(v[e]));
        }
        for (int o = 16; o > 0; o >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
        const float r = pmt::i8_scale(am);
        for (int c = lane * 8; c < K; c += 256) {
            float v[8];
            xs_get8(xs, K, b, c, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = static_cast<float>(pmt::i8_level(v[e], r));
            xs_put8(xs, K, b, c, v);
        }
        if (lane == 0) rsc[b] = r;
    }
    __syncthreads();
}

// load_gated / load_plain into TC rows (dff / n wide), more chunks in flight a thread
__device__ void load_gated_tc(const __nv_bfloat16* h, int B, int dff, int act, __nv_bfloat16* xs) {
#pragma unroll 4
    for (int i = threadIdx.x * 8; i < B * dff; i += NT * 8) {
        const int b = i / dff, k = i % dff;
        float a[8], g[8];
        ld16cg(h + static_cast<int64_t>(b) * 2 * dff + k, a);
        ld16cg(h + static_cast<int64_t>(b) * 2 * dff + dff + k, g);
#pragma unroll
        for (int e = 0; e < 8; ++e)
            a[e] = pmt::round_to<__nv_bfloat16>(pmt::round_to<__nv_bfloat16>(act_fn<__nv_bfloat16>(a[e], act)) * g[e]);
        xs_put8(xs, dff, b, k, a);
    }
    __syncthreads();
}

__device__ void load_plain_tc(const __nv_bfloat16* h, int B, int n, __nv_bfloat16* xs) {
#pragma unroll 8
    for (int i = threadIdx.x * 8; i < B * n; i += NT * 8) {
        float v[8];
        ld16cg(h + i, v);
        xs_put8(xs, n, i / n, i % n, v);
    }
    __syncthreads();
}

// load_merge into TC rows (H * 64 wide): the split weights as load_merge forms them, then 8 context values a lane
__device__ void load_merge_tc(const float* pm, const float* pl, const float* pacc, int B, int H, int S,
                              __nv_bfloat16* xs, float* wsm) {
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
#pragma unroll 4
    for (int i = threadIdx.x * 8; i < B * hd; i += NT * 8) {
        const int u = (i / hd) * H + (i % hd) / HEAD_D, e = i % HEAD_D;
        float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int s = 0; s < S; ++s) {
            float v[8];
            ld16cg(pacc + static_cast<int64_t>(u * S + s) * HEAD_D + e, v);
            ld16cg(pacc + static_cast<int64_t>(u * S + s) * HEAD_D + e + 4, v + 4);
            const float w = wsm[u * S + s];
#pragma unroll
            for (int j = 0; j < 8; ++j) a[j] = fmaf(v[j], w, a[j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = pmt::round_to<__nv_bfloat16>(a[j]);
        xs_put8(xs, hd, i / hd, i % hd, a);
    }
    __syncthreads();
}

// ---------------------------------------------------------------- staging

// A block's share of one weight matrix and where its staging stands. The
// share is a run of column units (WVec), balanced over the grid (every
// block gets floor or ceil of units / grid); it is read in passes of at most
// Plan::pass_cols columns, each pass in chunks of kc rows: step i = (pass,
// chunk) is copied into ring slot i % slots by the producer warp, and completes on the slot's
// mbarrier. The weights are unit-major ((L, N / cu, K, cu): cu columns of
// WVec<W>::V columns per unit, ops/decode_step.py `_unit_major`), so a step is one
// contiguous bulk copy per unit of the pass, into the slot's column of that
// unit. The phase's parameters complete on a barrier of their own.
struct Stream {
    const char* w;  // the layer's (K, N) matrix, null for a norm alone
    int K, N, u0, nu, steps, issued;
    MatPlan m;
};

// The ring's barriers (one per slot) and the two parameter barriers (staged
// phases alternate between them, as between the two parameter buffers).
struct Bars {
    unsigned long long* slot;  // (MAX_SLOTS)
    unsigned long long* par;   // (2)
};

// The producer warp issues the next step of `st` into its slot.
template <typename W>
__device__ __forceinline__ void issue_step(Stream& st, int pass_units, char* ring, Bars bars) {
    const int step = st.issued++;
    if (threadIdx.x / 32 != PRODUCER) return;
    const int lane = threadIdx.x % 32;
    const int pass = step / st.m.nchunk, chunk = step % st.m.nchunk;
    const int pu = min(pass_units, st.nu - pass * pass_units);
    const int r0 = chunk * st.m.kc, rows = min(st.m.kc, st.K - r0);
    const int slot = step % st.m.slots;
    constexpr int UB = WVec<W>::V * sizeof(W);
    if (lane == 0) mbar_expect(bars.slot + slot, static_cast<unsigned>(rows * pu * UB));
    __syncwarp();
    if (step >= st.m.slots) fence_async_shared();  // a refill: the slot was just read (begin_stream fences once)
    const int64_t unit0 = st.u0 + pass * pass_units;
    char* dst = ring + slot * st.m.slot_bytes;
    if (rows == st.K) {  // the pass's units are one contiguous run of the unit-major matrix: one copy
        if (lane == 0) bulk_copy(dst, st.w + unit0 * st.K * UB, pu * rows * UB, bars.slot + slot);
    } else if (lane < pu) {  // lane j: unit j of the pass, rows [r0, r0 + rows), into the slot's column j
        bulk_copy(dst + lane * st.m.kc * UB, st.w + ((unit0 + lane) * st.K + r0) * UB, rows * UB, bars.slot + slot);
    }
}

// What a block stages for phase `kind` of layer l: 0 qkv, 1 o, 2 q_c, 3 o_c,
// 4 fc1, 5 fc2; 6 the head's final norm alone (no matrix). Recomputed where
// it is needed, from the arguments and the plan: between phases a block
// keeps only (kind, layer, steps issued), which leaves the registers to the
// phases' own loops.
template <typename W>
__device__ __forceinline__ Stream describe(const Args& a, const Plan& p, int kind, int l, int issued) {
    constexpr int CU = WVec<W>::V;
    const int d = a.d, hd = a.hd, dff = a.dff;
    Stream st;
    const void* w = nullptr;
    st.K = st.N = 0;
    st.m = p.m[0];
    switch (kind) {
        case 0: w = a.wqkv, st.K = d, st.N = 3 * hd; break;
        case 1: w = a.wo, st.K = hd, st.N = d, st.m = p.m[1]; break;
        case 2: w = a.wqc, st.K = d, st.N = hd, st.m = p.m[2]; break;
        case 3: w = a.woc, st.K = hd, st.N = d, st.m = p.m[1]; break;
        case 4: w = a.w1, st.K = d, st.N = a.gated ? 2 * dff : dff, st.m = p.m[3]; break;
        case 5: w = a.w2, st.K = dff, st.N = d, st.m = p.m[4]; break;
        default: break;
    }
    st.w = w ? static_cast<const char*>(w) + static_cast<int64_t>(l) * st.K * st.N * sizeof(W) : nullptr;
    const int units = st.N / CU, g = gridDim.x, bx = blockIdx.x;  // units * grid fits an int
    st.u0 = bx * units / g;
    st.nu = (bx + 1) * units / g - st.u0;
    const int pu = p.pass_cols / CU;
    st.steps = (st.nu + pu - 1) / pu * st.m.nchunk;
    st.issued = issued;
    return st;
}

// Start staging phase `kind` of layer l: the block's bias columns (fc1 of a
// GEGLU MLP: only those of its first half) and int8 column scales into
// pbias and pbias + par_cols, the phase's norm scale and shift (d each) into
// pln, all on par_bar, then as many weight steps as the ring holds. Returns
// the steps issued.
template <typename W>
__device__ __forceinline__ int begin_stream(const Args& a, const Plan& p, int kind, int l, char* ring, float* pbias,
                                            float* pln, Bars bars, unsigned long long* par_bar) {
    constexpr int CU = WVec<W>::V;
    Stream st = describe<W>(a, p, kind, l, 0);
    const void *bias = nullptr, *scale = nullptr, *ln_s = nullptr, *ln_b = nullptr;
    int n_bias = st.N;
    switch (kind) {
        case 0: bias = a.bqkv, scale = a.s_qkv, ln_s = a.ln1_s, ln_b = a.ln1_b; break;
        case 1: bias = a.bo, scale = a.s_o; break;
        case 2: bias = a.bqc, scale = a.s_qc, ln_s = a.lnc_s, ln_b = a.lnc_b; break;
        case 3: bias = a.boc, scale = a.s_oc; break;
        case 4: bias = a.b1, scale = a.s_1, ln_s = a.ln2_s, ln_b = a.ln2_b, n_bias = a.dff; break;
        case 5: bias = a.b2, scale = a.s_2; break;
        default: ln_s = a.fn_s, ln_b = a.fn_b; break;
    }
    if (threadIdx.x / 32 == PRODUCER) {
        const int lane = threadIdx.x % 32, d = a.d, c0 = st.u0 * CU;
        const unsigned nb = st.w ? max(0, min(st.nu * CU, n_bias - c0)) * 4 : 0;  // bytes
        const unsigned ns = st.w && scale ? st.nu * CU * 4 : 0;
        const unsigned nl = ln_s ? d * 4 : 0;
        if (lane == 0) mbar_expect(par_bar, nb + ns + 2 * nl);
        __syncwarp();
        fence_async_shared();
        const int off = kind == 6 ? 0 : l * d;
        if (lane == 0 && nb)
            bulk_copy(pbias, static_cast<const float*>(bias) + static_cast<int64_t>(l) * n_bias + c0, nb, par_bar);
        if (lane == 1 && ns)
            bulk_copy(pbias + p.par_cols, static_cast<const float*>(scale) + static_cast<int64_t>(l) * st.N + c0, ns,
                      par_bar);
        if (lane == 2 && nl) bulk_copy(pln, static_cast<const float*>(ln_s) + off, nl, par_bar);
        if (lane == 3 && nl) bulk_copy(pln + d, static_cast<const float*>(ln_b) + off, nl, par_bar);
    }
    const int pu = p.pass_cols / CU;
    while (st.issued < min(st.steps, st.m.slots)) issue_step<W>(st, pu, ring, bars);
    return st.issued;
}

// ---------------------------------------------------------------- matvec

// The hot loop of matvec: pass `pass` of the block's share, each chunk as it
// lands in the ring (refilling the slot behind it). A lane holds one batch
// row b and one column vector v (VEC columns) of the pass and sums over its
// row subgroup's rows: the 8 lanes of a (subgroup, vector) share every
// weight load, and the pass's nv <= 4 vectors leave 4 / P subgroups per
// warp (P = nv rounded up to a power of two). Each (warp, subgroup) writes
// its partial sums to `red`; the caller adds them in order: deterministic,
// and no shuffles. B <= GR rows (one group). `first`: the first group of the
// phase waits for each step to land (and refills its slot); a later group
// reads the share the first one left whole in the ring. Returns the steps
// issued and the slots' parities.
struct Progress {
    int issued;       // the stream's steps issued
    unsigned phases;  // bit s: the parity the next wait on ring slot s waits for
};

template <bool INT, typename W>
__device__ __forceinline__ Progress accumulate(Stream st, int pass, int pass_units, const float* xs, int xst, int B,
                                            char* ring, float* red, Bars bars, unsigned phases, bool first) {
    using A = typename std::conditional<INT, int, float>::type;
    constexpr int VEC = WVec<W>::V;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int K = st.K;
    const int nv = min(pass_units, st.nu - pass * pass_units);  // the pass's column vectors (units)
    const int lp = nv <= 1 ? 0 : nv <= 2 ? 1 : 2, G = 4 >> lp;  // row subgroups per warp
    const int b = lane & 7, v = (lane >> 3) & ((1 << lp) - 1), pg = warp * G + (lane >> (3 + lp)), R = NW * G;
    const bool active = v < nv && b < B;
    A acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0;
    for (int chunk = 0, step = pass * st.m.nchunk; chunk < st.m.nchunk; ++chunk, ++step) {
        const int slot = step % st.m.slots;
        if (first) {
            mbar_wait(bars.slot + slot, (phases >> slot) & 1u);
            phases ^= 1u << slot;
        }
        const int r0 = chunk * st.m.kc, rows = min(st.m.kc, K - r0);
        const W* tile = reinterpret_cast<const W*>(ring + slot * st.m.slot_bytes) + v * st.m.kc * VEC;  // unit v
        const float* xb = xs + b * xst + r0;
        if (active) {
#pragma unroll 4
            for (int r = pg; r < rows; r += R) {
                A w[VEC];
                ldw(tile + r * VEC, w);
                const A xv = static_cast<A>(xb[r]);
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[e] = mac(acc[e], xv, w[e]);
            }
        }
        __syncthreads();  // the slot is read: refill it
        if (first && st.issued < st.steps) issue_step<W>(st, pass_units, ring, bars);
    }
    if (active) {
        A* redA = reinterpret_cast<A*>(red) + (pg * GR + b) * nv * VEC + v * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) redA[e] = acc[e];
    }
    return {st.issued, phases};
}

// out[b0 + b, n] = sum_k xs[b, k] * W[k, n] for the B <= GR rows of one
// group, over the block's share of a staged matrix, read from the ring
// only; epi(b0 + b, n, n - first column of the block, fp32 sum) finishes
// each output. W is fp32, bf16 or int8 (widened exactly); with INT (w8a8)
// xs holds int8 levels and the sums are int32, exact, converted to fp32
// once for epi. par_bar / par_parity: the barrier phase of this matrix's
// staged bias and scales. first / last: the phase's first and last group.
template <bool INT, typename W, typename Epi, typename Mark>
__device__ void matvec(Stream& st, int pass_units, const float* xs, int xst, int b0, int B, char* ring, float* red,
                       Bars bars, unsigned& phases, unsigned long long* par_bar, unsigned par_parity, bool first,
                       bool last, Epi epi, Mark mark) {
    using A = typename std::conditional<INT, int, float>::type;
    constexpr int CU = WVec<W>::V;
    const int pass_cols = pass_units * CU;
    const int passes = st.steps / st.m.nchunk;
    const A* redA = reinterpret_cast<const A*>(red);
    for (int pass = 0; pass < passes; ++pass) {
        const Progress pr = accumulate<INT, W>(st, pass, pass_units, xs, xst, B, ring, red, bars, phases, first);
        st.issued = pr.issued, phases = pr.phases;
        mbar_wait(par_bar, par_parity);  // the staged bias and scales
        __syncthreads();
        if (last && pass + 1 == passes) mark(2);
        const int nv = min(pass_units, st.nu - pass * pass_units), pc = nv * CU;
        const int n_part = NW * (nv <= 1 ? 4 : nv <= 2 ? 2 : 1);  // (warp, row subgroup) partial sums, in order
        for (int t = threadIdx.x; t < B * pc; t += NT) {
            const int b = t / pc, c = t - b * pc;
            A v = 0;
            for (int g = 0; g < n_part; ++g) v += redA[(g * GR + b) * pc + c];
            const int j = pass * pass_cols + c;
            epi(b0 + b, st.u0 * CU + j, j, static_cast<float>(v));
        }
        __syncthreads();
    }
    if (last && passes == 0) mark(2);
}

// The tensor-core matvec of the bf16 launches above one row group (B >= 9
// rows; MAXG > 1, T = bf16): mma.sync m16n8k16 bf16 x bf16 -> fp32 (bf16 and
// w8a16 weights, int8 widened to bf16 in registers: exact) or m16n8k32 s8 x
// s8 -> s32 (w8a8: exact). The batch rows are M (one or two m16 tiles, the
// rows of xs, read by ldmatrix), a column unit of the ring is one n8 tile
// (bf16: ldmatrix.trans of its K-major rows; int8: byte gathers), K is cut in
// blocks of 32. Warp w takes unit w % nv of the pass and K-part w / nv of
// NW / nv (whole blocks of 32, in order): the split comes from the block's
// share alone, not from B or the row group, and each weight fragment,
// read once from the ring, feeds every m16 tile of the group. The (K-part,
// unit) partials go to `red`, (warp, MB rows, 8 columns); the caller adds a
// unit's parts in order (deterministic). Above one row group every share
// lies whole in the ring (the planner refuses a share that would stream), so
// a pass is one step: the first group waits for its slot to land, later
// groups read it as the first one left it. Returns the slots' parities.

// the B fragments (col layout) of unit rows [32 kb, 32 kb + 32): bf16, b0 b1 of the two k16 steps; a8, b0 b1 of the
// k32 step, whose slots 4t..4t+3 hold K rows 2t, 2t+1, 2t+8, 2t+9 (+16 for b1), as mma_a8_frag packs the A side
template <bool INT, typename W>
__device__ __forceinline__ void mma_b_frags(const char* unit, int kb, int lane, uint32_t* bw) {
    if constexpr (std::is_same<W, int8_t>::value) {  // K rows of 8 bytes: lane (g, t) takes byte g of its rows
        const int g = lane / 4, t = lane % 4;
        uint32_t pr[4];  // rows (2t, 2t + 1) + 8 i: byte g of each, in the low 16 bits
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint4 q = *reinterpret_cast<const uint4*>(unit + (kb * 32 + 8 * i + 2 * t) * 8);
            pr[i] = __byte_perm(g < 4 ? q.x : q.y, g < 4 ? q.z : q.w, (g & 3) | ((4 + (g & 3)) << 4));
        }
        if constexpr (INT) {
            bw[0] = __byte_perm(pr[0], pr[1], 0x5410);
            bw[1] = __byte_perm(pr[2], pr[3], 0x5410);
        } else {  // w8a16: the levels widened to bf16, exact
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(pr[i] & 0xffu)),
                                                               static_cast<float>(static_cast<int8_t>(pr[i] >> 8)));
                bw[i] = *reinterpret_cast<const uint32_t*>(&h);
            }
        }
    } else {  // K rows of 16 bytes: lane l addresses row 32 kb + l; .trans gives each lane its column's K pairs
        pmt::ldmatrix_x4_trans(bw, unit + (kb * 32 + lane) * 16);
    }
}

// the int8 byte of a bf16 level (an integer in [-127, 127], its bits in the high half): adding 1.5 * 2^23 leaves
// its two's complement in the low 8 bits of the fp32 sum (exact; full-rate adds, no conversion instruction)
__device__ __forceinline__ uint32_t s8_of(uint32_t bits) { return __float_as_uint(__uint_as_float(bits) + 12582912.f); }

// four int8 bytes from two bf16 level pairs p, q (low, high halves): p.lo, p.hi, q.lo, q.hi
__device__ __forceinline__ uint32_t s8x4(uint32_t p, uint32_t q) {
    return __byte_perm(__byte_perm(s8_of(p << 16), s8_of(p & 0xffff0000u), 0x40),
                       __byte_perm(s8_of(q << 16), s8_of(q & 0xffff0000u), 0x40), 0x5410);
}

// the s8 A fragment of a k32 step from the two bf16 ldmatrix fragments of its k16 halves (x0, x1): slots 4t..4t+3
// take K columns 2t, 2t + 1, 2t + 8, 2t + 9 (+16 for a2, a3), as mma_b_frags packs the B side
__device__ __forceinline__ void mma_a8_frag(const uint32_t* x0, const uint32_t* x1, uint32_t* a) {
    a[0] = s8x4(x0[0], x0[2]);
    a[1] = s8x4(x0[1], x0[3]);
    a[2] = s8x4(x1[0], x1[2]);
    a[3] = s8x4(x1[1], x1[3]);
}

template <bool INT, typename W>
__device__ __forceinline__ unsigned mma_pass(const Stream& st, int pass, int nv, const __nv_bfloat16* xs, int B,
                                             const char* ring, float* red, Bars bars, unsigned phases, bool first) {
    using A = typename std::conditional<INT, int, float>::type;
    constexpr int UB = WVec<W>::V * sizeof(W);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int K = st.K, slot = pass % st.m.slots;
    if (first) {
        mbar_wait(bars.slot + slot, (phases >> slot) & 1u);
        phases ^= 1u << slot;
    }
    const int parts = NW / nv, u = warp % nv, part = warp / nv, mt = (B + 15) / 16;
    if (part < parts) {
        A acc[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][e] = 0;
        const int nkb = K / 32, kb1 = (part + 1) * nkb / parts;
        const char* unit = ring + slot * st.m.slot_bytes + static_cast<int64_t>(u) * K * UB;
        for (int kb = part * nkb / parts; kb < kb1; ++kb) {
            uint32_t bw[4];
            mma_b_frags<INT, W>(unit, kb, lane, bw);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                if (m < mt) {
                    const int r = m * 16 + (lane & 15), c = kb * 4 + (lane >> 4);
                    uint32_t x0[4], x1[4];
                    pmt::ldmatrix_x4(x0, xs + r * K + ((c ^ (r & 7)) << 3));
                    pmt::ldmatrix_x4(x1, xs + r * K + (((c + 2) ^ (r & 7)) << 3));
                    if constexpr (INT) {
                        uint32_t a[4];
                        mma_a8_frag(x0, x1, a);
                        pmt::mma_s8(acc[m], a, bw[0], bw[1]);
                    } else {
                        pmt::mma_bf16(acc[m], x0, bw[0], bw[1]);
                        pmt::mma_bf16(acc[m], x1, bw[2], bw[3]);
                    }
                }
            }
        }
        A* r = reinterpret_cast<A*>(red) + warp * MB * 8;
        const int g = lane / 4, t = lane % 4;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
            if (m < mt) {
                r[(m * 16 + g) * 8 + 2 * t] = acc[m][0];
                r[(m * 16 + g) * 8 + 2 * t + 1] = acc[m][1];
                r[(m * 16 + g + 8) * 8 + 2 * t] = acc[m][2];
                r[(m * 16 + g + 8) * 8 + 2 * t + 1] = acc[m][3];
            }
        }
    }
    __syncthreads();
    return phases;
}

// out[b0 + b, n] = sum_k xs[b, k] * W[k, n] for the B <= MB rows of xs (bf16, TC rows of st.K: xs_at) on the tensor
// cores, as `matvec` does it on the CUDA cores; epi(b0 + b, n, n - first column of the block, fp32 sum)
template <bool INT, typename W, typename Epi, typename Mark>
__device__ void matvec_mma(const Stream& st, int pass_units, const __nv_bfloat16* xs, int b0, int B, const char* ring,
                           float* red, Bars bars, unsigned& phases, unsigned long long* par_bar, unsigned par_parity,
                           bool first, bool last, Epi epi, Mark mark) {
    using A = typename std::conditional<INT, int, float>::type;
    constexpr int CU = WVec<W>::V;
    const int passes = st.steps;  // one step a pass (the share is whole in the ring)
    const A* redA = reinterpret_cast<const A*>(red);
    for (int pass = 0; pass < passes; ++pass) {
        const int nv = min(pass_units, st.nu - pass * pass_units), parts = NW / nv, pc = nv * CU;
        phases = mma_pass<INT, W>(st, pass, nv, xs, B, ring, red, bars, phases, first);
        mbar_wait(par_bar, par_parity);  // the staged bias and scales
        if (last && pass + 1 == passes) mark(2);
        for (int i = threadIdx.x; i < B * pc; i += NT) {
            const int b = i / pc, c = i - b * pc, u = c / CU, j = c % CU;
            A v = 0;
            for (int q = 0; q < parts; ++q) v += redA[((q * nv + u) * MB + b) * CU + j];
            const int col = pass * pass_units * CU + c;
            epi(b0 + b, st.u0 * CU + col, col, static_cast<float>(v));
        }
        __syncthreads();
    }
    if (last && passes == 0) mark(2);
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

// ---------------------------------------------------------------- head

// The head phase's scores of one block's vocab rows [r0, r1) against the B
// <= NG * GR normed rows in xs (stride hst): each key group of 8 lanes takes
// a vocab row, its lanes split d, and every batch row's sum stays in
// registers, so the head is read once at any B. Scores are rounded to T
// (bf16: as the logits of a bf16 head matmul would be), or with `xq` (the
// a8 head: (B, d / 4) packed int8 rows) f32(dot_i32) * emb_s[v]. After the
// key group's shuffles every lane holds every row's sum; lane gl keeps the
// best (value, lowest index) of rows gl, gl + GR, ... and writes it to
// sv / si[(key group, row)]. NG is the row groups: an instantiation per
// count keeps a batch of one group from issuing four groups' FMAs, and
// from three groups on a lane holds U = 2 (not 4) 16-byte weight loads in
// flight, so that its R sums, the loads and the bests fit its registers.
// Not inlined, so that its R = 32 sums stay out of the kernel's own register
// allocation (an inlined copy measured the same at B = 8). It takes values,
// not the kernel's Args by reference: the address of a kernel parameter
// moved every Args read of the kernel to local memory (+35% at B = 8).
template <typename T, int NG>
__device__ __noinline__ void head_scores(const void* emb_v, const float* emb_s, int d, const float* xs, int hst,
                                         const int* xq, int B, int r0, int r1, float* sv, int* si) {
    constexpr int R = NG * GR, U = NG <= 2 ? 4 : 2;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, grp = lane / 8, gl = lane % 8;
    float bv[NG];
    int bi[NG];
#pragma unroll
    for (int j = 0; j < NG; ++j) bv[j] = pmt::neg_inf(), bi[j] = INT_MAX;
    if (xq) {
        const int8_t* emb = static_cast<const int8_t*>(emb_v);
        const int d4 = d / 4;
        for (int rb = r0 + warp * 4; rb < r1; rb += NW * 4) {  // warp-uniform trip count
            const int r = rb + grp;
            const bool ok = r < r1;
            int acc[R];
#pragma unroll
            for (int b = 0; b < R; ++b) acc[b] = 0;
            if (ok) {
                for (int c0 = gl * 16; c0 < d; c0 += 8 * 16) {
                    const int4 w = __ldg(reinterpret_cast<const int4*>(emb + static_cast<int64_t>(r) * d + c0));
#pragma unroll
                    for (int b = 0; b < R; ++b)
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
            for (int b = 0; b < R; ++b)
                if (b < B) {
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 1);
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 2);
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 4);
                    const float sc = __fmul_rn(__int2float_rn(acc[b]), es);
                    if (b % GR == gl && ok && better(sc, r, bv[b / GR], bi[b / GR])) bv[b / GR] = sc, bi[b / GR] = r;
                }
        }
    } else {
        constexpr int VEC = 16 / sizeof(T);
        const T* emb = static_cast<const T*>(emb_v);
        for (int rb = r0 + warp * 4; rb < r1; rb += NW * 4) {  // warp-uniform trip count
            const int r = rb + grp;
            const bool ok = r < r1;
            float acc[R];
#pragma unroll
            for (int b = 0; b < R; ++b) acc[b] = 0.f;
            if (ok) {
                for (int c0 = gl * VEC; c0 < d; c0 += U * 8 * VEC) {  // U 16-byte loads in flight
                    float w[U][VEC];
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int c = c0 + u * 8 * VEC;
                        if (c < d)
                            ld16(emb + static_cast<int64_t>(r) * d + c, w[u]);
                        else
#pragma unroll
                            for (int e = 0; e < VEC; ++e) w[u][e] = 0.f;
                    }
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int c = min(c0 + u * 8 * VEC, d - VEC);  // past the row end w is 0
#pragma unroll
                        for (int b = 0; b < R; ++b)
                            if (b < B)
#pragma unroll
                                for (int e = 0; e < VEC; ++e) acc[b] = fmaf(xs[b * hst + c + e], w[u][e], acc[b]);
                    }
                }
            }
#pragma unroll
            for (int b = 0; b < R; ++b)
                if (b < B) {
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 1);
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 2);
                    acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], 4);
                    const float sc = pmt::round_to<T>(acc[b]);
                    if (b % GR == gl && ok && better(sc, r, bv[b / GR], bi[b / GR])) bv[b / GR] = sc, bi[b / GR] = r;
                }
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NG; ++j) {
        const int b = j * GR + gl;
        if (b < B) {
            sv[(warp * 4 + grp) * B + b] = bv[j];
            si[(warp * 4 + grp) * B + b] = bi[j];
        }
    }
}

// The head phase of the bf16 launches above one row group on the tensor
// cores, as csrc/greedy_head.cu does it: vocab rows on M (a warp takes 16
// rows at a time, its block's rows in tiles NW apart), the B <= MB normed
// rows on N (n8 tiles), d on K. A lane loads 16 bytes of each of its two
// vocab rows per 64-byte run straight from device memory (no staging: each
// vocab row is read once per launch, and the loads of U runs are in
// flight together), so within a run the K order is permuted, alike on both
// sides: bf16, two k16 steps whose slots 2t, 2t + 1 | 2t + 8, 2t + 9 take the
// run's elements 8t + 4s + 0, 1 | 2, 3 (step s); a8, one k32 step per 32
// bytes whose slots 4t..4t+3 | +16 take bytes 16t + 8s + 0..3 | 4..7. The
// batch side is one 16-byte load per run and n8 tile: the bf16 rows of xs
// (xs_at: chunk (4 j + t) ^ (row & 7)) or the a8 head's int8 rows
// `xq` (stride d + 16 bytes). Scores are rounded to T (bf16: as the logits
// of a bf16 head matmul) or, a8, f32(dot_i32) * emb_s[v] (exact products,
// the same score as the CUDA-core head). Lane (g, t) keeps the best (value,
// lowest index) of batch columns 2t, 2t + 1 of each n8 tile; the 8 lanes of
// a column merge by shuffles and write sv / si[(warp, column)].
template <typename T, bool A8>
__device__ __forceinline__ void head_tiles(const char* emb, const float* emb_s, int row_bytes, const char* xb,
                                           int x_stride, int B, int r0, int r1, float (&bv)[4][2], int (&bi)[4][2]) {
    using Acc = typename std::conditional<A8, int, float>::type;
    constexpr int U = 4;  // 64-byte runs of both rows in flight
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int ntn = (B + 7) / 8;
    for (int v0 = r0 + warp * 16; v0 < r1; v0 += NW * 16) {  // warp-uniform trip count
        const char* pa = emb + static_cast<int64_t>(min(v0 + g, r1 - 1)) * row_bytes + 16 * t;
        const char* pb = emb + static_cast<int64_t>(min(v0 + g + 8, r1 - 1)) * row_bytes + 16 * t;
        Acc acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0;
        for (int k0 = 0; k0 < row_bytes; k0 += 64 * U) {
            uint4 wa[U], wb[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const bool in = k0 + 64 * u < row_bytes;
                wa[u] = in ? __ldg(reinterpret_cast<const uint4*>(pa + k0 + 64 * u)) : make_uint4(0, 0, 0, 0);
                wb[u] = in ? __ldg(reinterpret_cast<const uint4*>(pb + k0 + 64 * u)) : make_uint4(0, 0, 0, 0);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int j = k0 / 64 + u;  // the 64-byte run
                if (64 * j >= row_bytes) break;
                const uint32_t a0[4] = {wa[u].x, wb[u].x, wa[u].y, wb[u].y};
                const uint32_t a1[4] = {wa[u].z, wb[u].z, wa[u].w, wb[u].w};
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    if (n < ntn) {
                        const int row = n * 8 + g;
                        uint4 x = make_uint4(0, 0, 0, 0);
                        if (row < B)
                            x = *reinterpret_cast<const uint4*>(xb + row * x_stride +
                                                                (((4 * j + t) ^ (A8 ? 0 : row & 7)) << 4));
                        if constexpr (A8) {
                            pmt::mma_s8(acc[n], a0, x.x, x.y);
                            pmt::mma_s8(acc[n], a1, x.z, x.w);
                        } else {
                            pmt::mma_bf16(acc[n], a0, x.x, x.y);
                            pmt::mma_bf16(acc[n], a1, x.z, x.w);
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = v0 + g + (e >> 1) * 8, col = n * 8 + 2 * t + (e & 1);
                if (n < ntn && row < r1 && col < B) {
                    float sc;
                    if constexpr (A8)
                        sc = __fmul_rn(__int2float_rn(acc[n][e]), __ldg(emb_s + row));
                    else
                        sc = pmt::round_to<T>(acc[n][e]);
                    if (better(sc, row, bv[n][e & 1], bi[n][e & 1])) bv[n][e & 1] = sc, bi[n][e & 1] = row;
                }
            }
        }
    }
}

// The head phase's scores of one block's vocab rows [r0, r1) on the tensor cores (head_tiles): the bf16 head
// against the B bf16 rows of xs (xs_at, d wide), or the a8 head against `xq`; every warp's best per batch row to
// sv / si[warp * B + row]. Not inlined, as head_scores.
template <typename T>
__device__ __noinline__ void head_mma(const void* emb_v, const float* emb_s, int d, const __nv_bfloat16* xs,
                                      const int8_t* xq, int B, int r0, int r1, float* sv, int* si) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    float bv[4][2];
    int bi[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) bv[n][0] = bv[n][1] = pmt::neg_inf(), bi[n][0] = bi[n][1] = INT_MAX;
    const char* emb = static_cast<const char*>(emb_v);
    if (xq)
        head_tiles<T, true>(emb, emb_s, d, reinterpret_cast<const char*>(xq), d + 16, B, r0, r1, bv, bi);
    else
        head_tiles<T, false>(emb, emb_s, 2 * d, reinterpret_cast<const char*>(xs), 2 * d, B, r0, r1, bv, bi);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float v = bv[n][h];
            int i = bi[n][h];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {  // the 8 lanes of one column pair (same t)
                const float ov = __shfl_xor_sync(0xffffffffu, v, o);
                const int oi = __shfl_xor_sync(0xffffffffu, i, o);
                if (better(ov, oi, v, i)) v = ov, i = oi;
            }
            const int col = n * 8 + 2 * t + h;
            if (g == 0 && col < B) sv[warp * B + col] = v, si[warp * B + col] = i;
        }
    }
}

// ---------------------------------------------------------------- kernel

// MAXG: the most row groups the instantiation serves, 1 (B <= GR) or MB / GR. The one-group kernel compiles none
// of the multi-group paths (whole-batch loads, two rows a warp in the norm, the head's wider instantiations),
// which keeps its register allocation that of a kernel serving 8 rows.
template <typename T, typename W, int MAXG>
__global__ void __launch_bounds__(NT, 1) decode_step_kernel(Args a, Plan p) {
    constexpr int RPW = MAXG == 1 ? 1 : (MB + NW - 1) / NW;  // norm rows a warp holds
    // the bf16 launches above one row group: matvec passes and the head on the tensor cores, xs in bf16
    constexpr bool TC = MAXG > 1 && std::is_same<T, __nv_bfloat16>::value;
    extern __shared__ float smem[];
    cg::grid_group grid = cg::this_grid();
    const int B = a.b, d = a.d, hd = a.hd, dff = a.dff, H = a.n_heads, Lp = a.l_max, pos = a.pos;
    float* xs = smem;
    __nv_bfloat16* const xsb = reinterpret_cast<__nv_bfloat16*>(smem);  // TC: bf16 rows (xs_at)
    float* red = smem + p.xs_floats;
    float* rsc = red + p.red_bytes / 4;  // (MB) w8a8 row scales of the phase input, by batch row
    float* par = rsc + MB;               // two (bias, scales) buffers: matrices alternate between them
    unsigned long long* bar_mem = reinterpret_cast<unsigned long long*>(par + 4 * p.par_cols);
    const Bars bars{bar_mem, bar_mem + MAX_SLOTS};
    char* ring = reinterpret_cast<char*>(bar_mem + MAX_SLOTS + 2);
    // the staged norm's scale and shift (2 d): past the last row's d values, where no norm input reaches
    float* pln = xs + p.pln_off;
    const int NG = MAXG == 1 ? 1 : (B + GR - 1) / GR;  // row groups

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
    // a column's sum -> its dequantized fp32 value: w8a8 row scale, then the int8 weights' staged column scale
    auto deq = [=](int b, float v, const float* s, int j) {
        if (a8) v = __fmul_rn(v, rsc[b]);
        if (s) v = __fmul_rn(v, s[j]);
        return v;
    };
    // phase timing (a.stamps): thread 0 stamps point k of phase `ph`; `sync` ends a phase at the grid barrier
    long long* const stamps = a.stamps;
    int ph = 0;
    auto mark = [&](int k) {
        if (stamps && threadIdx.x == 0)
            stamps[(static_cast<int64_t>(ph) * gridDim.x + blockIdx.x) * 4 + k] = globaltimer();
    };
    // the phase whose data the next barrier stages (then(kind, l)), -1: none
    int pend_kind = -1, pend_l = 0;
    auto then = [&](int kind, int l) { pend_kind = kind, pend_l = l; };

    // staging: the phase the next matvec reads (cur_*: begun a phase or two earlier) and the one after it
    // (nxt_*), each as (kind, layer, steps issued, sequence number: its parity picks the bias / scale buffer)
    int cur_kind = 0, cur_l = 0, cur_issued = 0, cur_seq = 0, nxt_kind = 0, nxt_l = 0, nxt_issued = 0, nxt_seq = 0;
    int n_staged = 0;
    const int wt_int8 = a.wt_int8;
    auto stage = [&](int kind, int l) {
        nxt_kind = kind, nxt_l = l, nxt_seq = n_staged++;
        nxt_issued = begin_stream<W>(a, p, kind, l, ring, par + (nxt_seq & 1) * 2 * p.par_cols, pln, bars,
                                     bars.par + (nxt_seq & 1));
    };
    auto advance = [&]() { cur_kind = nxt_kind, cur_l = nxt_l, cur_issued = nxt_issued, cur_seq = nxt_seq; };
    auto cur_bias = [&]() { return static_cast<const float*>(par + (cur_seq & 1) * 2 * p.par_cols); };
    auto cur_scales = [&]() { return wt_int8 ? cur_bias() + p.par_cols : nullptr; };
    // end of a phase: arrive at the grid barrier, start staging the next matvec phase's data (then()) while the
    // other blocks arrive, then wait
    auto sync = [&]() {
        mark(3);
        auto token = grid.barrier_arrive();
        if (pend_kind >= 0) {
            stage(pend_kind, pend_l);
            advance();
            pend_kind = -1;
        }
        grid.barrier_wait(std::move(token));
        ++ph;
        mark(0);
    };
    // the staged norm parameters (the current phase's first group) have landed in every thread's view
    auto ln_ready = [&]() { mbar_wait(bars.par + (cur_seq & 1), (cur_seq >> 1) & 1); };
    unsigned slot_phases = 0;
    // xg (rows b0 .. b0 + nb of the batch, stride xst) -> out columns of the current matrix: fp32 / bf16 / int8
    // weights, or w8a8's int8 x int8 over the row-quantized xg
    auto mv = [&](auto epi, float* xg, int xst, int b0, int nb, bool first, bool last) {
        constexpr int PU = WVec<W>::V;
        Stream st = describe<W>(a, p, cur_kind, cur_l, cur_issued);
        const int pu = p.pass_cols / PU;
        unsigned long long* pb = bars.par + (cur_seq & 1);
        const unsigned pp = (cur_seq >> 1) & 1;
        if constexpr (std::is_same<W, int8_t>::value) {
            if (a8) {
                quantize_xs(xg, xst, nb, st.K, rsc + b0);
                matvec<true, W>(st, pu, xg, xst, b0, nb, ring, red, bars, slot_phases, pb, pp, first, last, epi, mark);
                return;
            }
        }
        matvec<false, W>(st, pu, xg, xst, b0, nb, ring, red, bars, slot_phases, pb, pp, first, last, epi, mark);
    };
    // the same on the tensor cores (TC): rows b0 .. b0 + nb of the batch in xs as TC's bf16 rows of K
    auto mv_mma = [&](auto epi, int K, int b0, int nb, bool first, bool last) {
        const Stream st = describe<W>(a, p, cur_kind, cur_l, cur_issued);
        const int pu = p.pass_cols / WVec<W>::V;
        unsigned long long* pb = bars.par + (cur_seq & 1);
        const unsigned pp = (cur_seq >> 1) & 1;
        if constexpr (std::is_same<W, int8_t>::value) {
            if (a8) {
                quantize_tc(xsb, K, nb, rsc + b0);
                matvec_mma<true, W>(st, pu, xsb, b0, nb, ring, red, bars, slot_phases, pb, pp, first, last, epi, mark);
                return;
            }
        }
        matvec_mma<false, W>(st, pu, xsb, b0, nb, ring, red, bars, slot_phases, pb, pp, first, last, epi, mark);
    };
    // one matvec phase of input width K over the row groups: load(b0, nb, xst) puts rows [b0, b0 + nb) of the
    // phase input in xs rows [0, nb) at stride xst (TC: bf16 rows of K); the block's share (resident in the ring
    // after the first group) multiplies each group; epi finishes each output. Where the batch's rows fit below
    // the staged norm at stride K + 4 (the norm inputs and the attention context of d and H*D columns; not the MLP
    // hidden), the whole batch is loaded at once, one chain of L2 round trips instead of one per group
    auto grouped = [&](int K, auto load, auto epi) {
        if constexpr (TC) {
            // bf16 rows of K: the whole batch where its m16 tiles fit, else groups of 16 rows (GPT-2's 3,072-wide MLP
            // hidden). A norm input's rows stay below the staged norm parameters (pln, the end of xs); the other
            // inputs (K != d) may cover them: a norm's parameters are staged at the barrier before its phase and
            // read in it only
            const int fit = (K == d ? p.pln_off * 4 : static_cast<int>(p.xs_floats) * 4) / (2 * K);
            const int rows = (B + 15) / 16 * 16 <= fit ? B : (fit >= 16 ? fit / 16 * 16 : fit);
            for (int b0 = 0; b0 < B; b0 += rows) {
                const int nb = min(rows, B - b0);
                load(b0, nb, K);
                if (b0 == 0) mark(1);
                mv_mma(epi, K, b0, nb, b0 == 0, b0 + nb == B);
            }
        } else {
            if constexpr (MAXG > 1) {
                const int wst = K + 4;
                if (NG > 1 && (B - 1) * wst + K <= p.pln_off) {
                    load(0, B, wst);
                    mark(1);
                    for (int g = 0; g < NG; ++g) {
                        const int b0 = g * GR;
                        mv(epi, xs + b0 * wst, wst, b0, min(GR, B - b0), g == 0, g + 1 == NG);
                    }
                    return;
                }
            }
            for (int g = 0; g < NG; ++g) {
                const int b0 = g * GR, nb = min(GR, B - b0);
                load(b0, nb, p.xs_stride);
                if (g == 0) mark(1);
                mv(epi, xs, p.xs_stride, b0, nb, g == 0, g + 1 == NG);
            }
        }
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

    mark(0);
    if (threadIdx.x == 0) {
        for (int i = 0; i < MAX_SLOTS + 2; ++i) mbar_init(bar_mem + i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    stage(0, 0);
    advance();
    for (int l = 0; l < a.n_layers; ++l) {
        const T* xp = l == 0 ? x_in : xr;  // the residual entering this layer
        const bool emb0 = l == 0 && a.embed;
        const int64_t kv_off = l * a.kv_stride;  // the caches' layer strides: launch_groups resolves a 0

        // residual += round(acc + bias), in the compute dtype
        auto residual = [&](const T* src, bool from_embed) {
            const float *bias = cur_bias(), *sc = cur_scales();
            return [=](int b, int c, int j, float v) {
                const int64_t i = static_cast<int64_t>(b) * d + c;
                const float x = from_embed ? x0(b, c) : ldcg1(src + i);
                xr[i] = pmt::from_f32<T>(x + pmt::round_to<T>(deq(b, v, sc, j) + bias[j]));
            };
        };

        // (a) LN1 + QKV; k/v land in the cache at pos (int8 self-KV: in scratch, quantized by the attention units)
        auto ln_rows = [&](const T* src) {  // rows of the norm input
            return [=](int b0, int nb, int xst) {
                if constexpr (TC)
                    load_ln_tc([=](int b, int c, float* v) { ld16cg(src + static_cast<int64_t>(b0 + b) * d + c, v); },
                               pln, pln + d, nb, d, a.eps, a.norm, xsb, ln_ready);
                else
                    load_ln<T, RPW>(src + static_cast<int64_t>(b0) * d, pln, pln + d, nb, d, a.eps, a.norm, xs, xst,
                                    ln_ready);
            };
        };
        T* kc = static_cast<T*>(a.k_cache) + kv_off;
        T* vc = static_cast<T*>(a.v_cache) + kv_off;
        const int kv_int8 = a.kv_int8;
        {
            const float *bias = cur_bias(), *sc = cur_scales();
            auto epi = [=](int b, int c, int j, float v) {
                const T y = pmt::from_f32<T>(deq(b, v, sc, j) + bias[j]);
                if (c < hd)
                    qs[b * hd + c] = y;
                else if (kv_int8)
                    (c < 2 * hd ? kn : vn)[b * hd + (c - hd) % hd] = y;
                else if (c < 2 * hd)
                    kc[(static_cast<int64_t>(b) * Lp + pos) * hd + c - hd] = y;
                else
                    vc[(static_cast<int64_t>(b) * Lp + pos) * hd + c - 2 * hd] = y;
            };
            if (emb0)
                grouped(
                    d,
                    [&](int b0, int nb, int xst) {
                        auto ld = [=](int b, int c, float* v) {
                            for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e) v[e] = x0(b0 + b, c + e);
                        };
                        if constexpr (TC)
                            load_ln_tc(ld, pln, pln + d, nb, d, a.eps, a.norm, xsb, ln_ready);
                        else
                            load_ln_from<T, RPW>(ld, pln, pln + d, nb, d, a.eps, a.norm, xs, xst, ln_ready);
                    },
                    epi);
            else
                grouped(d, ln_rows(xp), epi);
            then(1, l);
        }
        sync();

        // (b) self-attention over [min(pad_b, pos), pos]; the O projection's slab is being staged meanwhile
        mark(1);
        if (kv_int8) {
            int8_t* kq = static_cast<int8_t*>(a.k_cache) + kv_off;
            int8_t* vq = static_cast<int8_t*>(a.v_cache) + kv_off;
            const int64_t s_off = l * a.kvs_stride;
            float* ks = static_cast<float*>(a.ks) + s_off;
            float* vs = static_cast<float*>(a.vs) + s_off;
            int8_units(kq, vq, ks, vs, Lp, true, kq, vq, ks, vs);
        } else {
            attention<T>(qs, kc, vc, Lp, B, H, p.split, a.scale,
                         [=](int b, int& start, int& end) {
                             start = pads ? min(max(__ldg(pads + b), 0), pos) : 0;
                             end = pos + 1;
                         },
                         sbias, pm, pl, pacc, red);
        }
        mark(2);
        sync();

        // (c) O projection + residual; its input: a group's attention context, merged from the partials (the
        // int8 units wrote it whole into qs)
        auto ctx_rows = [&](bool int8) {
            return [&, int8](int b0, int nb, int xst) {
                const T* q = static_cast<const T*>(qs) + static_cast<int64_t>(b0) * hd;
                const int u0 = b0 * H * p.split;
                if constexpr (TC) {
                    if (int8)
                        load_plain_tc(q, nb, hd, xsb);
                    else
                        load_merge_tc(pm + u0, pl + u0, pacc + static_cast<int64_t>(u0) * HEAD_D, nb, H, p.split, xsb,
                                      red);
                } else if (int8) {
                    load_plain(q, nb, hd, xs, xst);
                } else {
                    load_merge<T>(pm + u0, pl + u0, pacc + static_cast<int64_t>(u0) * HEAD_D, nb, H, p.split, xs,
                                  xst, red);
                }
            };
        };
        grouped(hd, ctx_rows(kv_int8), residual(xp, emb0));
        then(a.has_cross ? 2 : 4, l);
        sync();

        if (a.has_cross) {
            // (d) LN_c + q_c | cross-attention over [0, len_b) | O_c + residual
            {
                const float *bias = cur_bias(), *sc = cur_scales();
                grouped(d, ln_rows(xr), [=](int b, int c, int j, float v) {
                    qs[b * hd + c] = pmt::from_f32<T>(deq(b, v, sc, j) + bias[j]);
                });
                then(3, l);
            }
            sync();
            mark(1);
            const int lx = a.lx;
            const int64_t xoff = l * a.xkv_stride;
            if (a.kvx_int8) {
                const int64_t soff = l * a.xkvs_stride;
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
            mark(2);
            sync();
            grouped(hd, ctx_rows(a.kvx_int8), residual(xr, false));
            then(4, l);
            sync();
        }

        // (e) LN2 + fc1 + activation | fc2 + residual (GEGLU: fc1 writes the pair, fc2's load gates it)
        const int act = a.act, gated = a.gated, n1 = gated ? 2 * dff : dff;
        {
            const float *bias = cur_bias(), *sc = cur_scales();
            grouped(d, ln_rows(xr), [=](int b, int c, int j, float v) {
                v = deq(b, v, sc, j);
                if (gated)
                    hbuf[b * n1 + c] = pmt::from_f32<T>(c < dff ? v + bias[j] : v);
                else
                    hbuf[b * dff + c] = pmt::from_f32<T>(act_fn<T>(pmt::round_to<T>(v + bias[j]), act));
            });
            then(5, l);
        }
        sync();
        grouped(
            dff,
            [&](int b0, int nb, int xst) {
                const T* h = static_cast<const T*>(hbuf) + static_cast<int64_t>(b0) * n1;
                if constexpr (TC) {
                    if (gated)
                        load_gated_tc(h, nb, dff, act, xsb);
                    else
                        load_plain_tc(h, nb, dff, xsb);
                } else if (gated) {
                    load_gated(h, nb, dff, act, xs, xst);
                } else {
                    load_plain(h, nb, dff, xs, xst);
                }
            },
            residual(xr, false));
        if (l + 1 < a.n_layers)
            then(0, l + 1);
        else if (a.has_head)
            then(6, 0);
        if (l + 1 < a.n_layers || a.has_head) sync();
    }
    if (!a.has_head) {
        mark(3);
        return;
    }

    // head: final LN of all B rows (at the head's stride; TC: bf16 rows of d), then each block's vocab chunk ->
    // best (value, index) per row
    float* hv = reinterpret_cast<float*>(ws + p.off_hv);
    int* hi = reinterpret_cast<int*>(ws + p.off_hi);
    const int hst = p.hs_stride;
    if constexpr (TC)
        load_ln_tc([=](int b, int c, float* v) { ld16cg(xr + static_cast<int64_t>(b) * d + c, v); }, pln, pln + d, B, d,
                   a.eps, a.norm, xsb, ln_ready);
    else
        load_ln<T, RPW>(static_cast<const T*>(xr), pln, pln + d, B, d, a.eps, a.norm, xs, hst, ln_ready);
    mark(1);
    {
        const int chunk = (a.vocab + gridDim.x - 1) / gridDim.x;
        const int r0 = blockIdx.x * chunk, r1 = min(a.vocab, r0 + chunk);
        const int n_best = TC ? NW : NW * 4;                  // the bests per row: a warp's (TC) or a key group's
        float* sv = red;                                      // (n_best, B)
        int* si = reinterpret_cast<int*>(red + n_best * B);  // (n_best, B)
        if constexpr (TC) {
            int8_t* xq = nullptr;  // a8: (B, d) int8 rows at a stride of d + 16 bytes (no bank conflicts)
            if (a.head_a8) {
                // w8a8 head: the hidden state's int8 levels against its row absmax (the row scale is never
                // applied: it does not move a row's argmax)
                xq = reinterpret_cast<int8_t*>(red + 2 * n_best * B);
                quantize_tc(xsb, d, B, rsc);
                for (int i = threadIdx.x * 8; i < B * d; i += NT * 8) {
                    const int b = i / d, c = i % d;
                    float v[8];
                    xs_get8(xsb, d, b, c, v);
                    unsigned u[2] = {0u, 0u};
                    for (int e = 0; e < 8; ++e)
                        u[e / 4] |= (static_cast<unsigned>(static_cast<int>(v[e])) & 0xffu) << (8 * (e % 4));
                    *reinterpret_cast<uint2*>(xq + b * (d + 16) + c) = make_uint2(u[0], u[1]);
                }
                __syncthreads();
            }
            head_mma<T>(a.emb, fp(a.emb_s), d, xsb, xq, B, r0, r1, sv, si);
        } else {
            int* xq = nullptr;  // a8: (B, d / 4) packed int8 rows
            if (a.head_a8) {
                // w8a8 head: the hidden state's int8 levels against its row absmax (the row scale is never
                // applied: it does not move a row's argmax), packed four to an int for __dp4a
                xq = reinterpret_cast<int*>(red + NW * 4 * B * 2);
                quantize_xs(xs, hst, B, d, rsc);
                for (int i = threadIdx.x; i < B * d / 4; i += NT) {
                    unsigned u = 0;
                    for (int e = 0; e < 4; ++e)
                        u |= (static_cast<unsigned>(static_cast<int>(xs[(4 * i / d) * hst + 4 * i % d + e])) & 0xffu)
                             << (8 * e);
                    xq[i] = static_cast<int>(u);
                }
                __syncthreads();
            }
            if constexpr (MAXG == 1) {
                head_scores<T, 1>(a.emb, fp(a.emb_s), d, xs, hst, xq, B, r0, r1, sv, si);
            } else {
                switch (NG) {  // the row groups' sums in registers: an instantiation per group count
                    case 1: head_scores<T, 1>(a.emb, fp(a.emb_s), d, xs, hst, xq, B, r0, r1, sv, si); break;
                    case 2: head_scores<T, 2>(a.emb, fp(a.emb_s), d, xs, hst, xq, B, r0, r1, sv, si); break;
                    case 3: head_scores<T, 3>(a.emb, fp(a.emb_s), d, xs, hst, xq, B, r0, r1, sv, si); break;
                    default: head_scores<T, 4>(a.emb, fp(a.emb_s), d, xs, hst, xq, B, r0, r1, sv, si); break;
                }
            }
        }
        mark(2);
        __syncthreads();
        if (threadIdx.x < B) {
            const int b = threadIdx.x;
            float v = pmt::neg_inf();
            int i = INT_MAX;
            for (int g = 0; g < n_best; ++g)
                if (better(sv[g * B + b], si[g * B + b], v, i)) v = sv[g * B + b], i = si[g * B + b];
            hv[b * gridDim.x + blockIdx.x] = v;
            hi[b * gridDim.x + blockIdx.x] = i;
        }
    }
    sync();
    mark(1);
    mark(2);
    if (blockIdx.x != 0) {
        mark(3);
        return;
    }
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
    mark(3);
}

// ---------------------------------------------------------------- host side

size_t align256(size_t n) { return (n + 255) / 256 * 256; }
size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Staging of one (K, N) matrix of W over `grid` blocks: the largest share
// (ceil(units / grid) column units of ub bytes) in passes of `pass_units`. The
// whole share goes into the ring ahead of its phase, in up to MAX_SLOTS
// steps, when it fits; else the ring streams it in 4 (or 2) slots of as many
// rows as fit, refilled as the matvec reads them.
// Returns the ring bytes the whole share takes (SIZE_MAX: more than MAX_SLOTS steps; 0: no plan).
size_t mat_plan(int K, int N, int cu, int ub, int grid, int pass_units, size_t ring, MatPlan& m) {
    const int umax = (N / cu + grid - 1) / grid;
    const int passes = (umax + pass_units - 1) / pass_units;
    const size_t rowb = static_cast<size_t>(umax < pass_units ? umax : pass_units) * ub;
    const int c = 1;  // a whole share is one step per pass: the fewest waits and copy issues
    int kc = (K + c - 1) / c;
    const int steps = passes * ((K + kc - 1) / kc);
    const size_t whole = steps <= MAX_SLOTS ? steps * kc * rowb : 0;
    if (whole && whole <= ring) {
        m.slots = steps;
    } else {
        m.slots = 4;
        kc = static_cast<int>(ring / (4 * rowb));
        if (kc < 16) m.slots = 2, kc = static_cast<int>(ring / (2 * rowb));
        kc = kc / 8 * 8;
        if (kc < 8) return 0;
        kc = kc < K ? kc : K;
    }
    m.kc = kc;
    m.nchunk = (K + kc - 1) / kc;
    m.steps = passes * m.nchunk;
    m.slot_bytes = static_cast<int>(kc * rowb);  // (units, kc) rows of one unit, unit-major
    return whole ? whole : SIZE_MAX;
}

}  // namespace

template <typename T, typename W, int MAXG>
int plan(const Args& a, Plan& p) {
    constexpr int CU = WVec<W>::V, UB = CU * sizeof(W);
    if (a.b < 1 || a.b > MB || a.hd != a.n_heads * HEAD_D || a.d % 64 || a.hd % 64 || a.dff % 64)
        return static_cast<int>(cudaErrorInvalidValue);
    static int sms = 0, optin = 0;
    if (sms == 0) {
        int dev = 0, coop = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
        if (e != cudaSuccess) {
            sms = 0;
            cudaGetLastError();  // a refused plan answers the caller; it must not fail the next launch's check
            return static_cast<int>(e);
        }
    }
    // one block per SM (NT threads at the register cap fill an SM's register file); the occupancy check below
    const int grid = sms;
    const int n1 = a.gated ? 2 * a.dff : a.dff;
    const int kmax = a.d > a.dff ? (a.d > a.hd ? a.d : a.hd) : (a.dff > a.hd ? a.dff : a.hd);
    // xs holds a row group's phase input (G <= GR rows of K) in rows of kmax + 4 floats, the head's B normed
    // rows (at that stride up to GR rows, else at d + 4), and, past the last normed row's d values of either,
    // the staged norm parameters (2 d)
    const int G = a.b < GR ? a.b : GR;
    const int xst = kmax + 4, hst = a.b <= GR ? xst : a.d + 4;
    const size_t pln_a = static_cast<size_t>(G - 1) * xst + a.d, pln_h = static_cast<size_t>(a.b - 1) * hst + a.d;
    const size_t pln = pln_a > pln_h ? pln_a : pln_h;
    const size_t xs = static_cast<size_t>(G) * xst > pln + 2 * a.d ? static_cast<size_t>(G) * xst : pln + 2 * a.d;
    const int Ks[N_MATS] = {a.d, a.hd, a.d, a.d, a.dff}, Ns[N_MATS] = {3 * a.hd, a.d, a.hd, n1, a.d};
    int max_cols = 0;
    for (int i = 0; i < N_MATS; ++i) {
        const int cols = (Ns[i] / CU + grid - 1) / grid * CU;
        max_cols = cols > max_cols ? cols : max_cols;
    }
    // a pass: 4 column vectors (a lane's VEC columns each) x 8 batch rows on a warp's lanes
    constexpr int VEC = WVec<W>::V;
    p.pass_cols = 4 * VEC;
    size_t red = static_cast<size_t>(NW) * 4 * GR * VEC * 4;  // the (warp, row subgroup) partial sums of a group
    const size_t attn = static_cast<size_t>(NW) * (2 + HEAD_D) * 4;
    // the head's per-(key group, row) bests and, a8, the packed int8 rows
    const size_t head = static_cast<size_t>(NW) * 4 * a.b * 8 + (a.head_a8 ? static_cast<size_t>(a.b) * a.d : 0);
    const size_t i8 = pmt::i8_unit_smem<NT>();
    red = red > attn ? red : attn;
    red = red > head ? red : head;
    red = red > i8 ? red : i8;
    red = align256(red);
    const size_t fixed = align16(xs * 4) + red + MB * 4 + 4 * static_cast<size_t>(max_cols) * 4 + BAR_BYTES;
    if (fixed + 2 * static_cast<size_t>(p.pass_cols) * sizeof(W) > static_cast<size_t>(optin))
        return static_cast<int>(cudaErrorInvalidValue);  // the phase input does not fit
    p.par_cols = max_cols, p.xs_floats = align16(xs * 4) / 4, p.red_bytes = red, p.xs_stride = xst;
    p.hs_stride = hst, p.pln_off = static_cast<int>(pln);
    // the tensor-core launches (bf16 above one row group) hold bf16 rows in the same bytes: the staged norm
    // parameters go to the end of xs, and the rows below them (decode_step_kernel's `grouped`)
    if constexpr (MAXG > 1 && std::is_same<T, __nv_bfloat16>::value)
        p.pln_off = static_cast<int>(p.xs_floats) - 2 * a.d;
    p.ring_bytes = (optin - fixed) / 16 * 16;
    // the ring: as large as the largest whole share where that fits, so the rest of the SM's 256 KB stays L1
    size_t need = 0;
    for (int i = 0; i < N_MATS; ++i) {
        MatPlan m;
        const size_t whole = mat_plan(Ks[i], Ns[i], CU, UB, grid, p.pass_cols / CU, SIZE_MAX, m);
        need = whole > need ? whole : need;
    }
    // above one row group the groups re-read the share from the ring: every share must fit it whole
    if (a.b > GR && need > p.ring_bytes) return static_cast<int>(cudaErrorInvalidValue);
    p.ring_bytes = need < p.ring_bytes ? need : p.ring_bytes;
    p.smem = p.xs_floats * 4 + p.red_bytes + MB * 4 + 4 * static_cast<size_t>(p.par_cols) * 4 + BAR_BYTES + p.ring_bytes;
    for (int i = 0; i < N_MATS; ++i)
        if (!mat_plan(Ks[i], Ns[i], CU, UB, grid, p.pass_cols / CU, p.ring_bytes, p.m[i]))
            return static_cast<int>(cudaErrorInvalidValue);

    static size_t attr_smem = 0;
    static int per_sm = 0;
    if (attr_smem != p.smem) {
        cudaError_t e = cudaFuncSetAttribute(decode_step_kernel<T, W, MAXG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(p.smem));
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_step_kernel<T, W, MAXG>, NT, p.smem);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return static_cast<int>(e);
        }
        if (per_sm != 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);  // grid = SMs
        attr_smem = p.smem;
    }
    p.grid = grid;
    const int units = a.b * a.n_heads;
    p.split = p.grid / units;
    p.split = p.split < 1 ? 1 : (p.split > MAX_SPLIT ? MAX_SPLIT : p.split);
    // the merge weights of the rows merged at once (a group, or the whole batch above one group) fit red
    const size_t g_units = static_cast<size_t>(a.b > GR ? a.b : G) * a.n_heads;  // rows merged at once
    while (p.split > 1 && g_units * p.split * 4 > p.red_bytes) --p.split;
    if (g_units * 4 > p.red_bytes) return static_cast<int>(cudaErrorInvalidValue);

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

template <typename T, typename W, int MAXG>
int launch_groups(const Args& a) {
    Plan p{};
    int rc = plan<T, W, MAXG>(a, p);
    if (rc != 0) return rc;
    Args args = a;
    // a layer stride of 0: the launch's own batch, the (L, b, ...) caches whole
    if (!args.kv_stride) args.kv_stride = static_cast<long long>(a.b) * a.l_max * a.hd;
    if (!args.kvs_stride) args.kvs_stride = static_cast<long long>(a.b) * a.l_max;
    if (!args.xkv_stride) args.xkv_stride = static_cast<long long>(a.b) * a.lx * a.hd;
    if (!args.xkvs_stride) args.xkvs_stride = static_cast<long long>(a.b) * a.lx;
    void* params[] = {&args, &p};
    cudaError_t e = cudaLaunchCooperativeKernel(decode_step_kernel<T, W, MAXG>, dim3(p.grid), dim3(NT), params, p.smem,
                                                pmt::as_stream(a.stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace pmt_k7
