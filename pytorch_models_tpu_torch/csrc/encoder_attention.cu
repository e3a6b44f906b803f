// Merged-head scaled dot-product attention, dense or causal, no bias, on the
// tensor cores.
//
// Replaces pytorch_models_tpu/ops/encoder_attention.py `encoder_attention`
// (the Pallas flash kernels `_kernel_single` and `_kernel`). q (B, Lq, H*D),
// k/v (B, Lk, H*D) stay in the projections' merged-head layout; the scores
// never reach device memory. The arithmetic is the JAX kernel's: fp32 scores
// times the scale, an fp32 online softmax with the finite NEG_INF / safe-max
// rule (a fully masked row gives zeros, not NaN), keys at or past Lk masked
// and their V rows zero, the normaliser summed from the unrounded fp32 p,
// and for bf16 p rounded to bf16 before P @ V; the division comes last.
// ops/encoder_attention.py's plain twin walks the same key tiles (K_TILE,
// reported by pmt_encoder_attention_k_tile).
//
// What bounds it on the H100: arithmetic. At Whisper's encoder (B=8, H=8,
// L=1500, D=64) it does 37 GFLOP against 49 MB moved, far above the memory
// ridge, so both products must run on the tensor cores. The design is a
// flash kernel on mma.sync:
// - one block of 4 warps per (query tile, head, batch row); each warp owns
//   MT m-tiles of 16 query rows and walks the key range in tiles of BK keys
//   (bf16 64, fp32 32). bf16 at D <= 64 takes MT = 2 (each K/V fragment read
//   from shared memory feeds two products, so a block does twice the work in
//   less than twice the time) where that needs fewer waves of blocks at each
//   choice's occupancy; a grid that fits the card in one wave of MT = 1
//   blocks (GPT-2's B=2 causal prefill, bound by its heaviest block) keeps
//   MT = 1. A causal block stops at its last query's tile, masks only the
//   tiles that cross its diagonal, and runs heaviest-first;
// - K/V tiles are staged by 16-byte cp.async into a 2-3 stage ring in shared
//   memory (rows padded by 16 bytes against bank conflicts; rows past Lk
//   zero-filled by a source size of 0), one barrier per tile;
// - bf16: S = Q K^T by mma.m16n8k16 (bf16 in, fp32 accumulate) with Q held
//   in registers (ldmatrix once) and K read by ldmatrix; the online softmax
//   runs on the accumulator fragments (row max and sum by quad shuffles; one
//   FFMA and one ex2 per score, the scale folded into the exponent);
//   P is rounded to bf16 in registers, where two m16n8 C fragments are one
//   m16n8k16 A fragment, and P @ V reads V by ldmatrix.trans from its
//   natural (key, d) layout;
// - fp32 (the parity dtype): the same tile loop on 3xTF32 mma.m16n8k8: each
//   operand split as hi + lo (both tf32), hi*hi + hi*lo + lo*hi, about 2^-21
//   per product; P stays fp32. The P @ V step numbers its 8 keys so that the
//   S fragment a thread holds is its A fragment: no shuffle.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
    static constexpr int BK = 64;   // keys per tile
    static constexpr int PAD = 8;   // 16 bytes per smem row: ldmatrix rows land on distinct banks
};
template <>
struct Tile<float> {
    static constexpr int BK = 32;
    static constexpr int PAD = 4;   // the fragment loads' 8 rows x 4 columns land on distinct banks
};

template <typename T, int D, int MT_ = 1>
struct Cfg {
    static constexpr int MT = MT_;               // 16-row m-tiles per warp
    static constexpr int BQ = 16 * MT * WARPS;  // query rows per block
    static constexpr int BK = Tile<T>::BK;
    static constexpr int STRIDE = D + Tile<T>::PAD;  // smem row stride, elements
    static constexpr int STAGES = D <= 64 ? 3 : 2;
    static constexpr int CHUNK = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte copy
    static constexpr int Q_ELEMS = BQ * STRIDE;
    static constexpr int KV_ELEMS = BK * STRIDE;  // one K or V tile
    static constexpr int SMEM = (Q_ELEMS + 2 * STAGES * KV_ELEMS) * static_cast<int>(sizeof(T));
    static_assert(D % 16 == 0, "head width must be a multiple of 16");
};

using pmt::ldmatrix_x4;
using pmt::ldmatrix_x4_trans;
using pmt::mma_3xtf32;
using pmt::mma_bf16;
using pmt::mma_tf32;
using pmt::smem_addr;
using pmt::split_tf32;
using pmt::to_tf32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// ROWS rows of D elements starting at row r0 of a (rows, ld) matrix into smem
// (row stride STRIDE); rows at or past n_rows are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int ld, int r0, int n_rows) {
    using C = Cfg<T, D>;
    constexpr int CPR = D / C::CHUNK;
    for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
        const int r = i / CPR, c = (i % CPR) * C::CHUNK, j = r0 + r;
        const bool ok = j < n_rows;
        cp_async16(dst + r * C::STRIDE + c, src + static_cast<int64_t>(ok ? j : 0) * ld + c, ok ? 16 : 0);
    }
}

__device__ __forceinline__ float exp2_fast(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// One m-tile's raw scores s[NT][4] (C fragments: rows r_lo and r_lo + 8,
// keys kt + 8j + 2*tig + {0, 1}) -> p in place: the mask (as -inf, which
// gives p = 0 exactly as NEG_INF does), the running max of the scaled scores
// with the safe-max floor (max(raw) * scale is max(raw * scale): the scale is
// positive), the rescale of l and of the output accumulator o[NO][4], then
// p = exp(raw * scale - m_safe): for bf16 one FFMA and ex2 (p is rounded to
// bf16 next); for fp32 (EXACT) the scaled score minus m_safe first, as the
// JAX kernel and the twin take it, so a large score loses no digits.
template <int NT, int NO, bool EXACT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&o)[NO][4], float (&m)[2], float (&l)[2],
                                               float scale, bool need_mask, int kt, int lk, bool causal, int r_lo) {
    const int tig = threadIdx.x % 4;
    if (need_mask) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = kt + 8 * j + 2 * tig + (e & 1);
                const int row = r_lo + (e >> 1) * 8;
                if (key >= lk || (causal && key > row)) s[j][e] = pmt::neg_inf();
            }
        }
    }
    float mt[2] = {pmt::neg_inf(), pmt::neg_inf()};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
        mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
    }
    float ms[2], ms2[2];  // m_safe, m_safe * log2(e)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        const float m_new = fmaxf(m[i], mt[i] * scale);
        const float m_safe = fmaxf(m_new, pmt::NEG_INF / 2);  // fully masked rows stay finite
        const float alpha = exp2_fast((m[i] - m_safe) * LOG2E);
        ms[i] = m_safe;
        ms2[i] = m_safe * LOG2E;
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            o[n][2 * i] *= alpha;
            o[n][2 * i + 1] *= alpha;
        }
    }
    const float sl2 = scale * LOG2E;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[j][e] = EXACT ? exp2_fast((s[j][e] * scale - ms[e >> 1]) * LOG2E)
                            : exp2_fast(fmaf(s[j][e], sl2, -ms2[e >> 1]));
            l[e >> 1] += s[j][e];  // the unrounded fp32 p
        }
    }
}

// out rows r_lo, r_lo + 8 (if < lq): o / l, with l == 0 -> 1 (a fully masked row is zeros)
template <typename T, int NO>
__device__ __forceinline__ void store_rows(T* ob, int hd, int lq, int r_lo, float (&o)[NO][4], float (&l)[2]) {
    const int tig = threadIdx.x % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float den = l[i] == 0.f ? 1.f : l[i];
        const int row = r_lo + 8 * i;
        if (row >= lq) continue;
        T* orow = ob + static_cast<int64_t>(row) * hd + 2 * tig;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            const float x0 = o[n][2 * i] / den, x1 = o[n][2 * i + 1] / den;
            if constexpr (sizeof(T) == 2) {
                *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(x0, x1);
            } else {
                *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0, x1);
            }
        }
    }
}

// minBlocksPerSM 1: ptxas may give the tile loop the registers it needs; its default register target slowed
// D = 128 and the fp32 route (occupancy is taken as it comes, see launch_mt)
template <typename T, int D, int MT_>
__global__ void __launch_bounds__(THREADS, 1)
encoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         T* __restrict__ out, int lq, int lk, int n_heads, float scale, int causal) {
    using C = Cfg<T, D, MT_>;
    constexpr int MT = C::MT, BQ = C::BQ, BK = C::BK, S = C::STRIDE, NT = BK / 8, NO = D / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* qs = reinterpret_cast<T*>(smem_raw);
    T* ks = qs + C::Q_ELEMS;
    T* vs = ks + C::STAGES * C::KV_ELEMS;

    // causal blocks run heaviest (last query tile) first
    const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
    const int hd = n_heads * D;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const int wr = 16 * MT * warp;  // the warp's first row in the block; m-tile i: rows wr + 16 i + [0, 16)
    const int w0 = q0 + wr, w_last = w0 + 16 * MT - 1;
    const int64_t hoff = static_cast<int64_t>(h) * D;
    const T* kb = k + static_cast<int64_t>(b) * lk * hd + hoff;
    const T* vb = v + static_cast<int64_t>(b) * lk * hd + hoff;
    const int k_end = causal ? min(lk, q0 + BQ) : lk;
    const int n_tiles = (k_end + BK - 1) / BK;

    load_rows<T, D, BQ>(qs, q + static_cast<int64_t>(b) * lq * hd + hoff, hd, q0, lq);
    cp_async_commit();
#pragma unroll
    for (int t = 0; t < C::STAGES - 1; ++t) {
        if (t < n_tiles) {
            load_rows<T, D, BK>(ks + t * C::KV_ELEMS, kb, hd, t * BK, lk);
            load_rows<T, D, BK>(vs + t * C::KV_ELEMS, vb, hd, t * BK, lk);
        }
        cp_async_commit();  // an empty group keeps the count
    }

    float o[MT][NO][4], m[MT][2], l[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int n = 0; n < NO; ++n) o[i][n][0] = o[i][n][1] = o[i][n][2] = o[i][n][3] = 0.f;
        m[i][0] = m[i][1] = pmt::NEG_INF;
        l[i][0] = l[i][1] = 0.f;
    }

    // bf16: the warp's query rows as A fragments, loaded once
    constexpr bool BF16 = sizeof(T) == 2;
    uint32_t qf[BF16 ? MT : 1][BF16 ? D / 16 : 1][4];
    if constexpr (BF16) {
        cp_async_wait<C::STAGES - 1>();
        __syncthreads();
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int kc = 0; kc < D / 16; ++kc)
                ldmatrix_x4(qf[i][kc], qs + (wr + 16 * i + lane % 16) * S + 16 * kc + (lane / 16) * 8);
        }
    }

    for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<C::STAGES - 2>();
        __syncthreads();  // tile t is in; every warp is done with the stage refilled below
        const int tn = t + C::STAGES - 1;
        if (tn < n_tiles) {
            load_rows<T, D, BK>(ks + (tn % C::STAGES) * C::KV_ELEMS, kb, hd, tn * BK, lk);
            load_rows<T, D, BK>(vs + (tn % C::STAGES) * C::KV_ELEMS, vb, hd, tn * BK, lk);
        }
        cp_async_commit();

        const int kt = t * BK;
        if (causal && kt > w_last) continue;  // every key is past the warp's rows: p = 0, nothing moves
        const bool need_mask = kt + BK > lk || (causal && kt + BK - 1 > w0);
        const T* kst = ks + (t % C::STAGES) * C::KV_ELEMS;
        const T* vst = vs + (t % C::STAGES) * C::KV_ELEMS;

        float s[MT][NT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int j = 0; j < NT; ++j) s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
        }

        if constexpr (BF16) {
            // S = Q K^T: per 16-wide d chunk, one ldmatrix.x4 gives the B fragments of two 8-key n-tiles
            const int mi = lane / 8, r = lane % 8;
#pragma unroll
            for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    uint32_t bf[4];
                    ldmatrix_x4(bf, kst + (16 * np + (mi / 2) * 8 + r) * S + 16 * kc + (mi % 2) * 8);
#pragma unroll
                    for (int i = 0; i < MT; ++i) {
                        mma_bf16(s[i][2 * np], qf[i][kc], bf[0], bf[1]);
                        mma_bf16(s[i][2 * np + 1], qf[i][kc], bf[2], bf[3]);
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < MT; ++i)
                online_softmax<NT, NO, false>(s[i], o[i], m[i], l[i], scale, need_mask, kt, lk, causal != 0,
                                              w0 + 16 * i + g);
            // P (bf16) @ V: n-tiles 2c and 2c + 1 of S form the A fragment of key chunk c
#pragma unroll
            for (int c = 0; c < NT / 2; ++c) {
                uint32_t pa[MT][4];
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    pa[i][0] = pack_bf16(s[i][2 * c][0], s[i][2 * c][1]);
                    pa[i][1] = pack_bf16(s[i][2 * c][2], s[i][2 * c][3]);
                    pa[i][2] = pack_bf16(s[i][2 * c + 1][0], s[i][2 * c + 1][1]);
                    pa[i][3] = pack_bf16(s[i][2 * c + 1][2], s[i][2 * c + 1][3]);
                }
#pragma unroll
                for (int dp = 0; dp < D / 16; ++dp) {
                    uint32_t bf[4];
                    ldmatrix_x4_trans(bf, vst + (16 * c + (mi % 2) * 8 + r) * S + 16 * dp + (mi / 2) * 8);
#pragma unroll
                    for (int i = 0; i < MT; ++i) {
                        mma_bf16(o[i][2 * dp], pa[i], bf[0], bf[1]);
                        mma_bf16(o[i][2 * dp + 1], pa[i], bf[2], bf[3]);
                    }
                }
            }
        } else {
            static_assert(MT == 1, "the fp32 route keeps one m-tile per warp");
            // S = Q K^T in 3xTF32, 8-wide d chunks; A = Q rows (w0 + g, + 8), cols tig, tig + 4
#pragma unroll
            for (int kc = 0; kc < D / 8; ++kc) {
                const T* qr = qs + (wr + g) * S + 8 * kc + tig;
                uint32_t ah[4], al[4];
                split_tf32(qr[0], ah[0], al[0]);
                split_tf32(qr[8 * S], ah[1], al[1]);
                split_tf32(qr[4], ah[2], al[2]);
                split_tf32(qr[8 * S + 4], ah[3], al[3]);
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const T* kr = kst + (8 * j + g) * S + 8 * kc + tig;
                    uint32_t bh[2], bl[2];
                    split_tf32(kr[0], bh[0], bl[0]);
                    split_tf32(kr[4], bh[1], bl[1]);
                    mma_3xtf32(s[0][j], ah, al, bh, bl);
                }
            }
            online_softmax<NT, NO, true>(s[0], o[0], m[0], l[0], scale, need_mask, kt, lk, causal != 0, w0 + g);
            // P (fp32) @ V per 8 keys: the k index tig stands for key 2*tig, tig + 4 for key 2*tig + 1,
            // so this thread's C fragment of S is its A fragment and it loads the matching V rows itself
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                uint32_t ph[4], pl[4];
                split_tf32(s[0][j][0], ph[0], pl[0]);
                split_tf32(s[0][j][2], ph[1], pl[1]);
                split_tf32(s[0][j][1], ph[2], pl[2]);
                split_tf32(s[0][j][3], ph[3], pl[3]);
                const T* vr = vst + (8 * j + 2 * tig) * S + g;
#pragma unroll
                for (int n = 0; n < NO; ++n) {
                    uint32_t bh[2], bl[2];
                    split_tf32(vr[8 * n], bh[0], bl[0]);
                    split_tf32(vr[S + 8 * n], bh[1], bl[1]);
                    mma_3xtf32(o[0][n], ph, pl, bh, bl);
                }
            }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < MT; ++i)
        store_rows<T, NO>(out + static_cast<int64_t>(b) * lq * hd + hoff, hd, lq, w0 + 16 * i + g, o[i], l[i]);
}

// The instantiation's resident blocks per SM at its shared memory, after the
// opt-in that more than 48 KB of dynamic shared memory needs; once each.
template <typename T, int D, int MT>
int blocks_per_sm(int* occ) {
    static int n = 0;
    if (n == 0) {
        using C = Cfg<T, D, MT>;
        cudaError_t e = cudaFuncSetAttribute(encoder_attention_kernel<T, D, MT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, encoder_attention_kernel<T, D, MT>, THREADS, C::SMEM);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (n == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    *occ = n;
    return 0;
}

template <typename T, int D, int MT>
int launch(const void* q, const void* k, const void* v, void* out, int b, int lq, int lk, int n_heads, float scale,
           int causal, cudaStream_t s) {
    using C = Cfg<T, D, MT>;
    int occ = 0;
    const int rc = blocks_per_sm<T, D, MT>(&occ);
    if (rc != 0) return rc;
    dim3 grid((lq + C::BQ - 1) / C::BQ, n_heads, b);
    encoder_attention_kernel<T, D, MT><<<grid, THREADS, C::SMEM, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), lq, lk,
        n_heads, scale, causal);
    return 0;
}

// bf16 at D <= 64: two m-tiles per warp where that needs fewer waves of blocks
template <typename T, int D>
int launch_mt(const void* q, const void* k, const void* v, void* out, int b, int lq, int lk, int n_heads, float scale,
              int causal, cudaStream_t s) {
    if constexpr (sizeof(T) == 2) {
        static int n_sm = 0;
        if (n_sm == 0) {
            int dev = 0;
            cudaError_t e = cudaGetDevice(&dev);
            if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        int occ1 = 0, occ2 = 0;
        int rc = blocks_per_sm<T, D, 1>(&occ1);
        if (rc == 0) rc = blocks_per_sm<T, D, 2>(&occ2);
        if (rc != 0) return rc;
        const int64_t rows = static_cast<int64_t>(n_heads) * b;
        const int64_t waves1 = ((lq + 63) / 64 * rows + occ1 * n_sm - 1) / (occ1 * n_sm);
        const int64_t waves2 = ((lq + 127) / 128 * rows + occ2 * n_sm - 1) / (occ2 * n_sm);
        if (waves2 < waves1) return launch<T, D, 2>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
    }
    return launch<T, D, 1>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b, int lq, int lk, int n_heads,
             int head_dim, float scale, int causal, cudaStream_t s) {
    // the head widths of the JAX package's families: 32 (DETR), 64 (GPT-2, Whisper, T5, BERT, ViT-Ti..L), 80 (ViT-H)
    switch (head_dim) {
        case 32: return launch_mt<T, 32>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
        case 64: return launch_mt<T, 64>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
        case 80: return launch<T, 80, 1>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
        case 128: return launch<T, 128, 1>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
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

// Keys per tile of the online softmax for a dtype code: the plain twin walks the same tiles.
extern "C" int pmt_encoder_attention_k_tile(int dtype) {
    return dtype == pmt::DT_F32 ? Tile<float>::BK : Tile<__nv_bfloat16>::BK;
}
