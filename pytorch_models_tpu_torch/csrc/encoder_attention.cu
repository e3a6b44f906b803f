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
// What bounds it on the H100: arithmetic at long sequences (Whisper's encoder,
// B=8, H=8, L=1500, D=64: 37 GFLOP against 49 MB moved), bytes at ViT's 197
// tokens (46 us of reads and writes against 15 us of products), and at D=64
// the exponentials as much as the products: one ex2 per score against 256
// tensor-core operations, and the H100's special-function units run 1/250 of
// its bf16 tensor rate. Two kernels, chosen by dtype alone (`route`):
//
// bf16, every head width (32, 64, 80, 128): Hopper's form.
// - A persistent grid, one block per SM, walks work items of 128 query rows
//   of one (batch row, head) in rounds over the grid; a causal grid runs the
//   heaviest items (the last query tiles) first, odd rounds in reverse block
//   order so that a block that drew a heavy item draws a light one next; a
//   causal item stops at its last query's key tile and masks only the tiles
//   that cross its diagonal.
// - Warp specialisation: warpgroup 0 is the producer (one thread issues every
//   load; setmaxnreg gives its registers to the consumers), warpgroups 1 and 2
//   the consumers, 64 query rows each (the M of wgmma).
// - Q (a ring of 2 items) and K, V (rings of 2-4 tiles of 128 keys) arrive by
//   TMA over 4-D tensor maps {D, H, L, B} of the merged-head tensors,
//   completing on full / empty mbarrier pairs: a box is one head's rows, rows
//   past L and columns past D arrive as zeros (masked keys' V rows are zero
//   for free; D=80 is carried as 128 zero-padded columns). Shared memory is
//   swizzled as wgmma reads it: 128-byte rows (boxes of 64 columns; D=128 and
//   80 as two boxes) or 64-byte rows at D=32.
// - S = Q K^T by wgmma m64n128k16 from shared memory (both K-major); the
//   online softmax on the accumulator registers as the mma.sync kernel does
//   (quad shuffles for the row max, one FFMA and ex2 per score, the scale
//   folded into the exponent); P rounded to bf16 in registers is the register
//   A operand of O += P V (m64n{32,64}k16), V read from its natural (key, d)
//   layout through the descriptor's transpose (MN-major) bit.
// - The two consumers take turns on named barriers (ping-pong): one issues its
//   products while the other runs its softmax, so ex2 runs under the other's
//   wgmma. Within a consumer, tile t's softmax runs under tile t-1's P @ V;
//   where an item walks 8 key tiles or more and D <= 64 (two score tiles fit
//   in the registers beside O and P), under S_{t+1} = Q K_{t+1}^T as well,
//   issued a tile ahead (a kernel instantiation of its own, chosen at launch).
// - O / l (the division by a reciprocal corrected once by its remainder: the
//   rounded quotient without the division's slow path) goes out through a
//   staging buffer by one TMA store, which writes no row past Lq; walking in
//   turn, while the next item's first products run.
//
// fp32 (the parity dtype), the mma.sync kernel (unchanged): one block of 4
// warps per (query tile of 64, head, batch row), K/V tiles of 32 keys staged
// by 16-byte cp.async into a 2-3 stage ring (rows padded by 16 bytes against
// bank conflicts; rows past Lk zero-filled), one barrier per tile; both
// products in 3xTF32 mma.m16n8k8 (each operand split as hi + lo, hi*hi +
// hi*lo + lo*hi, about 2^-21 per product); P stays fp32; the P @ V step
// numbers its 8 keys so that the S fragment a thread holds is its A fragment.
// A causal block stops at its last query's tile, masks only the tiles that
// cross its diagonal, and runs heaviest-first.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- fp32: the mma.sync kernel

template <typename T>
struct Tile;
template <>
struct Tile<float> {
    static constexpr int BK = 32;   // keys per tile
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

using pmt::mma_3xtf32;
using pmt::smem_addr;
using pmt::split_tf32;

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
// p = exp(raw * scale - m_safe), the scaled score minus m_safe first, as the
// JAX kernel and the twin take it, so a large score loses no digits.
template <int NT, int NO>
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
    float ms[2];  // m_safe
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        const float m_new = fmaxf(m[i], mt[i] * scale);
        const float m_safe = fmaxf(m_new, pmt::NEG_INF / 2);  // fully masked rows stay finite
        const float alpha = exp2_fast((m[i] - m_safe) * LOG2E);
        ms[i] = m_safe;
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            o[n][2 * i] *= alpha;
            o[n][2 * i + 1] *= alpha;
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[j][e] = exp2_fast((s[j][e] * scale - ms[e >> 1]) * LOG2E);
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
        for (int n = 0; n < NO; ++n)
            *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o[n][2 * i] / den, o[n][2 * i + 1] / den);
    }
}

// minBlocksPerSM 1: ptxas may give the tile loop the registers it needs; its default register target slowed
// D = 128 and the fp32 route (occupancy is taken as it comes)
template <typename T, int D, int MT_>
__global__ void __launch_bounds__(THREADS, 1)
encoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         T* __restrict__ out, int lq, int lk, int n_heads, float scale, int causal) {
    using C = Cfg<T, D, MT_>;
    constexpr int MT = C::MT, BQ = C::BQ, BK = C::BK, S = C::STRIDE, NT = BK / 8, NO = D / 8;
    static_assert(MT == 1, "the fp32 route keeps one m-tile per warp");
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
        online_softmax<NT, NO>(s[0], o[0], m[0], l[0], scale, need_mask, kt, lk, causal != 0, w0 + g);
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

// ---------------------------------------------------------------- bf16: the TMA + wgmma kernel

constexpr int BQ = 128;                   // query rows per work item: 64 per consumer warpgroup
constexpr int BK = 128;                   // keys per tile (the plain twin walks the same tiles)
constexpr int WG_THREADS = 3 * 128;       // the producer warpgroup and two consumer warpgroups
constexpr int CONSUMER_THREADS = 2 * 128;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // setmaxnreg: 128 x 24 + 256 x 240 <= 65,536

template <int D>
struct Geo {
    static_assert(D % 16 == 0 && D <= 128, "head width must be a multiple of 16, at most 128");
    static constexpr int DP = D <= 32 ? 32 : D <= 64 ? 64 : 128;  // the products' width: D and zero columns
    static constexpr int BOXW = DP == 32 ? 32 : 64;               // columns per TMA box: one swizzled smem row
    static constexpr int NB = DP / BOXW;                          // boxes per row
    static constexpr int ROWB = 2 * BOXW;                         // bytes per smem row: 64 or 128
    static constexpr int GROUP = 8 * ROWB;                        // one 8-row swizzle atom
    static constexpr uint32_t SWZ = ROWB == 128 ? 1 : 2;          // descriptor layout: 128- or 64-byte swizzle
    static constexpr int STAGES = DP <= 64 ? 4 : 2;               // K and V ring slots
    static constexpr int BOX = 128 * ROWB;                        // one box of 128 rows (BQ = BK)
    static constexpr int TILE = NB * BOX;                         // one Q item or one K or V tile
    static constexpr int K_OFF = 2 * TILE, V_OFF = K_OFF + STAGES * TILE, O_OFF = V_OFF + STAGES * TILE;
    static constexpr int O_BUF = NB * 64 * ROWB;  // a consumer's 64 output rows, staged for the TMA store
    static constexpr int BAR_OFF = O_OFF + 2 * O_BUF;
    static constexpr int N_BARS = 4 + 4 * STAGES;  // Q full / empty x 2, K and V full / empty x STAGES
    static constexpr int SMEM = BAR_OFF + 8 * N_BARS + 1024;  // + the slack that aligns the base to 1024 bytes
};

__device__ __forceinline__ void wait_phase(unsigned long long* bar, uint32_t parity) { pmt::mbar_wait(bar, parity); }

__device__ __forceinline__ void mbar_init_count(unsigned long long* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                         unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
        "[%6];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
        : "memory");
}

// one box from shared memory into a 4-D tensor map's tensor (rows and columns out of bounds are not written), in
// the issuing thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
    asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                     reinterpret_cast<uint64_t>(map)),
                 "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
                 : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// the issuing thread's stores have read their shared memory (.read) or are complete
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// wgmma's shared-memory matrix descriptor: start address, leading and stride byte offsets (16-byte units),
// swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t swz) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
           static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(swz) << 62;
}
// Q and K rows (K-major: the reduced dimension d runs along the swizzled row): 8-row atoms GROUP bytes apart
template <int D>
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
    return smem_desc(addr, 16, Geo<D>::GROUP, Geo<D>::SWZ);
}
// V rows (MN-major: the key dimension reduced, d along the row; one swizzle atom spans the 32 or 64 columns of
// an instruction): the 8-key groups GROUP bytes apart, given as both offsets
template <int D>
__device__ __forceinline__ uint64_t mn_major(uint32_t addr) {
    return smem_desc(addr, Geo<D>::GROUP, Geo<D>::GROUP, Geo<D>::SWZ);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the registers a wgmma in flight reads or writes: no access moves across this point
template <int N>
__device__ __forceinline__ void keep(float (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
        asm volatile("" : "+f"(r[i][0]), "+f"(r[i][1]), "+f"(r[i][2]), "+f"(r[i][3])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
        asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3])::"memory");
}

// d (64 x 128 fp32) = (scale_d ? d : 0) + A (64 x 16 bf16, shared) * B (16 x 128 bf16, shared); both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (*d)[4], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
          "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
          "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
          "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
          "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
          "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]),
          "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 32 fp32) += A (64 x 16 bf16, registers) * B (16 x 32 bf16, shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (*d)[4], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
          "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
          "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64 bf16, shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (*d)[4], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
          "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
          "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
          "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}



// The consumers' turns (ping-pong): consumer c issues its products after bar.sync on barrier 1 + c, which also
// needs the other consumer's bar.arrive on it, given once that one has issued its own.
__device__ __forceinline__ void turn_wait(int c) { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory"); }
__device__ __forceinline__ void turn_pass(int c) { asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + c) : "memory"); }
// the 128 threads of consumer c
__device__ __forceinline__ void wg_sync(int c) { asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory"); }

// S = Q K^T for one consumer: 64 query rows at q (shared address) against the 128 keys of the tile at k;
// D/16 steps of 16 columns, a step 32 bytes along the swizzled row of its box
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 8][4], uint32_t q, uint32_t k) {
    using G = Geo<D>;
#pragma unroll
    for (int kk = 0; kk < G::DP / 16; ++kk) {
        const uint32_t off = (kk / (G::BOXW / 16)) * G::BOX + 32 * (kk % (G::BOXW / 16));
        wgmma_ss_n128(s, k_major<D>(q + off), k_major<D>(k + off), kk > 0);
    }
}

// O += P V: per 16 keys (16 rows of the V tile at v) one product per box of columns
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Geo<D>::DP / 8][4], const uint32_t (&p)[BK / 16][4], uint32_t v) {
    using G = Geo<D>;
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
#pragma unroll
        for (int x = 0; x < G::NB; ++x) {
            const uint64_t desc = mn_major<D>(v + x * G::BOX + 16 * c * G::ROWB);
            if constexpr (G::BOXW == 32)
                wgmma_rs_n32(o + 4 * x, p[c], desc);
            else
                wgmma_rs_n64(o + 8 * x, p[c], desc);
        }
    }
}

// One tile's raw scores s[NT][4] (the accumulator of S: rows r_lo and r_lo + 8, keys kt + 8j + 2*tig + {0, 1})
// -> p in place, the arithmetic of the mma.sync kernel's bf16 route: the mask (-inf, so p = 0 exactly as NEG_INF
// gives), the running max of the scaled scores with the safe-max floor, alpha = exp(m - m_safe) for the caller's
// rescale of O (once the P @ V product in flight has completed), p = exp(raw * scale - m_safe) by one FFMA and
// ex2 (p is rounded to bf16 next), and l = alpha * l + the tile's sum of the unrounded fp32 p.
template <int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             float scale, bool need_mask, int kt, int lk, bool causal, int r_lo) {
    const int tig = threadIdx.x % 4;
    if (need_mask) {
        // key kt + 8j + 2*tig + (e & 1) is masked at or past its row's limit: Lk, and in a causal row the row + 1
        int lim[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) lim[i] = (causal ? min(lk, r_lo + 8 * i + 1) : lk) - kt - 2 * tig;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if (8 * j + (e & 1) >= lim[e >> 1]) s[j][e] = pmt::neg_inf();
            }
        }
    }
    float mt[2] = {pmt::neg_inf(), pmt::neg_inf()};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
        mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
    }
    float ms2[2];  // m_safe * log2(e)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        const float m_new = fmaxf(m[i], mt[i] * scale);
        const float m_safe = fmaxf(m_new, pmt::NEG_INF / 2);  // fully masked rows stay finite
        alpha[i] = exp2_fast((m[i] - m_safe) * LOG2E);
        ms2[i] = m_safe * LOG2E;
        m[i] = m_new;
        l[i] *= alpha[i];
    }
    const float sl2 = scale * LOG2E;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[j][e] = exp2_fast(fmaf(s[j][e], sl2, -ms2[e >> 1]));
            l[e >> 1] += s[j][e];  // the unrounded fp32 p
        }
    }
}

// p rounded to bf16 as wgmma's register A operand: n8 chunks 2c and 2c + 1 of S form key chunk c
template <int NC>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[NC][4], const float (&s)[2 * NC][4]) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        pa[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
        pa[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
        pa[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
        pa[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
    }
}

// a / den rounded to nearest as the division gives it, from rcp = 1 / den (rounded to nearest): the quotient
// corrected once by its exact remainder (Markstein), three FMA-pipe instructions in place of the division's
// sequence and its out-of-line slow path (a and den are finite, den in [1, Lk])
__device__ __forceinline__ float div_rn(float a, float den, float rcp) {
    const float q = a * rcp;
    return fmaf(fmaf(-q, den, a), rcp, q);
}

template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO][4], const float (&alpha)[2]) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
    }
}

// The r-th work item of this block: rounds of gridDim.x items, each block taking its own index, in reverse
// order in a causal grid's odd rounds; dense items run (batch row, head)-major so that a head's query tiles
// run side by side and read its K / V from L2; causal items run heaviest (last query tile) first. Gives the
// (batch row, head) index, the first query row and the key tiles; false past the last item.
__device__ __forceinline__ bool work_item(int r, int n_qt, int n_bh, int lk, int causal, int& bh, int& q0,
                                          int& n_tiles) {
    const int n = static_cast<int>(gridDim.x), bid = static_cast<int>(blockIdx.x);
    const int i = r * n + (causal && (r & 1) ? n - 1 - bid : bid);
    if (i >= n_qt * n_bh) return false;
    const int qt = causal ? n_qt - 1 - i / n_bh : i % n_qt;
    bh = causal ? i % n_bh : i / n_qt;
    q0 = qt * BQ;
    const int k_end = causal ? min(lk, q0 + BQ) : lk;  // a causal item stops at its last query's tile
    n_tiles = (k_end + BK - 1) / BK;
    return true;
}

// O / l (l == 0 -> 1: a fully masked row is zeros) rounded to bf16, in pairs: pk[i][n] holds row r_lo + 8i,
// columns 8n + 2*tig and + 1. Computed before the next item's first products are issued: ptxas makes any read of
// a register a wgmma defined wait for the wgmma in flight, and pk is defined by plain instructions.
template <int D>
__device__ __forceinline__ void pack_o(const float (&o)[Geo<D>::DP / 8][4], float (&l)[2],
                                       uint32_t (&pk)[2][Geo<D>::DP / 8]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float den = l[i] == 0.f ? 1.f : l[i], rcp = 1.f / den;
#pragma unroll
        for (int n = 0; n < Geo<D>::DP / 8; ++n)
            pk[i][n] = pack_bf16(div_rn(o[n][2 * i], den, rcp), div_rn(o[n][2 * i + 1], den, rcp));
    }
}

// The packed rows into the consumer's staging buffer `obuf` in the swizzled layout of the output map's boxes (64
// rows, BOXW columns), then one thread stores the boxes by TMA, which writes no row past Lq and no column past D.
// The buffer is written again only once the last store has read it.
template <int D>
__device__ __forceinline__ void put_o(const CUtensorMap* to, uint32_t obuf, int cw, int b, int h, int row0,
                                      const uint32_t (&pk)[2][Geo<D>::DP / 8]) {
    using G = Geo<D>;
    const int tid = threadIdx.x % 128, warp = tid / 32, g = tid % 32 / 4, tig = tid % 4;
    if (tid == 0) bulk_wait_read();
    wg_sync(cw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + g + 8 * i;
        const uint32_t swz = G::ROWB == 128 ? r % 8 : r / 2 % 4;  // the 16-byte chunk's XOR in row r
#pragma unroll
        for (int n = 0; n < G::DP / 8; ++n) {
            const int x = n / (G::BOXW / 8), c = n % (G::BOXW / 8);
            const uint32_t addr = obuf + x * 64 * G::ROWB + r * G::ROWB + ((c ^ swz) << 4) + 4 * tig;
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(pk[i][n]) : "memory");
        }
    }
    pmt::fence_async_shared();  // the writes, before the TMA reads them
    wg_sync(cw);
    if (tid == 0) {
#pragma unroll
        for (int x = 0; x < G::NB; ++x) tma_store(to, obuf + x * 64 * G::ROWB, x * G::BOXW, h, row0, b);
        bulk_commit();
    }
}

// The producer: one thread loads each item's Q into the Q ring (2 slots) and its key tiles' K and V into the
// rings (STAGES slots), each slot once its last readers have released it.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t base, unsigned long long* bars, int n_qt, int n_heads, int n_bh,
                                        int lk, int causal) {
    using G = Geo<D>;
    unsigned long long *q_full = bars, *q_empty = bars + 2, *k_full = bars + 4, *k_empty = k_full + G::STAGES,
                       *v_full = k_empty + G::STAGES, *v_empty = v_full + G::STAGES;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tq)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tk)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tv)) : "memory");
    int qslot = 0, slot = 0;
    uint32_t qphase = 0, phase = 0;
    for (int r = 0; r * static_cast<int>(gridDim.x) < n_qt * n_bh; ++r) {
        int bh, q0, n_tiles;
        if (!work_item(r, n_qt, n_bh, lk, causal, bh, q0, n_tiles)) continue;
        const int h = bh % n_heads, b = bh / n_heads;
        wait_phase(&q_empty[qslot], qphase ^ 1);
        pmt::mbar_expect(&q_full[qslot], G::TILE);
#pragma unroll
        for (int x = 0; x < G::NB; ++x)
            tma_load(base + qslot * G::TILE + x * G::BOX, tq, x * G::BOXW, h, q0, b, &q_full[qslot]);
        if (++qslot == 2) qslot = 0, qphase ^= 1;
        for (int t = 0; t < n_tiles; ++t) {
            wait_phase(&k_empty[slot], phase ^ 1);
            pmt::mbar_expect(&k_full[slot], G::TILE);
#pragma unroll
            for (int x = 0; x < G::NB; ++x)
                tma_load(base + G::K_OFF + slot * G::TILE + x * G::BOX, tk, x * G::BOXW, h, t * BK, b, &k_full[slot]);
            wait_phase(&v_empty[slot], phase ^ 1);
            pmt::mbar_expect(&v_full[slot], G::TILE);
#pragma unroll
            for (int x = 0; x < G::NB; ++x)
                tma_load(base + G::V_OFF + slot * G::TILE + x * G::BOX, tv, x * G::BOXW, h, t * BK, b, &v_full[slot]);
            if (++slot == G::STAGES) slot = 0, phase ^= 1;
        }
    }
}

// A ring slot and the parity of its current phase.
struct Slot {
    int i = 0;
    uint32_t phase = 0;
    template <int N>
    __device__ __forceinline__ void next() {
        if (++i == N) i = 0, phase ^= 1;
    }
};

// One consumer's running state over an item: O, the online softmax's m and l, P of the last tile, and the scores
// of one tile (NS = 1) or of two tiles (NS = 2: S_{t+1} in flight while tile t's softmax runs).
template <int D, int NS>
struct Walk {
    float o[Geo<D>::DP / 8][4], s[NS][BK / 8][4], m[2], l[2];
    uint32_t p[BK / 16][4];
    Slot kq, kr, vq;  // the K slot of the next S to issue, of the next S to complete, the V slot of the next P V
};

// The per-item arguments of a consumer's tile walk.
struct Rows {
    uint32_t q;  // the consumer's 64 Q rows (shared address)
    int qslot, n_tiles, row0, r_lo, lk, causal;
    float scale;
    __device__ __forceinline__ bool need_mask(int kt) const {
        return kt + BK > lk || (causal && kt + BK - 1 > row0);
    }
};

// Tile t's step, S_t in w.s[B]: in one turn O += P_{t-1} V_{t-1} and, with AHEAD, S_{t+1} = Q K_{t+1}^T into
// the other buffer; then S_t's softmax under the products; O rescaled once P_{t-1} V_{t-1} is in, and P_t packed.
// Each step issues and waits for a fixed set of products, so that ptxas can see which accumulators are in flight
// (a product issued or waited for on a condition makes it serialise every wgmma).
template <int D, int NS, int B, bool AHEAD>
__device__ __forceinline__ void step(Walk<D, NS>& w, const Rows& a, int t, uint32_t base, unsigned long long* bars,
                                     int cw) {
    using G = Geo<D>;
    unsigned long long *q_empty = bars + 2, *k_full = bars + 4, *k_empty = k_full + G::STAGES,
                       *v_full = k_empty + G::STAGES, *v_empty = v_full + G::STAGES;
    wait_phase(&v_full[w.vq.i], w.vq.phase);
    if constexpr (AHEAD) wait_phase(&k_full[w.kq.i], w.kq.phase);
    turn_wait(cw);
    wgmma_fence();
    issue_pv<D>(w.o, w.p, base + G::V_OFF + w.vq.i * G::TILE);
    wgmma_commit();
    if constexpr (AHEAD) {
        issue_qk<D>(w.s[B ^ 1], a.q, base + G::K_OFF + w.kq.i * G::TILE);
        wgmma_commit();
        w.kq.template next<G::STAGES>();
    }
    turn_pass(cw ^ 1);
    wgmma_wait<AHEAD ? 2 : 1>();  // S_t is in (the groups: S_t, P_{t-1} V_{t-1}[, S_{t+1}])
    keep(w.s[B]);
    mbar_arrive(&k_empty[w.kr.i]);
    w.kr.template next<G::STAGES>();
    if (t == a.n_tiles - 1) mbar_arrive(&q_empty[a.qslot]);
    float alpha[2];
    softmax_tile(w.s[B], w.m, w.l, alpha, a.scale, a.need_mask(t * BK), t * BK, a.lk, a.causal != 0, a.r_lo);
    wgmma_wait<AHEAD ? 1 : 0>();  // P_{t-1} V_{t-1} is in
    keep(w.o);
    keep(w.p);
    mbar_arrive(&v_empty[w.vq.i]);
    w.vq.template next<G::STAGES>();
    rescale(w.o, alpha);
    pack_p(w.p, w.s[B]);
}

// The first turn of an item: S_0 into w.s[0] and, with TWO, S_1 into w.s[1]. Returns with them in flight.
template <int D, int NS, bool TWO>
__device__ __forceinline__ void first_issue(Walk<D, NS>& w, const Rows& a, uint32_t base, unsigned long long* bars,
                                            int cw) {
    using G = Geo<D>;
    unsigned long long* k_full = bars + 4;
    wait_phase(&k_full[w.kq.i], w.kq.phase);
    turn_wait(cw);
    wgmma_fence();
    issue_qk<D>(w.s[0], a.q, base + G::K_OFF + w.kq.i * G::TILE);
    wgmma_commit();
    w.kq.template next<G::STAGES>();
    if constexpr (TWO) {
        wait_phase(&k_full[w.kq.i], w.kq.phase);
        issue_qk<D>(w.s[1], a.q, base + G::K_OFF + w.kq.i * G::TILE);
        wgmma_commit();
        w.kq.template next<G::STAGES>();
    }
    turn_pass(cw ^ 1);
}

// Tile 0 once S_0 is in (under S_1 with TWO): its softmax, P_0 packed.
template <int D, int NS, bool TWO>
__device__ __forceinline__ void first_softmax(Walk<D, NS>& w, const Rows& a, unsigned long long* bars) {
    using G = Geo<D>;
    unsigned long long *q_empty = bars + 2, *k_empty = bars + 4 + G::STAGES;
    wgmma_wait<TWO ? 1 : 0>();
    keep(w.s[0]);
    mbar_arrive(&k_empty[w.kr.i]);
    w.kr.template next<G::STAGES>();
    if (a.n_tiles == 1) mbar_arrive(&q_empty[a.qslot]);
    float alpha[2];  // O is zero: nothing to rescale
    softmax_tile(w.s[0], w.m, w.l, alpha, a.scale, a.need_mask(0), 0, a.lk, a.causal != 0, a.r_lo);
    pack_p(w.p, w.s[0]);
}

// The last turn of an item: O += P V of its last tile.
template <int D, int NS>
__device__ __forceinline__ void last_pv(Walk<D, NS>& w, uint32_t base, unsigned long long* bars, int cw) {
    using G = Geo<D>;
    unsigned long long *v_full = bars + 4 + 2 * G::STAGES, *v_empty = v_full + G::STAGES;
    wait_phase(&v_full[w.vq.i], w.vq.phase);
    turn_wait(cw);
    wgmma_fence();
    issue_pv<D>(w.o, w.p, base + G::V_OFF + w.vq.i * G::TILE);
    wgmma_commit();
    turn_pass(cw ^ 1);
    wgmma_wait<0>();
    keep(w.o);
    keep(w.p);
    mbar_arrive(&v_empty[w.vq.i]);
    w.vq.template next<G::STAGES>();
}

// Tile t's step with one score buffer: in one turn S_t = Q K_t^T and O += P_{t-1} V_{t-1}; S_t's softmax under
// the product; O rescaled once the product is in, and P_t packed.
template <int D, int NS>
__device__ __forceinline__ void step_in_turn(Walk<D, NS>& w, const Rows& a, int t, uint32_t base,
                                             unsigned long long* bars, int cw) {
    using G = Geo<D>;
    unsigned long long *q_empty = bars + 2, *k_full = bars + 4, *k_empty = k_full + G::STAGES,
                       *v_full = k_empty + G::STAGES, *v_empty = v_full + G::STAGES;
    wait_phase(&k_full[w.kq.i], w.kq.phase);
    wait_phase(&v_full[w.vq.i], w.vq.phase);
    turn_wait(cw);
    wgmma_fence();
    issue_qk<D>(w.s[0], a.q, base + G::K_OFF + w.kq.i * G::TILE);
    wgmma_commit();
    w.kq.template next<G::STAGES>();
    issue_pv<D>(w.o, w.p, base + G::V_OFF + w.vq.i * G::TILE);
    wgmma_commit();
    turn_pass(cw ^ 1);
    wgmma_wait<1>();  // S_t is in; P_{t-1} V_{t-1} may still run
    keep(w.s[0]);
    mbar_arrive(&k_empty[w.kr.i]);
    w.kr.template next<G::STAGES>();
    if (t == a.n_tiles - 1) mbar_arrive(&q_empty[a.qslot]);
    float alpha[2];
    softmax_tile(w.s[0], w.m, w.l, alpha, a.scale, a.need_mask(t * BK), t * BK, a.lk, a.causal != 0, a.r_lo);
    wgmma_wait<0>();
    keep(w.o);
    keep(w.p);
    mbar_arrive(&v_empty[w.vq.i]);
    w.vq.template next<G::STAGES>();
    rescale(w.o, alpha);
    pack_p(w.p, w.s[0]);
}

// The item whose O awaits its store, and where it goes.
struct Pending {
    int b = -1, h = 0, row0 = 0;
};

// One item of a consumer: the previous item's O / l packed and, walking in turn, stored while this item's first
// products run (the walk ahead, whose walks are long, stores first: under its two first products it ran slower);
// O, m, l reset; then tile 0's softmax and the rest of the walk: with NS = 2 and TWO, the scores one tile ahead
// (step, two at a time so that each buffer is named at compile time, the last step without the product ahead);
// with NS = 1, one score tile (step_in_turn); last the last tile's P V. Each path issues and waits for a fixed set
// of products, so that ptxas sees which accumulators are in flight (a product issued or waited for on a condition
// makes it serialise every wgmma).
template <int D, int NS, bool TWO>
__device__ __forceinline__ void run_item(Walk<D, NS>& w, const Rows& a, Pending& pend, const Pending& item,
                                         const CUtensorMap* to, uint32_t base, unsigned long long* bars, int cw) {
    using G = Geo<D>;
    const uint32_t obuf = base + G::O_OFF + cw * G::O_BUF;
    uint32_t pk[2][G::DP / 8];
    if (pend.b >= 0) pack_o<D>(w.o, w.l, pk);
    if (NS == 2 && pend.b >= 0) put_o<D>(to, obuf, cw, pend.b, pend.h, pend.row0, pk);
    first_issue<D, NS, TWO>(w, a, base, bars, cw);
    if (NS == 1 && pend.b >= 0) put_o<D>(to, obuf, cw, pend.b, pend.h, pend.row0, pk);
    pend = item;
#pragma unroll
    for (int n = 0; n < G::DP / 8; ++n) w.o[n][0] = w.o[n][1] = w.o[n][2] = w.o[n][3] = 0.f;
    w.m[0] = w.m[1] = pmt::NEG_INF;
    w.l[0] = w.l[1] = 0.f;
    first_softmax<D, NS, TWO>(w, a, bars);
    const int n = a.n_tiles;
    if constexpr (NS == 2) {
        if constexpr (TWO) {
            int t = 1;
            for (; t + 2 < n; t += 2) {  // S_t in s[1] at the top of each pass
                step<D, 2, 1, true>(w, a, t, base, bars, cw);
                step<D, 2, 0, true>(w, a, t + 1, base, bars, cw);
            }
            if (t + 1 < n) {
                step<D, 2, 1, true>(w, a, t, base, bars, cw);
                step<D, 2, 0, false>(w, a, t + 1, base, bars, cw);
            } else {
                step<D, 2, 1, false>(w, a, t, base, bars, cw);
            }
        }
    } else {
        for (int t = 1; t < n; ++t) step_in_turn(w, a, t, base, bars, cw);
    }
    last_pv(w, base, bars, cw);
}

// A consumer: 64 query rows of each item (cw = 0: rows 0-63 of its 128, cw = 1: rows 64-127). With AHEAD the
// items walk their key tiles with the scores one tile ahead (an item of one key tile has none ahead), else in
// turn (run_item). Each item's O / l is stored under the next item's first products; the last one's at the end.
// Without keys (Lk = 0) every item's O is zeros, and no product is issued.
template <int D, bool AHEAD>
__device__ __forceinline__ void consume(const CUtensorMap* to, uint32_t base, unsigned long long* bars, int lk,
                                        int n_qt, int n_heads, int n_bh, float scale, int causal) {
    using G = Geo<D>;
    unsigned long long *q_full = bars, *q_empty = bars + 2;
    const int cw = threadIdx.x / 128 - 1;
    const int warp = threadIdx.x % 128 / 32, g = threadIdx.x % 32 / 4;
    const uint32_t obuf = base + G::O_OFF + cw * G::O_BUF;
    Walk<D, AHEAD ? 2 : 1> w;
    Slot qs;
    Pending pend;
    uint32_t zeros[2][G::DP / 8] = {};  // O without keys
    if (lk > 0 && cw == 1) turn_pass(0);  // consumer 0 takes the first turn
    for (int r = 0; r * static_cast<int>(gridDim.x) < n_qt * n_bh; ++r) {
        int bh, q0, n_tiles;
        if (!work_item(r, n_qt, n_bh, lk, causal, bh, q0, n_tiles)) continue;
        const int row0 = q0 + 64 * cw;
        const Rows a{base + qs.i * G::TILE + 64 * cw * G::ROWB, qs.i, n_tiles, row0, row0 + 16 * warp + g, lk,
                     causal, scale};
        const Pending item{bh / n_heads, bh % n_heads, row0};
        wait_phase(&q_full[qs.i], qs.phase);
        if (lk == 0) {
            mbar_arrive(&q_empty[qs.i]);
            put_o<D>(to, obuf, cw, item.b, item.h, item.row0, zeros);
        } else if (AHEAD && n_tiles > 1) {
            run_item<D, AHEAD ? 2 : 1, AHEAD>(w, a, pend, item, to, base, bars, cw);
        } else {
            run_item<D, AHEAD ? 2 : 1, false>(w, a, pend, item, to, base, bars, cw);
        }
        qs.template next<2>();
    }
    if (pend.b >= 0) {
        uint32_t pk[2][G::DP / 8];
        pack_o<D>(w.o, w.l, pk);
        put_o<D>(to, obuf, cw, pend.b, pend.h, pend.row0, pk);
    }
    if (lk > 0 && cw == 0) turn_wait(0);  // the other consumer's last pass
    if (threadIdx.x % 128 == 0) bulk_wait();
}

template <int D, bool AHEAD>
__global__ void __launch_bounds__(WG_THREADS, 1)
encoder_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                               int batch, int lq, int lk, int n_heads, float scale, int causal) {
    using G = Geo<D>;
    extern __shared__ __align__(1024) unsigned char smem_tma[];
    const uint32_t raw = smem_addr(smem_tma), base = (raw + 1023) & ~1023u;  // swizzle atoms align to 1024 bytes
    auto* bars = reinterpret_cast<unsigned long long*>(smem_tma + (base - raw) + G::BAR_OFF);
    if (threadIdx.x == 0) {
        for (int i = 0; i < G::N_BARS; ++i) {
            const bool full = i < 4 ? i < 2 : (i - 4) / G::STAGES % 2 == 0;  // q_full, q_empty, k_full, ...
            mbar_init_count(&bars[i], full ? 1 : CONSUMER_THREADS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int n_qt = (lq + BQ - 1) / BQ, n_bh = n_heads * batch;
    if (threadIdx.x < 128) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (threadIdx.x == 0) produce<D>(&tq, &tk, &tv, base, bars, n_qt, n_heads, n_bh, lk, causal);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
        consume<D, AHEAD>(&to, base, bars, lk, n_qt, n_heads, n_bh, scale, causal);
    }
}

// cuTensorMapEncodeTiled from the driver through the runtime's entry-point query (the library links no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
constexpr int NO_ENCODER = -1000;  // the driver has no cuTensorMapEncodeTiled

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t e =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// The map {D, heads, rows, batch} of a merged-head (B, rows, H*D) bf16 tensor; a box is BOXW columns of one head
// over box_rows rows, swizzled as wgmma reads it. Columns past D and rows past `rows` read as zeros and are not
// written. Returns 0, or minus the driver's error.
template <int D>
int encode_map(CUtensorMap* map, const void* ptr, int b, int rows, int n_heads, int box_rows) {
    using G = Geo<D>;
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return NO_ENCODER;
    const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(n_heads), static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t row = static_cast<cuuint64_t>(n_heads) * D * 2;  // bytes
    const cuuint64_t strides[3] = {D * 2, row, row * rows};
    const cuuint32_t box[4] = {G::BOXW, 1, static_cast<cuuint32_t>(box_rows), 1}, unit[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          G::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// The walk of a launch: the scores one tile ahead (two score tiles beside O and P, so D <= 64) where the longest
// item walks at least AHEAD_MIN_TILES key tiles; shorter walks take their scores in turn. On the H100 the walk
// ahead was the faster from 8 tiles on (1,024 keys, Whisper-base's 12 tiles) and the slower at 2 to 5 (ViT's 2,
// BERT's 4), where it delays each tile's softmax by the turn that issues the product ahead.
constexpr int AHEAD_MIN_TILES = 8;

template <int D, bool AHEAD>
int launch_walk(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& to, int grid,
                int b, int lq, int lk, int n_heads, float scale, int causal, cudaStream_t s) {
    static bool ready = false;  // the opt-in to more than 48 KB of shared memory, once
    if (!ready) {
        const cudaError_t e = cudaFuncSetAttribute(encoder_attention_wgmma_kernel<D, AHEAD>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::SMEM);
        if (e != cudaSuccess) return static_cast<int>(e);
        ready = true;
    }
    encoder_attention_wgmma_kernel<D, AHEAD><<<grid, WG_THREADS, Geo<D>::SMEM, s>>>(tq, tk, tv, to, b, lq, lk,
                                                                                    n_heads, scale, causal);
    return 0;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int b, int lq, int lk, int n_heads,
                 float scale, int causal, cudaStream_t s) {
    static int n_sm = 0;
    if (n_sm == 0) {
        int dev = 0, n = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return static_cast<int>(e);
        n_sm = n;
    }
    // no keys (Lk = 0): the K and V maps are never read; they are made over q, which has rows
    CUtensorMap tq, tk, tv, to;
    int rc = encode_map<D>(&tq, q, b, lq, n_heads, BQ);
    if (rc == 0) rc = encode_map<D>(&tk, lk > 0 ? k : q, b, lk > 0 ? lk : 1, n_heads, BK);
    if (rc == 0) rc = encode_map<D>(&tv, lk > 0 ? v : q, b, lk > 0 ? lk : 1, n_heads, BK);
    if (rc == 0) rc = encode_map<D>(&to, out, b, lq, n_heads, 64);
    if (rc != 0) return rc;
    const int grid = min((lq + BQ - 1) / BQ * n_heads * b, n_sm);  // one block per SM walks the items
    if constexpr (Geo<D>::DP <= 64) {
        const int tiles = ((causal ? min(lk, lq) : lk) + BK - 1) / BK;  // the longest item's key tiles
        if (tiles >= AHEAD_MIN_TILES)
            return launch_walk<D, true>(tq, tk, tv, to, grid, b, lq, lk, n_heads, scale, causal, s);
    }
    return launch_walk<D, false>(tq, tk, tv, to, grid, b, lq, lk, n_heads, scale, causal, s);
}

// The kernel that serves a (dtype, head width): 1 the TMA + wgmma kernel (bf16), 0 the mma.sync kernel (fp32),
// -1 none (the head widths of the JAX package's families: 32 DETR; 64 GPT-2, Whisper, T5, BERT, ViT-Ti..L;
// 80 ViT-H; and 128)
int route(int dtype, int head_dim) {
    if (head_dim != 32 && head_dim != 64 && head_dim != 80 && head_dim != 128) return -1;
    return dtype == pmt::DT_F32 ? 0 : 1;
}

int dispatch(const void* q, const void* k, const void* v, void* out, int b, int lq, int lk, int n_heads,
             int head_dim, float scale, int causal, int dtype, cudaStream_t s) {
    const int r = route(dtype, head_dim);
    if (r == 1) {
        switch (head_dim) {
            case 32: return launch_wgmma<32>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
            case 64: return launch_wgmma<64>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
            case 80: return launch_wgmma<80>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
            default: return launch_wgmma<128>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
        }
    }
    if (r == 0) {
        switch (head_dim) {
            case 32: return launch<float, 32, 1>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
            case 64: return launch<float, 64, 1>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
            case 80: return launch<float, 80, 1>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
            default: return launch<float, 128, 1>(q, k, v, out, b, lq, lk, n_heads, scale, causal, s);
        }
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, Lq, H*D); k, v (B, Lk, H*D); out (B, Lq, H*D); causal masks j > i. Returns a cudaError_t, or minus the
// driver's error where a bf16 call's tensor map does not encode.
extern "C" int pmt_encoder_attention(const void* q, const void* k, const void* v, void* out, int b, int lq, int lk,
                                     int n_heads, int head_dim, float scale, int causal, int dtype, void* stream) {
    if (b <= 0 || lq <= 0) return 0;
    const int rc = dispatch(q, k, v, out, b, lq, lk, n_heads, head_dim, scale, causal, dtype, pmt::as_stream(stream));
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
}

// Keys per tile of the online softmax for a dtype code: the plain twin walks the same tiles.
extern "C" int pmt_encoder_attention_k_tile(int dtype) { return dtype == pmt::DT_F32 ? Tile<float>::BK : BK; }

// Which kernel serves a (dtype code, head width): 1 the TMA + wgmma kernel, 0 the mma.sync kernel, -1 none.
extern "C" int pmt_encoder_attention_route(int dtype, int head_dim) { return route(dtype, head_dim); }

