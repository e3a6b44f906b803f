// Fused greedy head: out[b] = argmax_v (x[b] . head[v]) without writing logits,
// for a tied (V, d) embedding or an untied (d, V) classifier, in one launch.
//
// Replaces pytorch_models_tpu/ops/greedy_head.py `greedy_argmax_tied` and
// `greedy_argmax` (one Pallas kernel, `tied=True/False`, streaming the table
// in vocab chunks with a running (best value, best index) in VMEM scratch).
//
// What bounds it on the H100: bytes. The head is read once per step for 2*B
// FLOPs per element (GPT-2's tied embedding, 50257 x 768: 154 MB fp32, 77 MB
// bf16; T5-base's classifier 768 x 32128: 99 MB fp32, 49 MB bf16); the logits
// a matmul + argmax would write and read back are what this kernel saves.
// The design puts the products on the tensor cores, so that the batch costs
// no extra pass over the head:
// - mma.sync with vocab rows on M, batch rows on N (one n8 tile per 8 rows)
//   and d on K, fp32 accumulators: bf16 as m16n8k16, fp32 (the parity
//   dtype) as 3xTF32 m16n8k8 (each operand split hi + lo, about 2^-21 per
//   product);
// - a persistent grid of up to 4 CTAs per SM, each owning one contiguous
//   range of vocab rows, walked in ascending order in tiles of 64 rows (4
//   warps, one m16 tile each; tied ranges in 16-row units, balanced; untied
//   ranges in whole tiles of 64 columns, the grid as small as keeps every
//   CTA's unit count at the most loaded one's). Each tile streams through a
//   cp.async ring in K-chunks (tied: 256 bytes of each row, 4 stages;
//   untied: 8 KB of rows, 4 stages, or 16 KB, 3 stages at B <= 16), next to
//   the same chunk of every batch row (x is read from L2 once per tile), so
//   every warp's A fragment feeds all of the batch's n8 tiles and the head
//   is read from HBM once for the whole batch (up to 256 rows: up to 4 warp
//   columns of 64; a larger batch takes passes of 256 rows, one read of the
//   head each);
// - 16-byte chunks are XOR-swizzled by row (chunk ^ (row & 7)), so the 8
//   rows one ldmatrix reads land on 8 distinct bank groups: a tied row is
//   1,536 bytes at d 768, and unswizzled rows would sit in one bank group;
// - A fragments: tied, ldmatrix of the row-major (V, d) tile (for fp32 the
//   same instruction moves 4 words a row); untied, ldmatrix.trans of the
//   (d, V) tile as it lies (bf16), or scalar loads of a tile swizzled by
//   (row & 7) << 1 (fp32); x is (B, d) row-major, the "col" layout of the B
//   operand, read by ldmatrix;
// - the epilogue of each tile rounds the C fragment to the dtype (bf16: as
//   the logits of a bf16 head matmul), keeps a running (value, index) per
//   batch column with `better` (larger value, then smaller index: ties go to
//   the lowest index like jnp.argmax; rows past the range or V are never
//   candidates), then merges lanes by shuffles and warps through shared
//   memory; each CTA folds its best into one 64-bit key per batch row
//   (order-preserving value bits, then the complemented index) by atomicMax,
//   which is exact in any order. The last CTA to finish, found by an atomic
//   ticket after a __threadfence, turns the keys into ids and resets them
//   and the ticket for the next call on the stream.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int WM = 4;            // warps along the vocab, one m16 tile each per sub-tile
constexpr int ROW_TIED = 256;    // bytes of K per staged tied row: 128 bf16 or 64 fp32 values
constexpr int UNTIED_BYTES = 8192;  // an untied stage's head tile above 16 rows: 64 bf16 or 32 fp32 rows of 64 columns
constexpr int STAGES = 4;        // ring depth; 2 where 4 stages do not fit (tied, more than 128 rows a pass)
constexpr int WN_MAX = 4;        // warp columns of up to 64 batch rows each
constexpr int MAX_CTAS_PER_SM = 4;

// The tile of one (dtype, layout, n8 tiles per warp): TMC = 64 vocab rows
// (tied) or columns (untied) by KC values of d. A tied tile is 64 rows of
// ROW_TIED bytes (runs of 256 bytes per row: 128-byte runs read the head at
// 0.74x the rate); an untied tile is KC rows of 64 columns, and a CTA's range
// a whole number of tiles (wider tiles, which leave fewer CTAs, read no
// faster). Untied at B <= 16 takes 16 KB stages 3 deep (fp32 B=8 at 0.94x
// the time of 8 KB stages 4 deep, which are faster from B=32 up).
template <typename T, bool TIED, int NT>
struct Cfg {
    static constexpr int SZ = static_cast<int>(sizeof(T));
    static constexpr int E = 16 / SZ;  // elements per 16-byte chunk
    static constexpr int TMC = 16 * WM;
    static constexpr int UNIT = TIED ? 16 : TMC;  // a CTA's range: tied, 16-row units (balanced); untied, tiles
    static constexpr bool DEEP = !TIED && NT <= 2;
    static constexpr int HEAD_BYTES = TIED ? TMC * ROW_TIED : DEEP ? 2 * UNTIED_BYTES : UNTIED_BYTES;
    static constexpr int DEPTH = DEEP ? 3 : STAGES;
    static constexpr int KC = HEAD_BYTES / (TMC * SZ);
    static constexpr int HCPR = TIED ? KC * SZ / 16 : TMC * SZ / 16;  // chunks per staged head row
    static constexpr int XCPR = KC * SZ / 16;                         // chunks per staged x row
    static constexpr int KSTEPS = KC * SZ / 32;  // k16 (bf16) or k8 (fp32) steps: two chunks each
};

// XOR swizzle of the chunks of a staged row of CPR chunks, so that the 8 rows
// one ldmatrix reads (at one logical chunk) sit on 8 distinct bank groups
template <int CPR>
__device__ __forceinline__ int swz(int r) {
    return CPR >= 8 ? (r & 7) : ((r * CPR / 8) & (CPR - 1));
}

using pmt::better;

// order-preserving bits of a float (-0 taken as +0, as the comparison takes it)
__device__ __forceinline__ unsigned long long key_of(float s, int idx) {
    const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
    const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<unsigned long long>(o) << 32) | (0xffffffffu - static_cast<unsigned>(idx));
}

// one 16-byte chunk into shared memory: `bytes` (0..16) valid bytes at src,
// the rest zero; by cp.async where the source is 16-byte aligned, else by
// scalar loads (rows whose width breaks the alignment)
template <typename T>
__device__ __forceinline__ void chunk(void* dst, const T* src, const T* base, int bytes, bool aligned) {
    if (aligned) {
        pmt::cp16(dst, bytes > 0 ? src : base, bytes);
    } else {
        T* o = static_cast<T*>(dst);
#pragma unroll
        for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e)
            o[e] = (e + 1) * static_cast<int>(sizeof(T)) <= bytes ? src[e] : pmt::from_f32<T>(0.f);
    }
}

__device__ __forceinline__ int clamp16(int64_t bytes) { return bytes <= 0 ? 0 : bytes >= 16 ? 16 : static_cast<int>(bytes); }

// batch column (within a pass) of C fragment element e (or column h) of n8 tile j
__device__ __forceinline__ int col_of(int wn, int j, int t, int e, int nt) { return wn * nt * 8 + j * 8 + 2 * t + (e & 1); }

template <typename T, bool TIED, int NT, int STAGES>
__global__ void __launch_bounds__(WM * WN_MAX * 32)
greedy_head_kernel(const T* __restrict__ x, const T* __restrict__ w, unsigned long long* __restrict__ scratch,
                   int64_t* __restrict__ out, int b, int v, int d, int units) {
    using C = Cfg<T, TIED, NT>;
    constexpr int SZ = C::SZ, E = C::E, KC = C::KC, HC = C::HCPR, XC = C::XCPR;
    constexpr bool F32 = SZ == 4;
    extern __shared__ __align__(128) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp & (WM - 1), wn = warp / WM;
    const int g = lane >> 2, t = lane & 3;
    const int nthreads = blockDim.x;
    const int xr = nthreads / (32 * WM) * NT * 8;  // batch rows per pass
    const int sbytes = C::HEAD_BYTES + xr * XC * 16;  // one stage

    // this CTA's vocab rows [r0, r1): `units` units of C::UNIT rows split evenly over the grid
    const int r0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * units / gridDim.x) * C::UNIT;
    const int r1 = min(static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * units / gridDim.x) * C::UNIT, v);
    const int n_tiles = (r1 - r0 + C::TMC - 1) / C::TMC;
    const int n_kc = (d + KC - 1) / KC;
    const int n_st = n_tiles * n_kc;
    const bool w_al = (TIED ? static_cast<int64_t>(d) : static_cast<int64_t>(v)) * SZ % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const bool x_al = static_cast<int64_t>(d) * SZ % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

    for (int b0 = 0; b0 < b; b0 += xr) {
        const int nb = min(xr, b - b0);

        auto issue = [&](int s) {
            unsigned char* st = smem + (s % STAGES) * sbytes;
            const int vt = r0 + s / n_kc * C::TMC, k0 = s % n_kc * KC;
            for (int q = tid; q < C::HEAD_BYTES / 16; q += nthreads) {
                const int r = q / HC, c = q % HC;
                if (TIED) {  // vocab rows
                    const int row = vt + r, k = k0 + c * E;
                    chunk<T>(st + (r * HC + (c ^ (r & 7))) * 16, w + static_cast<int64_t>(row) * d + k, w,
                             row < r1 ? clamp16(static_cast<int64_t>(d - k) * SZ) : 0, w_al);
                } else {  // k rows of TMC columns; fp32 rows swizzled for the scalar fragment loads
                    const int k = k0 + r, col = vt + c * E;
                    chunk<T>(st + (r * HC + (c ^ (F32 ? (r & 7) << 1 : r & 7))) * 16,
                             w + static_cast<int64_t>(k) * v + col, w,
                             k < d ? clamp16(static_cast<int64_t>(r1 - col) * SZ) : 0, w_al);
                }
            }
            unsigned char* xs = st + C::HEAD_BYTES;
            for (int q = tid; q < xr * XC; q += nthreads) {
                const int r = q / XC, c = q % XC, k = k0 + c * E;
                chunk<T>(xs + (r * XC + (c ^ swz<XC>(r))) * 16, x + static_cast<int64_t>(b0 + r) * d + k, x,
                         r < nb ? clamp16(static_cast<int64_t>(d - k) * SZ) : 0, x_al);
            }
        };

        float acc[NT][4];
        float bv[NT][2];
        int bi[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
            bv[j][0] = bv[j][1] = pmt::neg_inf();
            bi[j][0] = bi[j][1] = INT_MAX;
        }

        for (int s = 0; s < STAGES - 1; ++s) {
            if (s < n_st) issue(s);
            pmt::cp_commit();
        }
        for (int s = 0; s < n_st; ++s) {
            pmt::cp_wait<STAGES - 2>();  // stage s has landed (this thread's chunks) ...
            __syncthreads();             // ... and everyone's; everyone is done with stage s - 1's buffer
            if (s + STAGES - 1 < n_st) issue(s + STAGES - 1);
            pmt::cp_commit();

            const unsigned char* st = smem + (s % STAGES) * sbytes;
            const unsigned char* xs = st + C::HEAD_BYTES;
            const int xr0 = wn * NT * 8;
#pragma unroll
            for (int kk = 0; kk < C::KSTEPS; ++kk) {
                uint32_t bb[NT][2];
                if (NT == 1) {
                    const int r = xr0 + (lane & 7), c = kk * 2 + ((lane >> 3) & 1);
                    pmt::ldmatrix_x2(bb[0], xs + (r * XC + (c ^ swz<XC>(r))) * 16);
                } else {
#pragma unroll
                    for (int p = 0; p < NT / 2; ++p) {
                        const int r = xr0 + p * 16 + (lane & 7) + ((lane >> 4) << 3), c = kk * 2 + ((lane >> 3) & 1);
                        uint32_t q[4];
                        pmt::ldmatrix_x4(q, xs + (r * XC + (c ^ swz<XC>(r))) * 16);
                        bb[2 * p][0] = q[0], bb[2 * p][1] = q[1], bb[2 * p + 1][0] = q[2], bb[2 * p + 1][1] = q[3];
                    }
                }
                uint32_t bh[NT][2], bl[NT][2];
                if (F32) {
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        pmt::split_tf32(__uint_as_float(bb[j][0]), bh[j][0], bl[j][0]);
                        pmt::split_tf32(__uint_as_float(bb[j][1]), bh[j][1], bl[j][1]);
                    }
                }
                const int m0 = wm * 16;  // this warp's m16 tile: its first row (column) in the tile
                uint32_t a[4];
                if (TIED) {
                    const int r = m0 + (lane & 15), c = kk * 2 + (lane >> 4);
                    pmt::ldmatrix_x4(a, st + (r * HC + (c ^ (r & 7))) * 16);
                } else if (!F32) {
                    const int r = kk * 16 + (lane & 7) + ((lane >> 4) << 3), c = m0 / 8 + ((lane >> 3) & 1);
                    pmt::ldmatrix_x4_trans(a, st + (r * HC + (c ^ (r & 7))) * 16);
                } else {
                    const float* hf = reinterpret_cast<const float*>(st);
                    auto at = [&](int r, int col) {
                        return __float_as_uint(hf[r * HC * 4 + (((col >> 2) ^ ((r & 7) << 1)) << 2) + (col & 3)]);
                    };
                    a[0] = at(kk * 8 + t, m0 + g);
                    a[1] = at(kk * 8 + t, m0 + 8 + g);
                    a[2] = at(kk * 8 + t + 4, m0 + g);
                    a[3] = at(kk * 8 + t + 4, m0 + 8 + g);
                }
                if (F32) {
                    uint32_t ah[4], al[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) pmt::split_tf32(__uint_as_float(a[q]), ah[q], al[q]);
                    // 3xTF32, each pass over every n8 tile before the next (consecutive products feed
                    // different accumulators)
#pragma unroll
                    for (int j = 0; j < NT; ++j) pmt::mma_tf32(acc[j], al, bh[j]);
#pragma unroll
                    for (int j = 0; j < NT; ++j) pmt::mma_tf32(acc[j], ah, bl[j]);
#pragma unroll
                    for (int j = 0; j < NT; ++j) pmt::mma_tf32(acc[j], ah, bh[j]);
                } else {
#pragma unroll
                    for (int j = 0; j < NT; ++j) pmt::mma_bf16(acc[j], a, bb[j][0], bb[j][1]);
                }
            }

            if (s % n_kc == n_kc - 1) {  // the tile's last K-chunk: fold its scores into the running bests
                const int vt = r0 + s / n_kc * C::TMC + wm * 16 + g;
#pragma unroll
                for (int j = 0; j < NT; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int row = vt + (e >> 1) * 8, col = col_of(wn, j, t, e, NT);
                        if (row < r1 && col < nb) {
                            const float sc = pmt::round_to<T>(acc[j][e]);
                            if (better(sc, row, bv[j][e & 1], bi[j][e & 1])) bv[j][e & 1] = sc, bi[j][e & 1] = row;
                        }
                        acc[j][e] = 0.f;
                    }
                }
            }
        }
        pmt::cp_wait<0>();
        __syncthreads();  // the ring is free: the warps' bests meet in its space

        float* red_v = reinterpret_cast<float*>(smem);  // (WM, xr)
        int* red_i = reinterpret_cast<int*>(red_v + WM * xr);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float sv = bv[j][h];
                int si = bi[j][h];
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {  // the 8 lanes of one column pair (same t)
                    const float ov = __shfl_xor_sync(0xffffffffu, sv, o);
                    const int oi = __shfl_xor_sync(0xffffffffu, si, o);
                    if (better(ov, oi, sv, si)) sv = ov, si = oi;
                }
                if (g == 0) {
                    const int col = col_of(wn, j, t, h, NT);
                    red_v[wm * xr + col] = sv;
                    red_i[wm * xr + col] = si;
                }
            }
        }
        __syncthreads();
        unsigned long long* keys = scratch + 1;
        for (int col = tid; col < nb; col += nthreads) {
            float sv = red_v[col];
            int si = red_i[col];
            for (int q = 1; q < WM; ++q)
                if (better(red_v[q * xr + col], red_i[q * xr + col], sv, si)) sv = red_v[q * xr + col], si = red_i[q * xr + col];
            atomicMax(keys + b0 + col, key_of(sv, si));
            __threadfence();
        }
        __syncthreads();  // the next pass's prologue reuses this space
    }

    // the last CTA to finish turns the keys into ids and resets the scratch
    __shared__ int last;
    if (tid == 0) {
        __threadfence();
        unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (last) {
        __threadfence();
        for (int i = tid; i < b; i += nthreads) {
            const unsigned long long k = atomicExch(scratch + 1 + i, 0ull);
            out[i] = static_cast<int64_t>(0xffffffffu - static_cast<unsigned>(k & 0xffffffffull));
        }
        if (tid == 0) atomicExch(reinterpret_cast<unsigned*>(scratch), 0u);
    }
}

// The launch: n8 tiles per warp (1, 2, 4 or 8: the batch up to 64 rows),
// warp columns (1 up to 64 rows; up to 4, 256 rows a pass), the ring, and
// a grid of up to 4 CTAs per SM, never more than the units of V.
struct Plan {
    int nt, wn, stages, threads, smem, unit, units, grid;
};

// a stage's bytes for xr batch rows; the unit of a CTA's range and the ring depth
template <typename C>
int stage_of(int xr, int* unit, int* depth) {
    *unit = C::UNIT;
    *depth = C::DEPTH;
    return C::HEAD_BYTES + xr * C::XCPR * 16;
}

template <typename T, bool TIED>
int stage_bytes(int nt, int xr, int* unit, int* depth) {
    switch (nt) {
        case 1: return stage_of<Cfg<T, TIED, 1>>(xr, unit, depth);
        case 2: return stage_of<Cfg<T, TIED, 2>>(xr, unit, depth);
        case 4: return stage_of<Cfg<T, TIED, 4>>(xr, unit, depth);
        default: return stage_of<Cfg<T, TIED, 8>>(xr, unit, depth);
    }
}

int stage_bytes(int dtype, int tied, int nt, int xr, int* unit, int* depth) {
    if (dtype == pmt::DT_F32)
        return tied ? stage_bytes<float, true>(nt, xr, unit, depth) : stage_bytes<float, false>(nt, xr, unit, depth);
    return tied ? stage_bytes<__nv_bfloat16, true>(nt, xr, unit, depth)
                : stage_bytes<__nv_bfloat16, false>(nt, xr, unit, depth);
}

template <typename T, bool TIED, int NT, int S>
void* kernel_ptr() { return reinterpret_cast<void*>(greedy_head_kernel<T, TIED, NT, S>); }

template <typename T, bool TIED>
void* kernel_for(int nt, int stages) {
    switch (nt) {
        case 1: return kernel_ptr<T, TIED, 1, Cfg<T, TIED, 1>::DEPTH>();
        case 2: return kernel_ptr<T, TIED, 2, Cfg<T, TIED, 2>::DEPTH>();
        case 4: return kernel_ptr<T, TIED, 4, Cfg<T, TIED, 4>::DEPTH>();
        default: return stages == 2 ? kernel_ptr<T, TIED, 8, 2>() : kernel_ptr<T, TIED, 8, Cfg<T, TIED, 8>::DEPTH>();
    }
}

void* kernel_for(int dtype, int tied, int nt, int stages) {
    if (dtype == pmt::DT_F32) return tied ? kernel_for<float, true>(nt, stages) : kernel_for<float, false>(nt, stages);
    return tied ? kernel_for<__nv_bfloat16, true>(nt, stages) : kernel_for<__nv_bfloat16, false>(nt, stages);
}

int plan(int b, int v, int dtype, int tied, Plan* p) {
    p->nt = b <= 8 ? 1 : b <= 16 ? 2 : b <= 32 ? 4 : 8;
    p->wn = b <= 64 ? 1 : std::min(WN_MAX, (b + 63) / 64);
    p->threads = 32 * WM * p->wn;
    int dev = 0, sms = 0, optin = 0, occ = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    int depth = 0;
    const int sb = stage_bytes(dtype, tied, p->nt, p->wn * p->nt * 8, &p->unit, &depth);
    p->stages = depth * sb <= optin || p->nt != 8 ? depth : 2;
    p->smem = p->stages * sb;
    if (p->smem > optin) return static_cast<int>(cudaErrorInvalidValue);
    void* k = kernel_for(dtype, tied, p->nt, p->stages);
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, p->threads, p->smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    p->units = (v + p->unit - 1) / p->unit;
    // as few CTAs as give each the same number of units as the most loaded one has
    const int per = (p->units + sms * std::min(occ, MAX_CTAS_PER_SM) - 1) / (sms * std::min(occ, MAX_CTAS_PER_SM));
    p->grid = (p->units + per - 1) / per;
    return 0;
}

}  // namespace

// The split of a call at this shape: the number G of CTAs it launches (out[0])
// and the rows N of a unit (out[1]); CTA i owns vocab rows [N * (i * U / G),
// N * ((i + 1) * U / G)) with U = ceil(V / N). Returns a CUDA error code.
extern "C" int pmt_greedy_split(int b, int v, int dtype, int tied, int* out) {
    Plan p;
    const int rc = plan(b, v, dtype, tied, &p);
    out[0] = p.grid;
    out[1] = p.unit;
    return rc;
}

// x (B, d); w the head: tied (V, d) or untied (d, V); scratch: 1 + B int64
// words, zero before the first call on a stream and left zero by every call
// (word 0 the CTAs' ticket, then one key per batch row); out (B,) int64.
extern "C" int pmt_greedy_argmax(const void* x, const void* w, void* scratch, void* out, int b, int v, int d,
                                 int dtype, int tied, void* stream) {
    if (b <= 0 || v <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
    Plan p;
    const int rc = plan(b, v, dtype, tied, &p);
    if (rc != 0) return rc;
    auto* sc = static_cast<unsigned long long*>(scratch);
    auto* o = static_cast<int64_t*>(out);
    cudaStream_t s = pmt::as_stream(stream);
    void* k = kernel_for(dtype, tied, p.nt, p.stages);
    void* args[] = {&x, &w, &sc, &o, &b, &v, &d, &p.units};
    return static_cast<int>(cudaLaunchKernel(k, dim3(p.grid), dim3(p.threads), args, p.smem, s));
}
