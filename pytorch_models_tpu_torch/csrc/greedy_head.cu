// Fused greedy head: out[b] = argmax_v (x[b] . emb[v]) without writing logits,
// for a tied (V, d) embedding or an untied (d, V) classifier.
//
// Replaces pytorch_models_tpu/ops/greedy_head.py `greedy_argmax_tied` and
// `greedy_argmax` (one Pallas kernel, `tied=True/False`, streaming the table
// in vocab chunks with a running (best value, best index) in VMEM scratch).
//
// What bounds it on the H100: bytes. The (V, d) embedding is read once per
// step (GPT-2: 50257 x 768 = 77 MB fp32, 39 MB bf16) for 2*B FLOPs per
// element; the logits a matmul + argmax would write and read back are what
// this kernel saves. The design: pass 1 gives each block a chunk of CHUNK
// vocab rows; its 8 warps take rows in turn, a warp reads one row once
// (coalesced) and dots it with every batch row held in shared memory as
// fp32. Blocks run in no order, so each writes its chunk's (value, index)
// per batch row, and pass 2 (one block per batch row) reduces the chunks.
// Both passes use the same order: larger value wins, then smaller index —
// so ties go to the lowest index like jnp.argmax. In bf16 each
// fp32-accumulated score is rounded to bf16 before comparing, as the XLA
// head matmul would round its logits. Ragged vocab edge: rows >= V are
// never visited.
//
// The untied (d, V) layout (T5's classifier) is read as it lies, never
// transposed: a block owns a slab of 128 bytes of every row (64 bf16 or 32
// fp32 vocab columns, so T5-base's 32128 make 502 or 1004 blocks) and streams
// it through shared memory in tiles of 64 rows, three tiles in flight
// (cp.async), so that enough bytes are on their way to cover the memory
// latency; the block's 8 warps split each tile's rows, each lane holds the
// sums of every batch row of its block (up to 32) for its 4 bytes of columns
// in registers, so the classifier is read once for them all, and the slab's
// scores are summed across warps in shared memory in one fixed order.
// Larger batches take one block per group of rows (grid.y), which reads the
// slab again. Each block then writes its (value, index) per batch row for
// pass 2, as above. Bound: bytes (T5-base bf16: 768 x 32128 x 2 B = 49 MB
// per step).
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int NW = 8;       // warps per block in pass 1
constexpr int CHUNK = 128;  // vocab rows per block in pass 1
constexpr int BG = 8;       // batch rows scored per sweep of an embedding row

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
    return s > bs || (s == bs && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(NW * 32)
greedy_chunk_kernel(const T* __restrict__ x, const T* __restrict__ emb, float* __restrict__ part_val,
                    int* __restrict__ part_idx, int b, int v, int d, int n_chunks) {
    extern __shared__ float smem[];
    float* xs = smem;                                   // (b, d) fp32
    float* best_v = xs + static_cast<int64_t>(b) * d;   // (NW, b)
    int* best_i = reinterpret_cast<int*>(best_v + NW * b);  // (NW, b)

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int i = threadIdx.x; i < b * d; i += blockDim.x) xs[i] = pmt::to_f32(x[i]);
    for (int i = threadIdx.x; i < NW * b; i += blockDim.x) {
        best_v[i] = pmt::neg_inf();
        best_i[i] = INT_MAX;
    }
    __syncthreads();

    const int row0 = blockIdx.x * CHUNK;
    const int row_end = min(row0 + CHUNK, v);
    for (int row = row0 + warp; row < row_end; row += NW) {
        const T* er = emb + static_cast<int64_t>(row) * d;
        for (int b0 = 0; b0 < b; b0 += BG) {
            float acc[BG];
#pragma unroll
            for (int i = 0; i < BG; ++i) acc[i] = 0.f;
            for (int c = lane; c < d; c += 32) {
                const float w = pmt::to_f32(er[c]);
#pragma unroll
                for (int i = 0; i < BG; ++i)
                    if (b0 + i < b) acc[i] += xs[(b0 + i) * d + c] * w;
            }
#pragma unroll
            for (int i = 0; i < BG; ++i) {
                const float s = pmt::round_to<T>(pmt::warp_sum(acc[i]));
                if (lane == 0 && b0 + i < b) {
                    const int slot = warp * b + b0 + i;
                    if (better(s, row, best_v[slot], best_i[slot])) {
                        best_v[slot] = s;
                        best_i[slot] = row;
                    }
                }
            }
        }
    }
    __syncthreads();

    for (int r = threadIdx.x; r < b; r += blockDim.x) {
        float bv = pmt::neg_inf();
        int bi = INT_MAX;
        for (int w = 0; w < NW; ++w) {
            if (better(best_v[w * b + r], best_i[w * b + r], bv, bi)) {
                bv = best_v[w * b + r];
                bi = best_i[w * b + r];
            }
        }
        part_val[static_cast<int64_t>(r) * n_chunks + blockIdx.x] = bv;
        part_idx[static_cast<int64_t>(r) * n_chunks + blockIdx.x] = bi;
    }
}

constexpr int R_THREADS = 256;

__global__ void __launch_bounds__(R_THREADS)
greedy_reduce_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                     int64_t* __restrict__ out, int n_chunks) {
    __shared__ float sv[R_THREADS];
    __shared__ int si[R_THREADS];
    const int r = blockIdx.x;
    float bv = pmt::neg_inf();
    int bi = INT_MAX;
    for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
        const float s = part_val[static_cast<int64_t>(r) * n_chunks + c];
        const int i = part_idx[static_cast<int64_t>(r) * n_chunks + c];
        if (better(s, i, bv, bi)) {
            bv = s;
            bi = i;
        }
    }
    sv[threadIdx.x] = bv;
    si[threadIdx.x] = bi;
    __syncthreads();
    for (int stride = R_THREADS / 2; stride > 0; stride >>= 1) {
        if (threadIdx.x < stride) {
            const int o = threadIdx.x + stride;
            if (better(sv[o], si[o], sv[threadIdx.x], si[threadIdx.x])) {
                sv[threadIdx.x] = sv[o];
                si[threadIdx.x] = si[o];
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) out[r] = si[0];
}

// ---------------------------------------------------------------- untied (d, V)

constexpr int UROW = 128;  // bytes of each classifier row in a block's slab
constexpr int UKT = 64;    // classifier rows per pipeline stage: 8 per warp
constexpr int UST = 4;     // stages: up to 3 tiles (24 KB) in flight per block
constexpr int UBG_BIG = 32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// shared-memory reads widened to fp32: a lane's VEC adjacent columns (4
// bytes) of a staged row, and 8 consecutive x values of a batch row
__device__ __forceinline__ void lds4(const float* p, float* o) { o[0] = *p; }
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float* o) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    o[0] = __uint_as_float(u << 16);
    o[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void lds8(const float* p, float* o) {
    const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w, o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float* o) {
    pmt::widen(*reinterpret_cast<const uint4*>(p), o);
}

// Block (slab, group): vocab columns [slab * W, slab * W + W) (UROW bytes of
// each row) for batch rows [group * BG, group * BG + nb). The classifier
// streams through shared memory in tiles of UKT rows, UST - 1 tiles in flight
// (cp.async, 16-byte pieces), so the loads never wait on the FMAs; each warp
// takes 8 rows of a tile, each lane VEC adjacent columns, and every lane
// keeps the sums of all nb batch rows in registers, so the slab is read once
// for them all. The x rows sit in shared memory in T, 8 values to a read.
// The warps' sums then meet in shared memory and are added in warp order,
// rounded to T, and reduced to one (value, index) per batch row.
template <typename T, int BG>
__global__ void __launch_bounds__(NW * 32)
greedy_untied_kernel(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ part_val,
                     int* __restrict__ part_idx, int b, int v, int d, int n_chunks) {
    constexpr int VEC = 4 / sizeof(T);
    constexpr int W = UROW / sizeof(T);          // = 32 * VEC
    constexpr int E = 16 / sizeof(T);            // elements per 16-byte piece
    constexpr int RW = UKT / NW;                 // rows per warp per tile
    constexpr int PIECES = UKT * UROW / 16 / (NW * 32);  // 16-byte pieces per thread per tile
    extern __shared__ __align__(16) float smem[];
    T* tiles = reinterpret_cast<T*>(smem);       // (UST, UKT, W)
    T* xs = tiles + UST * UKT * W;               // (nb, d_pad), zero past d
    const int r0 = blockIdx.y * BG;
    const int nb = min(BG, b - r0);
    const int d_pad = (d + UKT - 1) / UKT * UKT;
    const int n_tiles = d_pad / UKT;
    const int c0 = blockIdx.x * W;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    const bool async_ok = static_cast<int64_t>(v) * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    auto issue = [&](int t) {
#pragma unroll
        for (int q = 0; q < PIECES; ++q) {
            const int piece = q * NW * 32 + threadIdx.x;
            const int pr = piece / (UROW / 16), pc = piece % (UROW / 16) * E;  // row, first column in the slab
            T* dst = tiles + ((t % UST) * UKT + pr) * W + pc;
            const int k = t * UKT + pr, col = c0 + pc;
            const T* src = w + static_cast<int64_t>(k) * v + col;
            if (async_ok) {  // v a multiple of E: a piece lies wholly inside or outside the row
                const bool in = k < d && col < v;
                cp_async16(dst, in ? src : w, in ? 16 : 0);  // 0 bytes: zero-filled
            } else {
#pragma unroll
                for (int e = 0; e < E; ++e) dst[e] = k < d && col + e < v ? src[e] : pmt::from_f32<T>(0.f);
            }
        }
    };
    // the x rows ride in the first tile's group, 16-byte pieces, zero-filled past d
    if (static_cast<int64_t>(d) * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
        const int row_pieces = d_pad / E;
        for (int q = threadIdx.x; q < nb * row_pieces; q += blockDim.x) {
            const int r = q / row_pieces, k = q % row_pieces * E;
            const bool in = k < d;
            cp_async16(xs + r * d_pad + k, in ? x + static_cast<int64_t>(r0 + r) * d + k : x, in ? 16 : 0);
        }
    } else {
        for (int r = 0; r < nb; ++r)
            for (int k = threadIdx.x; k < d_pad; k += blockDim.x)
                xs[r * d_pad + k] = k < d ? x[static_cast<int64_t>(r0 + r) * d + k] : pmt::from_f32<T>(0.f);
    }
    for (int t = 0; t < UST - 1; ++t) {
        if (t < n_tiles) issue(t);
        cp_async_commit();
    }

    float acc[BG][VEC];
#pragma unroll
    for (int i = 0; i < BG; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
        if (t + UST - 1 < n_tiles) issue(t + UST - 1);  // into the buffer tile t - 1 left
        cp_async_commit();
        cp_async_wait<UST - 1>();  // tile t has landed (this thread's pieces)
        __syncthreads();           // ... and every thread's; on t == 0 also xs
        const T* tile = tiles + ((t % UST) * UKT + warp * RW) * W + lane * VEC;
        float wv[RW][VEC];
#pragma unroll
        for (int u = 0; u < RW; ++u) lds4(tile + u * W, wv[u]);
        const T* xt = xs + t * UKT + warp * RW;
#pragma unroll
        for (int i = 0; i < BG; ++i) {
            if (i >= nb) break;  // uniform across the block
            float xa[RW];
            lds8(xt + i * d_pad, xa);  // the same address in every lane: a broadcast
#pragma unroll
            for (int u = 0; u < RW; ++u)
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(xa[u], wv[u][e], acc[i][e]);
        }
        __syncthreads();  // every warp is done with tile t's buffer before it is refilled
    }
    cp_async_wait<0>();

    float* red = smem;  // (NW, nb, W): the tiles' and xs's space, no longer read
#pragma unroll
    for (int i = 0; i < BG; ++i) {
        if (i >= nb) break;
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[(warp * nb + i) * W + lane * VEC + e] = acc[i][e];
    }
    __syncthreads();
    for (int i = warp; i < nb; i += NW) {  // one warp per batch row
        float bv = pmt::neg_inf();
        int bi = INT_MAX;
        for (int c = lane; c < W; c += 32) {
            const int gc = c0 + c;
            if (gc >= v) break;
            float s = 0.f;
#pragma unroll
            for (int q = 0; q < NW; ++q) s += red[(q * nb + i) * W + c];
            s = pmt::round_to<T>(s);
            if (better(s, gc, bv, bi)) bv = s, bi = gc;
        }
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            if (better(ov, oi, bv, bi)) bv = ov, bi = oi;
        }
        if (lane == 0) {
            part_val[static_cast<int64_t>(r0 + i) * n_chunks + blockIdx.x] = bv;
            part_idx[static_cast<int64_t>(r0 + i) * n_chunks + blockIdx.x] = bi;
        }
    }
}

int smem_optin() {
    int dev = 0, bytes = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return bytes;
}

size_t tied_smem(int b, int d) { return (static_cast<size_t>(b) * d + 2 * NW * b) * sizeof(float); }

// the tiles and the nb x rows (in T, as the tiles: UROW / w_cols bytes an
// element); the warps' fp32 sums reuse that space
size_t untied_smem(int nb, int d, int w_cols) {
    const size_t d_pad = (d + UKT - 1) / UKT * UKT;
    const size_t red = static_cast<size_t>(NW) * nb * w_cols * sizeof(float);
    return std::max(static_cast<size_t>(UST) * UKT * UROW + nb * d_pad * (UROW / w_cols), red);
}

// batch rows per untied block: all of them up to 8; else 32 where such a
// block fits, else 8 (then each group of 8 rows reads the classifier again)
int untied_rows(int b, int d, int w_cols) {
    if (b <= 8) return 8;
    return untied_smem(UBG_BIG, d, w_cols) <= static_cast<size_t>(smem_optin()) ? UBG_BIG : 8;
}

template <typename T, int BG>
int launch_untied_bg(const void* x, const void* w, float* pv, int* pi, int b, int v, int d, int n_chunks,
                     cudaStream_t s) {
    constexpr int W = UROW / sizeof(T);
    const size_t smem = untied_smem(std::min(BG, b), d, W);
    cudaError_t e = cudaFuncSetAttribute(greedy_untied_kernel<T, BG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    greedy_untied_kernel<T, BG><<<dim3(n_chunks, (b + BG - 1) / BG), NW * 32, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), pv, pi, b, v, d, n_chunks);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_untied(const void* x, const void* w, float* pv, int* pi, int64_t* out, int b, int v, int d,
                  int n_chunks, cudaStream_t s) {
    constexpr int W = UROW / sizeof(T);
    if (n_chunks != (v + W - 1) / W) return static_cast<int>(cudaErrorInvalidValue);
    const int bg = untied_rows(b, d, W);
    if (untied_smem(std::min(bg, b), d, W) > static_cast<size_t>(smem_optin()))
        return static_cast<int>(cudaErrorInvalidValue);
    const int rc = bg == UBG_BIG ? launch_untied_bg<T, UBG_BIG>(x, w, pv, pi, b, v, d, n_chunks, s)
                                 : launch_untied_bg<T, 8>(x, w, pv, pi, b, v, d, n_chunks, s);
    if (rc != 0) return rc;
    greedy_reduce_kernel<<<b, R_THREADS, 0, s>>>(pv, pi, out, n_chunks);
    return 0;
}

template <typename T>
int launch(const void* x, const void* emb, float* pv, int* pi, int64_t* out, int b, int v, int d, int n_chunks,
           cudaStream_t s) {
    const size_t smem = tied_smem(b, d);
    if (smem > static_cast<size_t>(smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(greedy_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    greedy_chunk_kernel<T><<<n_chunks, NW * 32, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(emb),
                                                           pv, pi, b, v, d, n_chunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    greedy_reduce_kernel<<<b, R_THREADS, 0, s>>>(pv, pi, out, n_chunks);
    return 0;
}

}  // namespace

extern "C" int pmt_greedy_chunk_rows() { return CHUNK; }

// vocab columns per pass-1 block of the untied kernel (128 bytes of each row)
extern "C" int pmt_greedy_untied_cols(int dtype) { return UROW / (dtype == pmt::DT_F32 ? 4 : 2); }

// 1 if the kernel serves B rows of width d on the current device (its first
// pass holds the rows in shared memory), else 0
extern "C" int pmt_greedy_fits(int b, int d, int dtype, int tied) {
    const size_t cap = static_cast<size_t>(smem_optin());
    if (tied) return tied_smem(b, d) <= cap;
    const int w_cols = pmt_greedy_untied_cols(dtype);
    return untied_smem(std::min(untied_rows(b, d, w_cols), b), d, w_cols) <= cap;
}

// x (B, d); emb (V, d); part_val/part_idx (B, n_chunks) scratch; out (B,) int64.
extern "C" int pmt_greedy_argmax_tied(const void* x, const void* emb, void* part_val, void* part_idx, void* out,
                                      int b, int v, int d, int n_chunks, int dtype, void* stream) {
    cudaStream_t s = pmt::as_stream(stream);
    float* pv = static_cast<float*>(part_val);
    int* pi = static_cast<int*>(part_idx);
    int64_t* o = static_cast<int64_t*>(out);
    int rc = dtype == pmt::DT_F32 ? launch<float>(x, emb, pv, pi, o, b, v, d, n_chunks, s)
                                  : launch<__nv_bfloat16>(x, emb, pv, pi, o, b, v, d, n_chunks, s);
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
}

// x (B, d); w (d, V) untied classifier; part_val/part_idx (B, n_chunks) scratch with
// n_chunks = ceil(V / pmt_greedy_untied_cols(dtype)); out (B,) int64.
extern "C" int pmt_greedy_argmax_untied(const void* x, const void* w, void* part_val, void* part_idx, void* out,
                                        int b, int v, int d, int n_chunks, int dtype, void* stream) {
    cudaStream_t s = pmt::as_stream(stream);
    float* pv = static_cast<float*>(part_val);
    int* pi = static_cast<int*>(part_idx);
    int64_t* o = static_cast<int64_t*>(out);
    int rc = dtype == pmt::DT_F32 ? launch_untied<float>(x, w, pv, pi, o, b, v, d, n_chunks, s)
                                  : launch_untied<__nv_bfloat16>(x, w, pv, pi, o, b, v, d, n_chunks, s);
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
}
