// Row gather for embedding lookups: out[r] = table[clamp(idx[r], 0, V-1)],
// and the decode embedding in one launch: out[r] = tok[id] + pos[pid].
//
// Replaces pytorch_models_tpu/ops/gather.py `gather_rows` (the Pallas kernel
// issuing one DMA per 8-row window). What bounds it on the H100: bytes — it
// moves N * D * itemsize bytes and does no arithmetic; at decode sizes
// (N = batch, D = 768) it is a few KB, so the launch itself dominates (the
// byte bound of 8 rows is under 0.01 us, a launch about 2 us). The design of
// `pmt_gather_rows`: one block per output row, 16-byte vector copies when the
// row and both base pointers allow it (a 768-wide fp32 row is 192 such
// copies), byte copies otherwise. Ids are clamped like jnp.take so an
// out-of-range id never reads outside the table.
//
// `pmt_embed_add` removes launches instead: a decode step's input used to be
// a gather of the token rows, an int64 copy of int32 ids, a gather of the
// position rows, a cast and an add (up to five launches). It reads the ids
// as they are (int32 or int64), takes each row's position either from an id
// per row or as start + (r % period) (a (B, S) prefill chunk, Whisper's
// pos:pos+S slice), and writes round(float(tok) + float(round(pos))) in the
// table's dtype: bit for bit the torch sequence, whose bf16 add rounds the
// fp32 sum once. Without a position table it is the plain gather.
#include "common.cuh"

namespace {

__global__ void gather_rows_vec16(const uint4* __restrict__ table, const int64_t* __restrict__ idx,
                                  uint4* __restrict__ out, int v, int row_vecs) {
    const int r = blockIdx.x;
    int64_t i = idx[r];
    i = i < 0 ? 0 : (i >= v ? v - 1 : i);
    const uint4* src = table + i * row_vecs;
    uint4* dst = out + static_cast<int64_t>(r) * row_vecs;
    for (int c = threadIdx.x; c < row_vecs; c += blockDim.x) dst[c] = src[c];
}

__global__ void gather_rows_bytes(const unsigned char* __restrict__ table, const int64_t* __restrict__ idx,
                                  unsigned char* __restrict__ out, int v, int row_bytes) {
    const int r = blockIdx.x;
    int64_t i = idx[r];
    i = i < 0 ? 0 : (i >= v ? v - 1 : i);
    const unsigned char* src = table + i * row_bytes;
    unsigned char* dst = out + static_cast<int64_t>(r) * row_bytes;
    for (int c = threadIdx.x; c < row_bytes; c += blockDim.x) dst[c] = src[c];
}

__device__ __forceinline__ int64_t load_id(const void* ids, int64_t r, int is64) {
    return is64 ? static_cast<const int64_t*>(ids)[r] : static_cast<const int32_t*>(ids)[r];
}

__device__ __forceinline__ int64_t clamp_id(int64_t i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

// VEC elements of T moved as one load/store of this raw type
template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = unsigned; };
template <>
struct Raw<2> { using type = unsigned short; };

// one block per output row, VEC elements per thread and iteration; T is the token table's and the output's
// dtype, TP the position table's
template <typename T, typename TP, bool HAS_POS, int VEC>
__global__ void embed_add_kernel(const T* __restrict__ tok, const void* __restrict__ ids, int ids64, int v,
                                 const TP* __restrict__ pos, const void* __restrict__ pids, int pids64, int vp,
                                 int start, int period, T* __restrict__ out, int d) {
    using R = typename Raw<VEC * sizeof(T)>::type;
    using RP = typename Raw<VEC * sizeof(TP)>::type;
    const int r = blockIdx.x;
    const T* src = tok + clamp_id(load_id(ids, r, ids64), v) * d;
    T* dst = out + static_cast<int64_t>(r) * d;
    const TP* psrc = nullptr;
    if constexpr (HAS_POS) {
        const int64_t p = pids != nullptr ? load_id(pids, r, pids64) : static_cast<int64_t>(start) + r % period;
        psrc = pos + clamp_id(p, vp) * d;
    }
    for (int c = threadIdx.x * VEC; c < d; c += blockDim.x * VEC) {
        R a = *reinterpret_cast<const R*>(src + c);
        if constexpr (HAS_POS) {
            const RP b = *reinterpret_cast<const RP*>(psrc + c);
            const T* ae = reinterpret_cast<const T*>(&a);
            const TP* be = reinterpret_cast<const TP*>(&b);
            R o;
            T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
            for (int k = 0; k < VEC; ++k)
                oe[k] = pmt::from_f32<T>(pmt::to_f32(ae[k]) + pmt::round_to<T>(pmt::to_f32(be[k])));
            a = o;
        }
        *reinterpret_cast<R*>(dst + c) = a;
    }
}

template <typename T, typename TP, bool HAS_POS>
cudaError_t launch_embed_add(const void* tok, const void* ids, int ids64, int v, const void* pos, const void* pids,
                             int pids64, int vp, int start, int period, void* out, int n, int d, cudaStream_t s) {
    // 4 elements a thread where the row and every base pointer allow it (8 bytes of bf16, 16 of fp32)
    const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(tok) % (4 * sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0 &&
                     (!HAS_POS || reinterpret_cast<uintptr_t>(pos) % (4 * sizeof(TP)) == 0);
    const int chunks = vec ? d / 4 : d;
    const int threads = chunks >= 256 ? 256 : (chunks + 31) / 32 * 32;
    const T* t = static_cast<const T*>(tok);
    const TP* p = static_cast<const TP*>(pos);
    T* o = static_cast<T*>(out);
    if (vec)
        embed_add_kernel<T, TP, HAS_POS, 4><<<n, threads, 0, s>>>(t, ids, ids64, v, p, pids, pids64, vp, start, period,
                                                                  o, d);
    else
        embed_add_kernel<T, TP, HAS_POS, 1><<<n, threads, 0, s>>>(t, ids, ids64, v, p, pids, pids64, vp, start, period,
                                                                  o, d);
    return cudaGetLastError();
}

template <typename T>
cudaError_t embed_add_for(const void* tok, const void* ids, int ids64, int v, const void* pos, int pos_dt,
                          const void* pids, int pids64, int vp, int start, int period, void* out, int n, int d,
                          cudaStream_t s) {
    if (pos == nullptr)
        return launch_embed_add<T, T, false>(tok, ids, ids64, v, pos, pids, pids64, vp, start, period, out, n, d, s);
    if (pos_dt == pmt::DT_F32)
        return launch_embed_add<T, float, true>(tok, ids, ids64, v, pos, pids, pids64, vp, start, period, out, n, d,
                                                s);
    return launch_embed_add<T, __nv_bfloat16, true>(tok, ids, ids64, v, pos, pids, pids64, vp, start, period, out, n,
                                                    d, s);
}

__global__ void empty_kernel() {}

}  // namespace

// An empty kernel of `blocks` x `threads`: the launch floor a kernel as small as the decode embedding is
// timed against (its byte bound lies far below any launch).
extern "C" int pmt_launch_floor(int blocks, int threads, void* stream) {
    empty_kernel<<<blocks, threads, 0, pmt::as_stream(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

// tok (V, D) and out (N, D) of dtype tok_dt; ids (N,) int32 or int64 (ids64); pos (Vp, D) of dtype pos_dt or
// null; pids (N,) int32/int64 (pids64) or null, then row r takes position start + r % period. Ids clamp to
// their table. One launch.
extern "C" int pmt_embed_add(const void* tok, int tok_dt, int v, const void* ids, int ids64, const void* pos,
                             int pos_dt, int vp, const void* pids, int pids64, int start, int period, void* out, int n,
                             int d, void* stream) {
    if (n <= 0) return 0;
    if (period <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = pmt::as_stream(stream);
    const cudaError_t e =
        tok_dt == pmt::DT_F32
            ? embed_add_for<float>(tok, ids, ids64, v, pos, pos_dt, pids, pids64, vp, start, period, out, n, d, s)
            : embed_add_for<__nv_bfloat16>(tok, ids, ids64, v, pos, pos_dt, pids, pids64, vp, start, period, out, n,
                                           d, s);
    return static_cast<int>(e);
}

// table (V, D) row-major, idx (N,) int64, out (N, D); row_bytes = D * sizeof(element).
extern "C" int pmt_gather_rows(const void* table, const void* idx, void* out, int n, int v, int row_bytes,
                               void* stream) {
    if (n <= 0) return 0;
    const bool vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    cudaStream_t s = pmt::as_stream(stream);
    if (vec) {
        gather_rows_vec16<<<n, 128, 0, s>>>(static_cast<const uint4*>(table), static_cast<const int64_t*>(idx),
                                            static_cast<uint4*>(out), v, row_bytes / 16);
    } else {
        gather_rows_bytes<<<n, 256, 0, s>>>(static_cast<const unsigned char*>(table),
                                            static_cast<const int64_t*>(idx), static_cast<unsigned char*>(out), v,
                                            row_bytes);
    }
    return static_cast<int>(cudaGetLastError());
}
