// Row gather for embedding lookups: out[r] = table[clamp(idx[r], 0, V-1)].
//
// Replaces pytorch_models_tpu/ops/gather.py `gather_rows` (the Pallas kernel
// issuing one DMA per 8-row window). What bounds it on the H100: bytes — it
// moves N * D * itemsize bytes and does no arithmetic; at decode sizes
// (N = batch, D = 768) it is a few KB, so the launch itself dominates. The
// design: one block per output row, 16-byte vector copies when the row and
// both base pointers allow it (a 768-wide fp32 row is 192 such copies), byte
// copies otherwise. Ids are clamped like jnp.take so an out-of-range id never
// reads outside the table.
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

}  // namespace

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
