// Single-position decode attention over an int8 KV cache (K6).
//
// Replaces pytorch_models_tpu/ops/int8_kv.py `int8_decode_attention` (the
// Pallas kernel at its `pl.pallas_call`): one query per row against int8
// K/V caches (B, Lk, H*D) with per-key fp32 scales (B, Lk), over keys
// [pad_b, end_b), optionally folding this step's unquantized K/V in as the
// current position (self-attention decode; the cache holds [0, pos)), and
// optionally adding a key-major (Lk, H) fp32 bias (T5's rel-pos decode bias;
// at the current position its row ends[0]). The arithmetic is
// csrc/int8_attn.cuh's, shared with the fused decode step.
//
// What bounds it on the H100: bytes. A step reads each valid key's int8 K
// and V once (2 * keys * H*D bytes, half of bf16) plus 8 bytes of scales,
// and does ~4 int8 operations per byte, far below the card's int8 ridge.
// The TPU kernel packs up to 8 rows into one block-diagonal int8 MXU matmul
// per 128-key block (its q-expander), a layout made for a 128 x 128 matrix
// unit; here one block of 256 threads serves one (row, head) and walks the
// row's own 128-key blocks (skipping those outside [pad, end) is exact: the
// oracle gives them p_i8 = 0): scores by __dp4a, four threads per key; the
// int8 P @ V in int32. Simple by design: no tensor cores (mma.sync s8) and
// no async copies yet, and a long cache is not split across blocks.
#include "int8_attn.cuh"

namespace {

constexpr int NTH = 256;

template <typename T>
__global__ void __launch_bounds__(NTH)
int8_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
                      const float* __restrict__ ks, const float* __restrict__ vs, const int* __restrict__ ends,
                      int end_scalar, const int* __restrict__ pads, const T* __restrict__ cur_k,
                      const T* __restrict__ cur_v, const float* __restrict__ bias, T* __restrict__ out, int l_k,
                      int n_heads, float scale) {
    __shared__ __align__(16) char smem[pmt::i8_unit_smem<NTH>()];
    const int h = blockIdx.x, b = blockIdx.y;
    const int hd = n_heads * pmt::I8_D;
    const int end = min(ends ? ends[b] : end_scalar, l_k);
    const int pad = pads ? max(pads[b], 0) : 0;
    const int64_t row = static_cast<int64_t>(b) * l_k;
    pmt::I8Cur cur{};
    if (cur_k) {
        const int cur_pos = ends ? ends[0] : end_scalar;  // the oracle's bias row of the current position
        cur.k = cur_k + static_cast<int64_t>(b) * hd;
        cur.v = cur_v + static_cast<int64_t>(b) * hd + h * pmt::I8_D;
        cur.bias = bias ? bias[static_cast<int64_t>(cur_pos) * n_heads + h] : 0.f;
    }
    pmt::i8_attention_unit<T, NTH>(q + static_cast<int64_t>(b) * hd + h * pmt::I8_D, scale,
                                   kq + row * hd + h * pmt::I8_D, vq + row * hd + h * pmt::I8_D, ks + row, vs + row,
                                   hd, pad, end, bias, n_heads, h, cur_k ? &cur : nullptr,
                                   out + static_cast<int64_t>(b) * hd + h * pmt::I8_D, smem);
}

}  // namespace

extern "C" int pmt_int8_attention(const void* q, const void* kq, const void* vq, const void* ks, const void* vs,
                                  const void* ends, int end_scalar, const void* pads, const void* cur_k,
                                  const void* cur_v, const void* bias, void* out, int b, int l_k, int n_heads,
                                  float scale, int dtype, void* stream) {
    const dim3 grid(n_heads, b);
    auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
    auto f32 = [](const void* p) { return static_cast<const float*>(p); };
    auto i32 = [](const void* p) { return static_cast<const int*>(p); };
    if (dtype == pmt::DT_F32) {
        using T = float;
        int8_attention_kernel<T><<<grid, NTH, 0, pmt::as_stream(stream)>>>(
            static_cast<const T*>(q), i8(kq), i8(vq), f32(ks), f32(vs), i32(ends), end_scalar, i32(pads),
            static_cast<const T*>(cur_k), static_cast<const T*>(cur_v), f32(bias), static_cast<T*>(out), l_k, n_heads,
            scale);
    } else {
        using T = __nv_bfloat16;
        int8_attention_kernel<T><<<grid, NTH, 0, pmt::as_stream(stream)>>>(
            static_cast<const T*>(q), i8(kq), i8(vq), f32(ks), f32(vs), i32(ends), end_scalar, i32(pads),
            static_cast<const T*>(cur_k), static_cast<const T*>(cur_v), f32(bias), static_cast<T*>(out), l_k, n_heads,
            scale);
    }
    return static_cast<int>(cudaGetLastError());
}
