// Log-mel spectrogram: Hann-windowed real DFT, |.|^2, mel filterbank, log10.
//
// Replaces pytorch_models_tpu/ops/mel.py `log_mel_spectrogram` (the Pallas
// kernel `_logmel_kernel`). For every frame f of the reflect-padded
// waveform: re = f . W_re, im = f . W_im (Hann-folded DFT bases, n_fft x
// n_freq), p = re^2 + im^2, mel = p . F (n_freq x n_mels), out =
// log(max(mel, 0)) / ln 10 — so a silent frame gives -inf, as in the JAX
// kernel. All fp32.
//
// What bounds it on the H100: arithmetic. Whisper's 30 s segment is 3001
// frames x 402 real DFT outputs x 400 samples (0.97 GFLOP a segment)
// against 1.9 MB of waveform, far above the memory ridge, so the DFT runs on
// the tensor cores, as 3xTF32 mma.m16n8k8 (each fp32 operand split hi + lo,
// hi*hi + hi*lo + lo*hi, about 2^-21 per product: single TF32 would not
// hold the log10 values four decades of amplitude below the peak bins):
// - one block of 12 warps per (tile of 96 frames, batch row): frames on M
//   (6 warps of one m16 tile), DFT outputs on N (2 warps of 13 n8 tiles a
//   pass of 208 columns, 2 passes), samples on K; the three TF32 products
//   run pass by pass over the warp's 13 accumulators, so consecutive mma
//   instructions never feed one accumulator;
// - the output columns are interleaved (re_k, im_k), so the two columns of
//   a C fragment that one thread holds are re and im of one bin, and the
//   power is formed in registers;
// - the bases come split on the host (ops/mel.py `_kernel_constants`): hi
//   and lo arrays of the interleaved columns, padded to whole passes and to
//   16 samples, which `stage_kernel` lays out once, on the device, as the
//   ring's stage images (a pass's 208 rows of hi, then of lo, 16 samples
//   each, 16-byte chunks swizzled by `swz` so that ldmatrix reads them
//   without bank conflicts). One thread moves each 26 KB stage with a single
//   bulk copy (cp.async.bulk onto an mbarrier) into a 3-slot ring (the
//   per-thread 16-byte cp.async of the first version cost 21% of the time);
//   one ldmatrix.x4 gives an n8 tile's hi and lo B fragments;
// - frames overlap (hop < n_fft), so the block stages its tile's sample span
//   once, straight from the padded waveform (4-byte cp.async, zero past the
//   end). A frame stride of hop = 160 floats is 0 mod 32 banks, so the span
//   is stored with a skew: every hop samples are followed by `skew` unused
//   floats (hop + skew = 4 mod 32), which puts frame r's sample n at
//   r * (hop + skew) + koff[n] and the 8 frames one ldmatrix reads on 8
//   distinct bank groups (a hop that is no multiple of 4 breaks the 16-byte
//   rows ldmatrix needs: its A fragments are read by scalar loads, which the
//   same skew keeps on distinct banks); the frames' A fragments are split
//   hi/lo in registers;
// - after each pass the power of its bins goes to a (96, n_freq) tile in
//   shared memory; the mel product then sums each filter over its band
//   [lo, hi) only (ops/mel.py `_mel_bands`: the contiguous run of nonzero
//   weights; the skipped terms are exact zeros), one thread per frame and 4
//   mel bins, a warp on 32 consecutive frames, and writes (B, n_mels, F)
//   with coalesced stores.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int TF = 96;                 // frames per block
constexpr int WMF = TF / 16;           // warps along the frames, one m16 tile each
constexpr int WNF = 2;                 // warps along the columns
constexpr int NTW = 13;                // n8 tiles per warp per pass
constexpr int PASS_COLS = WNF * NTW * 8;  // 208 interleaved columns (104 bins) per pass
constexpr int KS = 16;                 // samples per stage
constexpr int KCH = KS / 4;            // 16-byte chunks of a staged basis row
constexpr int STAGES = 3;
constexpr int NTH = 32 * WMF * WNF;    // 384 threads
constexpr int SLAB_FLOATS = PASS_COLS * KS;  // one part (hi or lo) of a stage
constexpr int MAX_SMEM = 227 * 1024;
constexpr float INV_LN10 = 0.43429448190325176f;

// odd row stride of the power tile: the mel product reads it down a column
inline __host__ __device__ int pw_stride(int n_freq) { return n_freq | 1; }
inline __host__ __device__ int skew_of(int hop) { return ((4 - hop) % 32 + 32) % 32; }
inline __host__ __device__ int span_of(int hop, int kp) { return (TF - 1) * hop + kp; }
// floats of the skewed span, rounded to 16 bytes
inline __host__ __device__ int span_floats(int hop, int kp) {
    const int span = span_of(hop, kp);
    return (span + skew_of(hop) * (span / hop + 1) + 3) / 4 * 4;
}

inline size_t smem_bytes(int hop, int kp, int n_freq) {
    return sizeof(float) * (static_cast<size_t>(STAGES) * 2 * SLAB_FLOATS + span_floats(hop, kp) +
                            static_cast<size_t>(TF) * pw_stride(n_freq) + kp + (kp & 1)) +
           STAGES * sizeof(unsigned long long);
}

// swizzle of a staged basis row's KCH chunks: the 8 rows one ldmatrix reads sit on 8 bank groups
__device__ __forceinline__ int swz(int row) { return (row * KCH / 8) & (KCH - 1); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(pmt::smem_addr(dst)), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}

// parts (2, ncol, kp): the interleaved bases' tf32 hi and lo parts -> tiles
// (passes * kp / KS, 2, PASS_COLS, KS): stage s (pass s / (kp / KS), samples
// from s % (kp / KS) * KS) as the ring holds it, one 16-byte chunk a thread
__global__ void stage_kernel(const float4* __restrict__ parts, float4* __restrict__ tiles, int ncol, int kp) {
    const int cpr = kp / 4, nks = kp / KS;
    const int64_t n = 2LL * ncol * cpr;
    for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
        const int c = static_cast<int>(i % cpr), col = static_cast<int>(i / cpr % ncol), part = static_cast<int>(i / cpr / ncol);
        const int p = col / PASS_COLS, r = col % PASS_COLS, s = p * nks + c / KCH;
        tiles[((static_cast<int64_t>(s) * 2 + part) * PASS_COLS + r) * KCH + ((c % KCH) ^ swz(r))] = parts[i];
    }
}

// x (B, lp); tiles (passes * kp / KS, 2, PASS_COLS, KS) from `stage_kernel`;
// filt (n_freq, n_mels); bands (n_mels, 2) [lo, hi). LDSM: hop % 4 == 0, the
// frames' A fragments by ldmatrix; else by scalar loads
template <bool LDSM>
__global__ void __launch_bounds__(NTH, 1)
log_mel_kernel(const float* __restrict__ x, const float* __restrict__ tiles, const float* __restrict__ filt,
               const int* __restrict__ bands, float* __restrict__ out, int lp, int n_frames, int hop, int n_freq,
               int n_mels, int kp, int passes) {
    extern __shared__ __align__(128) float smem[];
    const int skew = skew_of(hop), rs = hop + skew, ps = pw_stride(n_freq);
    float* ring = smem;                                // (STAGES, 2, PASS_COLS, KS)
    float* sig = ring + STAGES * 2 * SLAB_FLOATS;      // the skewed span
    float* pw = sig + span_floats(hop, kp);            // (TF, ps) power
    int* koff = reinterpret_cast<int*>(pw + TF * ps);  // (kp,) sample n -> its offset in a frame's row
    auto* bar = reinterpret_cast<unsigned long long*>(koff + kp + (kp & 1));  // one mbarrier per ring slot

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp % WMF, wn = warp / WMF;
    const int g = lane >> 2, t = lane & 3;
    const int f0 = blockIdx.x * TF, b = blockIdx.y;
    const int nks = kp / KS, n_st = passes * nks;

    // stage s: its slab image, one bulk copy into ring slot s % STAGES, completing on that slot's mbarrier
    auto issue = [&](int s) {
        constexpr unsigned BYTES = 2 * SLAB_FLOATS * sizeof(float);
        pmt::mbar_expect(bar + s % STAGES, BYTES);
        pmt::bulk_copy(ring + (s % STAGES) * 2 * SLAB_FLOATS, tiles + static_cast<int64_t>(s) * 2 * SLAB_FLOATS,
                       BYTES, bar + s % STAGES);
    };
    if (tid == 0) {
        for (int i = 0; i < STAGES; ++i) pmt::mbar_init(bar + i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < STAGES && s < n_st; ++s) issue(s);
    }
    // the span, once: sample i of the tile at i + skew * (i / hop); zero past the waveform
    {
        const float* xb = x + static_cast<int64_t>(b) * lp;
        const int64_t s0 = static_cast<int64_t>(f0) * hop;
        const int span = span_of(hop, kp);
        for (int i = tid; i < span; i += NTH) {
            const bool in = s0 + i < lp;
            cp_async4(sig + i + skew * (i / hop), in ? xb + s0 + i : x, in ? 4 : 0);
        }
        for (int n = tid; n < kp; n += NTH) koff[n] = n + skew * (n / hop);
        pmt::cp_commit();
        pmt::cp_wait<0>();
    }
    __syncthreads();  // the span, koff and the mbarriers are ready

    float acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int s = 0; s < n_st; ++s) {
        pmt::mbar_wait(bar + s % STAGES, (s / STAGES) & 1);  // stage s landed

        const float* hi = ring + (s % STAGES) * 2 * SLAB_FLOATS;
        const float* lo = hi + SLAB_FLOATS;
#pragma unroll
        for (int kk = 0; kk < KS / 8; ++kk) {
            uint32_t q[NTW][4];  // the warp's B fragments: b0, b1 of hi; b0, b1 of lo
            {
                const int m = lane >> 3, c = kk * 2 + (m & 1);
                const float* part = m >> 1 ? lo : hi;
#pragma unroll
                for (int j = 0; j < NTW; ++j) {
                    const int row = (wn * NTW + j) * 8 + (lane & 7);
                    pmt::ldmatrix_x4(q[j], part + row * KS + ((c ^ swz(row)) << 2));
                }
            }
            const int kb = s % nks * KS + kk * 8;
            uint32_t a[4], ah[4], al[4];
            if (LDSM) {
                pmt::ldmatrix_x4(a, sig + (wm * 16 + (lane & 15)) * rs + koff[kb + ((lane >> 4) << 2)]);
            } else {  // the fragment ldmatrix gives: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
                const float* r0 = sig + (wm * 16 + g) * rs;
                const int o0 = koff[kb + t], o4 = koff[kb + 4 + t];
                a[0] = __float_as_uint(r0[o0]), a[1] = __float_as_uint(r0[8 * rs + o0]);
                a[2] = __float_as_uint(r0[o4]), a[3] = __float_as_uint(r0[8 * rs + o4]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) pmt::split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
            // 3xTF32, each pass over every n8 tile before the next (consecutive products feed different
            // accumulators)
#pragma unroll
            for (int j = 0; j < NTW; ++j) pmt::mma_tf32(acc[j], al, q[j]);
#pragma unroll
            for (int j = 0; j < NTW; ++j) pmt::mma_tf32(acc[j], ah, q[j] + 2);
#pragma unroll
            for (int j = 0; j < NTW; ++j) pmt::mma_tf32(acc[j], ah, q[j]);
        }

        if (s % nks == nks - 1) {  // the pass's last slab: its bins' power into the tile
            const int p = s / nks;
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
                const int bin = p * (PASS_COLS / 2) + (wn * NTW + j) * 4 + t;
                const int f = wm * 16 + g;
                if (bin < n_freq) {
                    pw[f * ps + bin] = acc[j][0] * acc[j][0] + acc[j][1] * acc[j][1];
                    pw[(f + 8) * ps + bin] = acc[j][2] * acc[j][2] + acc[j][3] * acc[j][3];
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
            }
        }
        __syncthreads();  // every warp is done with slot s % STAGES: refill it with stage s + STAGES
        if (tid == 0 && s + STAGES < n_st) {
            pmt::fence_async_shared();
            issue(s + STAGES);
        }
    }

    // mel product over each filter's band + log10: a thread takes one frame
    // and MG mel bins (independent sums in flight), a warp 32 consecutive
    // frames of the same bins, so the filter weights are broadcasts and the
    // stores coalesce
    constexpr int MG = 4;
    const int n_mg = (n_mels + MG - 1) / MG;
    for (int idx = tid; idx < TF * n_mg; idx += NTH) {
        const int f = idx % TF, m0 = idx / TF * MG;
        if (f0 + f >= n_frames) continue;
        const float* pr = pw + f * ps;
        float v[MG];
#pragma unroll
        for (int u = 0; u < MG; ++u) {
            v[u] = 0.f;
            const int m = m0 + u;
            if (m >= n_mels) continue;
            const int lo_k = __ldg(bands + 2 * m), hi_k = __ldg(bands + 2 * m + 1);
            for (int k = lo_k; k < hi_k; ++k) v[u] = fmaf(pr[k], __ldg(filt + static_cast<int64_t>(k) * n_mels + m), v[u]);
        }
#pragma unroll
        for (int u = 0; u < MG; ++u)
            if (m0 + u < n_mels)
                out[(static_cast<int64_t>(b) * n_mels + m0 + u) * n_frames + f0 + f] = logf(fmaxf(v[u], 0.f)) * INV_LN10;
    }
}

}  // namespace

// The layout the host builds the bases in: interleaved columns in passes of
// this many, samples padded to a multiple of this many.
extern "C" int pmt_log_mel_pass_cols() { return PASS_COLS; }
extern "C" int pmt_log_mel_k_step() { return KS; }

// parts (2, ncol, kp) fp32: the tf32 hi and lo parts of the interleaved
// bases (ops/mel.py `_kernel_constants`; ncol a multiple of
// pmt_log_mel_pass_cols(), kp of pmt_log_mel_k_step()) -> tiles, as many
// floats, the ring's stage images that pmt_log_mel reads
extern "C" int pmt_log_mel_stage(const void* parts, void* tiles, int ncol, int kp, void* stream) {
    if (ncol <= 0 || kp <= 0 || ncol % PASS_COLS != 0 || kp % KS != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t chunks = 2LL * ncol * (kp / 4);
    const int grid = static_cast<int>(std::min<int64_t>((chunks + 255) / 256, 4096));
    stage_kernel<<<grid, 256, 0, pmt::as_stream(stream)>>>(static_cast<const float4*>(parts),
                                                            static_cast<float4*>(tiles), ncol, kp);
    return static_cast<int>(cudaGetLastError());
}

// x (B, lp) reflect-padded fp32 waveform; tiles: the stage images of
// pmt_log_mel_stage (ncol covering 2 * n_freq columns, kp >= n_fft samples,
// zero past both); filt (n_freq, n_mels); bands (n_mels, 2) int32; out
// (B, n_mels, n_frames) with frame f = x[b, f*hop : f*hop + n_fft].
extern "C" int pmt_log_mel(const void* x, const void* tiles, const void* filt, const void* bands, void* out, int b,
                           int lp, int n_frames, int n_fft, int hop, int n_freq, int n_mels, int ncol, int kp,
                           void* stream) {
    if (b <= 0 || n_frames <= 0) return 0;
    if (hop <= 0 || kp % KS != 0 || kp < n_fft || ncol % PASS_COLS != 0 || ncol < 2 * n_freq)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(hop, kp, n_freq);
    if (smem > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
    auto* k = hop % 4 == 0 ? log_mel_kernel<true> : log_mel_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((n_frames + TF - 1) / TF, b);
    k<<<grid, NTH, smem, pmt::as_stream(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(tiles), static_cast<const float*>(filt),
        static_cast<const int*>(bands), static_cast<float*>(out), lp, n_frames, hop, n_freq, n_mels, kp,
        ncol / PASS_COLS);
    return static_cast<int>(cudaGetLastError());
}
