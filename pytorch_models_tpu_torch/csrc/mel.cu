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
// frames x 201 bins x 400 samples x 2 bases = 0.97 GFLOP against 1.9 MB of
// waveform, far above the memory ridge; a fast version needs the tensor
// cores (3xTF32 wgmma), which this first kernel does not use. The design is
// a plain shared-memory GEMM on CUDA cores: one block per (tile of TF
// frames, batch row). Frames overlap (hop < n_fft), so the block stages the
// tile's contiguous sample span once — (TF-1)*hop + n_fft samples read
// straight from the padded waveform with row stride `hop`, never a
// (frames, n_fft) copy. It walks the bins in chunks of KF, staging slabs of
// KN basis rows in shared memory; 256 threads each accumulate 2 frames x 2
// bins of re and im in registers. The power tile (TF x n_freq) stays in
// shared memory for the mel product, which writes (B, n_mels, F) directly
// (frames contiguous, so a warp's stores coalesce).
#include "common.cuh"

namespace {

constexpr int TF = 32;   // frames per block
constexpr int KF = 32;   // frequency bins per chunk
constexpr int KN = 80;   // basis rows (samples) per staged slab
constexpr int NT = 256;  // 16 x 16 threads: bins tx, tx+16 of the chunk; frames ty, ty+16 of the tile
constexpr int MAX_SMEM = 227 * 1024;
constexpr float INV_LN10 = 0.43429448190325176f;

// odd row stride of the power tile: the mel product reads it down a column
inline __host__ __device__ int pw_stride(int n_freq) { return n_freq | 1; }

inline size_t smem_bytes(int n_fft, int hop, int n_freq) {
    return sizeof(float) *
           (static_cast<size_t>(TF - 1) * hop + n_fft + static_cast<size_t>(TF) * pw_stride(n_freq) + 2 * KN * KF);
}

__global__ void __launch_bounds__(NT)
log_mel_kernel(const float* __restrict__ x, const float* __restrict__ w_re, const float* __restrict__ w_im,
               const float* __restrict__ filt, float* __restrict__ out, int lp, int n_frames, int n_fft, int hop,
               int n_freq, int n_mels) {
    extern __shared__ float smem[];
    const int span = (TF - 1) * hop + n_fft;
    const int ps = pw_stride(n_freq);
    float* sig = smem;           // [span] samples of this tile's frames
    float* pw = sig + span;      // [TF][ps] power
    float* bre = pw + TF * ps;   // [KN][KF] basis slab, real part
    float* bim = bre + KN * KF;  // [KN][KF] imaginary part

    const int f0 = blockIdx.x * TF;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const float* xb = x + static_cast<int64_t>(b) * lp;
    const int64_t s0 = static_cast<int64_t>(f0) * hop;
    // samples past the waveform (frames past the last) stage as zeros; their
    // rows are computed and never written
    for (int i = tid; i < span; i += NT) {
        const int64_t j = s0 + i;
        sig[i] = j < lp ? xb[j] : 0.f;
    }

    const int tx = tid % 16, ty = tid / 16;
    const float* fa = sig + ty * hop;         // frame f0 + ty
    const float* fb = sig + (ty + 16) * hop;  // frame f0 + ty + 16
    for (int k0 = 0; k0 < n_freq; k0 += KF) {
        float re[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        float im[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        for (int n0 = 0; n0 < n_fft; n0 += KN) {
            __syncthreads();  // the previous slab's readers are done (and `sig` is staged)
            for (int i = tid; i < KN * KF; i += NT) {
                const int r = i / KF, c = i % KF, n = n0 + r, k = k0 + c;
                const bool ok = n < n_fft && k < n_freq;
                bre[i] = ok ? w_re[static_cast<int64_t>(n) * n_freq + k] : 0.f;
                bim[i] = ok ? w_im[static_cast<int64_t>(n) * n_freq + k] : 0.f;
            }
            __syncthreads();
            const int nn = min(KN, n_fft - n0);
            for (int r = 0; r < nn; ++r) {
                const float a[2] = {fa[n0 + r], fb[n0 + r]};
                const float c[2] = {bre[r * KF + tx], bre[r * KF + tx + 16]};
                const float d[2] = {bim[r * KF + tx], bim[r * KF + tx + 16]};
#pragma unroll
                for (int i = 0; i < 2; ++i) {
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        re[i][j] = fmaf(a[i], c[j], re[i][j]);
                        im[i][j] = fmaf(a[i], d[j], im[i][j]);
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int k = k0 + tx + 16 * j;
                if (k < n_freq) pw[(ty + 16 * i) * ps + k] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
            }
        }
    }
    __syncthreads();

    // mel product + log10: a warp takes 32 frames of one mel bin, so the
    // filter value is a broadcast and the stores are contiguous
    for (int idx = tid; idx < TF * n_mels; idx += NT) {
        const int f = idx % TF, m = idx / TF;
        if (f0 + f >= n_frames) continue;
        const float* pr = pw + f * ps;
        float acc = 0.f;
        for (int k = 0; k < n_freq; ++k) acc = fmaf(pr[k], filt[static_cast<int64_t>(k) * n_mels + m], acc);
        out[(static_cast<int64_t>(b) * n_mels + m) * n_frames + f0 + f] = logf(fmaxf(acc, 0.f)) * INV_LN10;
    }
}

}  // namespace

// x (B, lp) reflect-padded fp32 waveform; w_re, w_im (n_fft, n_freq); filt
// (n_freq, n_mels); out (B, n_mels, n_frames) with frame f = x[b, f*hop :
// f*hop + n_fft].
extern "C" int pmt_log_mel(const void* x, const void* w_re, const void* w_im, const void* filt, void* out, int b,
                           int lp, int n_frames, int n_fft, int hop, int n_freq, int n_mels, void* stream) {
    if (b <= 0 || n_frames <= 0) return 0;
    const size_t smem = smem_bytes(n_fft, hop, n_freq);
    if (smem > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((n_frames + TF - 1) / TF, b);
    log_mel_kernel<<<grid, NT, smem, pmt::as_stream(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w_re), static_cast<const float*>(w_im),
        static_cast<const float*>(filt), static_cast<float*>(out), lp, n_frames, n_fft, hop, n_freq, n_mels);
    return static_cast<int>(cudaGetLastError());
}
