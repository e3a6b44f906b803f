"""Fused log-mel frontend (PyTorch port of ``pytorch_models_tpu/ops/mel.py``).

Windowing + real DFT + |·|² + mel filterbank + log10 in one pass:
:func:`log_mel_spectrogram` launches the hand-written CUDA kernel
(``csrc/mel.cu``: the DFT as 3xTF32 tensor-core products, the mel product
over each filter's band) on CUDA tensors and runs
:func:`log_mel_spectrogram_plain` on CPU tensors. The rFFT is two products
with Hann-folded DFT bases, as in the JAX kernel; the bases are built in
float64 and cast to fp32 once, and for the kernel interleaved (re, im) per
bin and split into TF32 hi and lo parts once (:func:`_kernel_constants`). The
JAX kernel's 128-lane and 8-row padding of the bases is a TPU layout rule
and is not carried over. Everything is fp32. The global dynamic-range clip
needs an all-frame max and stays outside (``WhisperPreprocessor``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..models.audio.spectrogram import frame_signal, get_mel_filters, hann_window, reflect_pad
from . import _build

# None = auto (the kernel for CUDA tensors); True forces the wrapper (on a
# CPU tensor it runs the plain version); False takes the rFFT route of the
# JAX package's XLA path (``WhisperPreprocessor``)
USE_MEL_KERNEL: bool | None = None

_INV_LN10 = 1.0 / math.log(10.0)


def use_mel_kernel(t: torch.Tensor) -> bool:
    return t.is_cuda and not _build.needs_grad(t) if USE_MEL_KERNEL is None else USE_MEL_KERNEL


@functools.lru_cache(maxsize=8)
def _dft_constants(n_fft: int, n_mels: int, sample_rate: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hann-windowed DFT bases ``w_re``, ``w_im`` (n_fft, n_freq) and the
    transposed mel filters (n_freq, n_mels), fp32 numpy."""
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    win = hann_window(n_fft).astype(np.float64)[:, None]
    w_re = (np.cos(ang) * win).astype(np.float32)
    w_im = (-np.sin(ang) * win).astype(np.float32)
    filters_t = np.ascontiguousarray(get_mel_filters(n_mels, n_fft, sample_rate).T)
    return w_re, w_im, filters_t


@functools.lru_cache(maxsize=8)
def _device_constants(n_fft: int, n_mels: int, sample_rate: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _dft_constants(n_fft, n_mels, sample_rate))


def _split_tf32(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """fp32 ``a`` as ``hi + lo``, both TF32 values (10 stored mantissa bits)
    rounded to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
    rounds; ``hi + lo`` is ``a`` to about 2^-22 of ``|a|``."""

    def rna(v: np.ndarray) -> np.ndarray:
        u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
        return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)

    hi = rna(a)
    return hi, rna(a.astype(np.float32) - hi)


def _mel_bands(filters_t: np.ndarray) -> np.ndarray:
    """(n_mels, 2) int32 ``[lo, hi)`` per filter of ``filters_t`` (n_freq,
    n_mels): the contiguous run of its nonzero weights (``[0, 0)`` for a
    filter without any)."""
    nz = filters_t != 0
    bands = np.zeros((filters_t.shape[1], 2), np.int32)
    for m in range(filters_t.shape[1]):
        (idx,) = np.nonzero(nz[:, m])
        if idx.size:
            bands[m] = idx[0], idx[-1] + 1
    return bands


def _interleaved_bases(n_fft: int, n_mels: int, sample_rate: int, pass_cols: int,
                       k_step: int) -> np.ndarray:
    """The DFT bases as the kernel reads them: (ncol, kp) fp32 with row
    ``2k`` = ``w_re[:, k]``, row ``2k + 1`` = ``w_im[:, k]`` (so an mma C
    fragment's column pair is (re, im) of one bin), zero past ``2 * n_freq``
    rows (``ncol`` a multiple of ``pass_cols``) and past ``n_fft`` samples
    (``kp`` a multiple of ``k_step``)."""
    w_re, w_im, _ = _dft_constants(n_fft, n_mels, sample_rate)
    n_freq = w_re.shape[1]
    ncol = -(-2 * n_freq // pass_cols) * pass_cols
    kp = -(-n_fft // k_step) * k_step
    bt = np.zeros((ncol, kp), np.float32)
    bt[0:2 * n_freq:2, :n_fft] = w_re.T
    bt[1:2 * n_freq:2, :n_fft] = w_im.T
    return bt


@functools.lru_cache(maxsize=8)
def _kernel_constants(n_fft: int, n_mels: int, sample_rate: int, device: torch.device):
    """The kernel's inputs besides the waveform, on ``device``: the
    interleaved bases split into TF32 hi and lo arrays (once, on the host)
    and laid out by the library as its ring's stage images
    (``pmt_log_mel_stage``), the (n_freq, n_mels) filters, their bands; and
    the bases' padded (ncol, kp)."""
    lib = _build.load_library()
    bt = _interleaved_bases(n_fft, n_mels, sample_rate, lib.pmt_log_mel_pass_cols(), lib.pmt_log_mel_k_step())
    parts = torch.from_numpy(np.stack(_split_tf32(bt))).to(device)
    tiles = torch.empty_like(parts)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        _build.check("pmt_log_mel_stage", lib.pmt_log_mel_stage(parts.data_ptr(), tiles.data_ptr(), *bt.shape,
                                                                 stream.cuda_stream))
        stream.synchronize()  # the cached images serve calls on any stream
    filt = _dft_constants(n_fft, n_mels, sample_rate)[2]
    filt_t, bands = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (filt, _mel_bands(filt)))
    return tiles, filt_t, bands, bt.shape


def _mel_banded(power: torch.Tensor, filt: torch.Tensor, bands: np.ndarray) -> torch.Tensor:
    """``power @ filt`` summed over each filter's band only: (..., n_freq) ->
    (..., n_mels); the skipped terms are exact zeros."""
    cols = [power[..., lo:hi] @ filt[lo:hi, m] for m, (lo, hi) in enumerate(bands.tolist())]
    return torch.stack(cols, dim=-1)


def log_mel_spectrogram_plain(x: torch.Tensor, n_fft: int = 400, hop_length: int = 160, n_mels: int = 80,
                              sample_rate: int = 16_000, banded: bool = False) -> torch.Tensor:
    """The kernel's math in plain PyTorch: (..., L) -> (..., n_mels, n_frames)
    log10 mel power, -inf where the mel power is 0. ``banded``: the mel
    product sums each filter over its band only, as the kernel does."""
    w_re, w_im, filt = _device_constants(n_fft, n_mels, sample_rate, x.device)
    frames = frame_signal(x.float(), n_fft, hop_length)  # (..., F, n_fft) view
    re = torch.matmul(frames, w_re)
    im = torch.matmul(frames, w_im)
    power = re * re + im * im
    if banded:
        mel = _mel_banded(power, filt, _mel_bands(_dft_constants(n_fft, n_mels, sample_rate)[2]))
    else:
        mel = torch.matmul(power, filt)
    return (torch.log(mel.clamp_min(0.0)) * _INV_LN10).transpose(-1, -2)


def log_mel_spectrogram(x: torch.Tensor, n_fft: int = 400, hop_length: int = 160, n_mels: int = 80,
                        sample_rate: int = 16_000) -> torch.Tensor:
    """(..., L) fp32 waveform -> (..., n_mels, n_frames) log10 mel power
    spectrogram with torch.stft conventions (centered reflect pad, periodic
    Hann), through the CUDA kernel for a CUDA tensor."""
    if not x.is_cuda:
        return log_mel_spectrogram_plain(x, n_fft, hop_length, n_mels, sample_rate)
    _build.require_no_grad("log_mel_spectrogram", x)
    req = _build.require
    req(x.dtype == torch.float32, f"log_mel_spectrogram: the waveform must be float32, got {x.dtype}")
    req(x.is_contiguous(), "log_mel_spectrogram: the waveform must be contiguous")
    req(x.ndim >= 1 and x.shape[-1] > n_fft // 2, "log_mel_spectrogram: the waveform is shorter than the reflect pad")
    *batch, length = x.shape
    xp = reflect_pad(x.reshape(-1, length), n_fft // 2)  # (B, L + n_fft), contiguous
    b, lp = xp.shape
    n_frames = (lp - n_fft) // hop_length + 1
    lib = _build.load_library()
    tiles, filt, bands, (ncol, kp) = _kernel_constants(n_fft, n_mels, sample_rate, x.device)
    out = torch.empty((b, n_mels, n_frames), dtype=torch.float32, device=x.device)
    code = lib.pmt_log_mel(xp.data_ptr(), tiles.data_ptr(), filt.data_ptr(), bands.data_ptr(), out.data_ptr(), b,
                           lp, n_frames, n_fft, hop_length, filt.shape[0], n_mels, ncol, kp, _build.stream_ptr(x))
    _build.check("pmt_log_mel", code)
    log_mel_spectrogram.launches += 1
    return out.reshape(*batch, n_mels, n_frames)


log_mel_spectrogram.launches = 0
