"""Fused log-mel frontend (PyTorch port of ``pytorch_models_tpu/ops/mel.py``).

Windowing + real DFT + |·|² + mel filterbank + log10 in one pass:
:func:`log_mel_spectrogram` launches the hand-written CUDA kernel
(``csrc/mel.cu``) on CUDA tensors and runs :func:`log_mel_spectrogram_plain`
on CPU tensors. The rFFT is two products with Hann-folded DFT bases, as in
the JAX kernel; the bases are built in float64 and cast to fp32 once. The
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
    return t.is_cuda if USE_MEL_KERNEL is None else USE_MEL_KERNEL


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


def log_mel_spectrogram_plain(x: torch.Tensor, n_fft: int = 400, hop_length: int = 160, n_mels: int = 80,
                              sample_rate: int = 16_000) -> torch.Tensor:
    """The kernel's math in plain PyTorch: (..., L) -> (..., n_mels, n_frames)
    log10 mel power, -inf where the mel power is 0."""
    w_re, w_im, filt = _device_constants(n_fft, n_mels, sample_rate, x.device)
    frames = frame_signal(x.float(), n_fft, hop_length)  # (..., F, n_fft) view
    re = torch.matmul(frames, w_re)
    im = torch.matmul(frames, w_im)
    mel = torch.matmul(re * re + im * im, filt)
    return (torch.log(mel.clamp_min(0.0)) * _INV_LN10).transpose(-1, -2)


def log_mel_spectrogram(x: torch.Tensor, n_fft: int = 400, hop_length: int = 160, n_mels: int = 80,
                        sample_rate: int = 16_000) -> torch.Tensor:
    """(..., L) fp32 waveform -> (..., n_mels, n_frames) log10 mel power
    spectrogram with torch.stft conventions (centered reflect pad, periodic
    Hann), through the CUDA kernel for a CUDA tensor."""
    if not x.is_cuda:
        return log_mel_spectrogram_plain(x, n_fft, hop_length, n_mels, sample_rate)
    req = _build.require
    req(x.dtype == torch.float32, f"log_mel_spectrogram: the waveform must be float32, got {x.dtype}")
    req(x.is_contiguous(), "log_mel_spectrogram: the waveform must be contiguous")
    req(x.ndim >= 1 and x.shape[-1] > n_fft // 2, "log_mel_spectrogram: the waveform is shorter than the reflect pad")
    *batch, length = x.shape
    xp = reflect_pad(x.reshape(-1, length), n_fft // 2)  # (B, L + n_fft), contiguous
    b, lp = xp.shape
    n_frames = (lp - n_fft) // hop_length + 1
    w_re, w_im, filt = _device_constants(n_fft, n_mels, sample_rate, x.device)
    out = torch.empty((b, n_mels, n_frames), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    code = lib.pmt_log_mel(xp.data_ptr(), w_re.data_ptr(), w_im.data_ptr(), filt.data_ptr(), out.data_ptr(),
                           b, lp, n_frames, n_fft, hop_length, w_re.shape[1], n_mels, _build.stream_ptr(x))
    _build.check("pmt_log_mel", code)
    log_mel_spectrogram.launches += 1
    return out.reshape(*batch, n_mels, n_frames)


log_mel_spectrogram.launches = 0
