"""Spectrogram / MelSpectrogram (PyTorch port of
``pytorch_models_tpu/models/audio/spectrogram.py``).

``torch.stft``-compatible power spectrogram: centered reflect padding,
periodic Hann window, rFFT. ``get_mel_filters`` is librosa's Slaney-scale
mel filterbank. The window and the filterbank stay numpy, built in float64
and cast once, exactly as in the JAX package, so both packages hold the same
constants. Framing is a strided view (``Tensor.unfold``): no gather, no copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.module import resolve_device


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window, matching ``torch.hann_window`` defaults."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis of ``(..., L)`` by ``pad`` on both sides."""
    *batch, length = x.shape
    return F.pad(x.reshape(-1, 1, length), (pad, pad), mode="reflect").reshape(*batch, length + 2 * pad)


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Centered overlapping frames: (..., L) -> (..., n_frames, n_fft), a
    strided view of the reflect-padded signal."""
    return reflect_pad(x, n_fft // 2).unfold(-1, n_fft, hop_length)


def power_spectrogram(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """|STFT|² with a Hann window: (..., L) -> (..., n_fft//2+1, n_frames)."""
    window = torch.from_numpy(hann_window(n_fft)).to(x.device)
    frames = frame_signal(x.float(), n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real.square() + spec.imag.square()
    return power.transpose(-1, -2)


def get_mel_filters(n_mels: int, n_fft: int, sample_rate: float) -> np.ndarray:
    """Slaney-scale mel filterbank (n_mels, n_fft//2 + 1)."""
    f_max = sample_rate / 2
    mel_max = f_max * 3 / 200 if f_max < 1000 else 15 + 27 * math.log(f_max / 1000, 6.4)

    mel_freqs = np.linspace(0, mel_max, n_mels + 2, dtype=np.float64)
    mel_freqs = np.where(mel_freqs < 15, mel_freqs * 200 / 3, 1000 * 6.4 ** ((mel_freqs - 15) / 27))
    fft_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1, dtype=np.float64)

    mel_diff = np.diff(mel_freqs)  # (n_mels + 1)
    ramp = mel_freqs[:, None] - fft_freqs[None, :]  # (n_mels + 2, n_fft//2 + 1)

    lower = -ramp[:-2] / mel_diff[:-1, None]
    upper = ramp[2:] / mel_diff[1:, None]
    filters = np.clip(np.minimum(lower, upper), 0, None)

    filters *= 2 / (mel_freqs[2:, None] - mel_freqs[:-2, None])
    return filters.astype(np.float32)


class Spectrogram:
    """``|STFT|^2`` of a waveform. A tensor stays on its device; an array or
    list goes to ``device`` (None: the CUDA card, as the models' default;
    ``"cpu"`` for the plain path here)."""

    def __init__(self, n_fft: int, hop_length: int, device=None) -> None:
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.device = device

    def _waveform(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(self.device))

    def __call__(self, x) -> torch.Tensor:
        return power_spectrogram(self._waveform(x), self.n_fft, self.hop_length)


class MelSpectrogram(Spectrogram):
    def __init__(self, n_fft: int, hop_length: int, n_mels: int, sample_rate: int, device=None) -> None:
        super().__init__(n_fft, hop_length, device)
        self.filters = torch.from_numpy(get_mel_filters(n_mels, n_fft, sample_rate))

    def __call__(self, x) -> torch.Tensor:
        spec = super().__call__(x)
        return torch.matmul(self.filters.to(spec.device, spec.dtype), spec)
