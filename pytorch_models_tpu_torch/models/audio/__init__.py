from .spectrogram import MelSpectrogram, Spectrogram, get_mel_filters

__all__ = ["MelSpectrogram", "Spectrogram", "get_mel_filters"]
