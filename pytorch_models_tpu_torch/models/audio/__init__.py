from .data2vec_audio import Data2VecAudio
from .encodec import EnCodec
from .sew import SEW
from .spectrogram import MelSpectrogram, Spectrogram, get_mel_filters
from .wav2vec2 import Wav2Vec2

__all__ = ["Data2VecAudio", "EnCodec", "MelSpectrogram", "SEW", "Spectrogram", "Wav2Vec2", "get_mel_filters"]
