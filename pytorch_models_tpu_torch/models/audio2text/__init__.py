from .tokenizer import WhisperTokenizer
from .whisper import Whisper, WhisperGenerator, WhisperPreprocessor

__all__ = ["Whisper", "WhisperGenerator", "WhisperPreprocessor", "WhisperTokenizer"]
