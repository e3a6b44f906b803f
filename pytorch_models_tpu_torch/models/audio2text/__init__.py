from .continuous import WhisperContinuousBatchingGenerator
from .tokenizer import WhisperTokenizer
from .whisper import Whisper, WhisperGenerator, WhisperPreprocessor

__all__ = ["Whisper", "WhisperContinuousBatchingGenerator", "WhisperGenerator", "WhisperPreprocessor",
           "WhisperTokenizer"]
