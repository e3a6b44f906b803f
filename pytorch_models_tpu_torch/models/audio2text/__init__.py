from .continuous import WhisperContinuousBatchingGenerator
from .tokenizer import WhisperTokenizer
from .whisper import SpeculativeWhisperGenerator, Whisper, WhisperGenerator, WhisperPreprocessor

__all__ = ["SpeculativeWhisperGenerator", "Whisper", "WhisperContinuousBatchingGenerator", "WhisperGenerator",
           "WhisperPreprocessor", "WhisperTokenizer"]
