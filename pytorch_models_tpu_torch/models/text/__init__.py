from .generator import DecoderGenerator
from .gpt2 import GPT2

__all__ = ["DecoderGenerator", "GPT2"]
