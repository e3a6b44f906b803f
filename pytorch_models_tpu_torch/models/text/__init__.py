from .generator import DecoderGenerator
from .gpt2 import GPT2
from .t5 import T5Generator, T5Model

__all__ = ["DecoderGenerator", "GPT2", "T5Generator", "T5Model"]
