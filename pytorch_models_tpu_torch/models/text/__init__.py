from .generator import DecoderGenerator
from .gpt2 import GPT2
from .t5 import T5Generator, T5Model
from .tokenizer import GPT2Tokenizer

__all__ = ["DecoderGenerator", "GPT2", "GPT2Tokenizer", "T5Generator", "T5Model"]
