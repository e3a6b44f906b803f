from .bert import BERT
from .continuous import ContinuousBatchingGenerator
from .generator import DecoderGenerator
from .gpt import GPT
from .gpt2 import GPT2
from .speculative import SpeculativeDecoderGenerator
from .t5 import SpeculativeT5Generator, T5Generator, T5Model
from .t5_continuous import T5ContinuousBatchingGenerator
from .tokenizer import GPT2Tokenizer

__all__ = ["BERT", "ContinuousBatchingGenerator", "DecoderGenerator", "GPT", "GPT2", "GPT2Tokenizer",
           "SpeculativeDecoderGenerator", "SpeculativeT5Generator", "T5ContinuousBatchingGenerator", "T5Generator",
           "T5Model"]
