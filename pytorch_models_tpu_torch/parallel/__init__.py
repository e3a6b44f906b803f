"""Tensor- and data-parallel serving on ``torch.distributed`` (PyTorch port
of ``pytorch_models_tpu/parallel/``): one process per rank over a named
mesh of ranks (:func:`make_mesh`), Megatron head sharding over "tp", batch
rows over "dp". Not ported yet: the pipeline-parallel generators
(``PPDecoderGenerator``, ``TPPPDecoderGenerator``), expert-parallel serving
and training."""

from .cb_serving import TPContinuousBatchingGenerator
from .mesh import make_mesh
from .serving import TPDecoderGenerator, TPT5Generator, TPWhisperGenerator
from .sharding import shard_decoder_lm_params
from .spec_serving import TPSpeculativeGenerator

__all__ = ["make_mesh", "shard_decoder_lm_params", "TPContinuousBatchingGenerator", "TPDecoderGenerator",
           "TPSpeculativeGenerator", "TPT5Generator", "TPWhisperGenerator"]
