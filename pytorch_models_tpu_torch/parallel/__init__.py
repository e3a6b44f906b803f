"""Parallel serving and training on ``torch.distributed`` (PyTorch port of
``pytorch_models_tpu/parallel/``): one process per rank over a named mesh
of ranks (:func:`make_mesh`). Tensor- and data-parallel serving (Megatron
head sharding over "tp", batch rows over "dp"), pipeline-parallel serving
(stages over "pp", alone or with "tp" and "dp"), expert-parallel MoE
serving ("ep"), and the dp/pp/tp/sp/ep MoE training step with its GPipe
schedule (``train.make_train_step``, ``pipeline.gpipe_apply``)."""

from .cb_serving import TPContinuousBatchingGenerator
from .mesh import make_mesh
from .pp_serving import PPDecoderGenerator
from .serving import TPDecoderGenerator, TPT5Generator, TPWhisperGenerator
from .sharding import shard_decoder_lm_params
from .spec_serving import TPSpeculativeGenerator
from .tp_pp_serving import TPPPDecoderGenerator

__all__ = ["make_mesh", "shard_decoder_lm_params", "PPDecoderGenerator", "TPPPDecoderGenerator",
           "TPContinuousBatchingGenerator", "TPDecoderGenerator", "TPSpeculativeGenerator", "TPT5Generator",
           "TPWhisperGenerator"]
