"""Tensor-parallel CONTINUOUS BATCHING on ``torch.distributed`` (PyTorch
port of ``pytorch_models_tpu/parallel/cb_serving.py``).

The serving engines' pools (``models/text/continuous.py``,
``t5_continuous.py``, ``models/audio2text/continuous.py``) run head-sharded
over a ``("tp",)`` mesh: each rank holds its shard of the parameters, its
pool's KV caches are ``(L, B, Lmax, H*D/tp)`` width shards, and the engine's
admission, decode steps and host scheduler run unchanged on it through the
sharding hooks (``_params_cfg`` and the int8 gates). Every rank schedules
the same requests in the same order and returns every result. Decode runs
the per-op path: the fused step has no all-reduce inside, as in the JAX
package.

int8 pools: the int8 K/V shard on the width like the full-precision pool,
while the per-key fp32 scale planes are whole on every rank: each key's
scale is the full merged-head row's (``quantize_rows`` all-reduces the
absmax by max over the tp group, and the int8 decode kernel K6 takes the
current key's full-width scale as ``cur_ks``), so every rank holds the same
planes and writes the levels a single device writes. Per-request outputs
equal the single-device int8 pool's.
"""

from __future__ import annotations

from ..models.audio2text.continuous import WhisperContinuousBatchingGenerator
from ..models.text.continuous import ContinuousBatchingGenerator
from ..models.text.generator import PROMPT_BUCKET
from ..models.text.t5_continuous import T5ContinuousBatchingGenerator
from ..ops import attention as _attn
from .serving import _serving_axes, decoder_lm_serving_pspecs, local_config, t5_serving_pspecs
from .sharding import shard_params


def _int8_width_ok(lc) -> bool:
    """The JAX package serves a tensor-parallel int8 pool only where the
    rank's width (``width // tp``) is a multiple of 128: a Mosaic DMA
    alignment rule of its TPU kernel, which the card does not have. The port
    keeps the rule for parity, because it decides which numerics a pool
    gets (GPT-2-small at tp=4 gets a full-precision pool there)."""
    return (lc.n_heads * lc.head_dim) % 128 == 0


class TPContinuousBatchingGenerator(ContinuousBatchingGenerator):
    """Continuous batching with the decoder LM tp-sharded over a ``("tp",)``
    mesh."""

    def __init__(self, model, tokenizer, mesh, batch_size: int = 8, prompt_bucket: int = PROMPT_BUCKET,
                 check_every: int = 16) -> None:
        super().__init__(model, tokenizer, batch_size=batch_size, prompt_bucket=prompt_bucket,
                         check_every=check_every)
        n_heads = model.cfg.layer.n_heads
        _serving_axes(mesh, n_heads, {"tp"})
        self._mesh = mesh
        self._cfg_local = local_config(model.cfg, mesh, n_heads)
        self._sharded_params = shard_params(model.params, decoder_lm_serving_pspecs(model.params), mesh)

    def _params_cfg(self):
        return self._sharded_params, self._cfg_local

    def _use_int8_pool(self, cfg, b: int, fused: bool) -> bool:
        # the per-op int8 path (transformer._int8_self_decode_apply): width-sharded int8 caches, whole scale planes
        return _attn.use_int8_kv(b) and _int8_width_ok(cfg.layer)


class TPWhisperContinuousBatchingGenerator(WhisperContinuousBatchingGenerator):
    """Whisper continuous batching with the model tp-sharded over
    ``("tp",)``: admission's log-mel (K5) and conv stem run replicated, its
    encoder (K1) and cross-KV projection head-sharded; self and cross pools
    shard on the head width. Per segment, the output equals
    ``WhisperGenerator.transcribe_tokens``'."""

    def __init__(self, model, mesh, tokenizer=None, batch_size: int = 4, check_every: int = 16,
                 pool_ctx: int | None = None) -> None:
        from ..models.audio2text.whisper import DEC_MAX_LEN, WhisperPreprocessor

        super().__init__(model, tokenizer, batch_size=batch_size, check_every=check_every,
                         pool_ctx=pool_ctx if pool_ctx is not None else 2 * DEC_MAX_LEN)
        n_heads = model.cfg.dec_layer.n_heads
        _serving_axes(mesh, n_heads, {"tp"})
        self._mesh = mesh
        self._cfg_local = local_config(model.cfg, mesh, n_heads)
        self._sharded_params = shard_params(model.params, decoder_lm_serving_pspecs(model.params), mesh)
        self.preprocessor = WhisperPreprocessor("large-v3" if model.cfg.n_mels == 128 else "tiny", device=mesh.device)

    def _params_cfg(self):
        return self._sharded_params, self._cfg_local

    def _int8_modes(self, cfg, b: int, fused: bool) -> tuple[bool, bool]:
        """int8 self and cross pools on the per-op int8 path (width-sharded
        int8 caches, whole scale planes), where the rank's width allows."""
        if not _int8_width_ok(cfg.dec_layer):
            return False, False
        return _attn.use_int8_kv(b), _attn.use_int8_kv_cross(b)


class TPT5ContinuousBatchingGenerator(T5ContinuousBatchingGenerator):
    """T5 continuous batching with the model tp-sharded over ``("tp",)``:
    the pool's decode bias table holds the rank's heads' rows, the self and
    cross pools shard on the head width, and admission's encoder and
    cross-KV projection run head-sharded. Per request, the output equals
    ``T5Generator.generate_tokens``'."""

    def __init__(self, model, mesh, tokenizer=None, batch_size: int = 4, check_every: int = 16,
                 pool_ctx: int | None = None) -> None:
        super().__init__(model, tokenizer, batch_size=batch_size, check_every=check_every, pool_ctx=pool_ctx)
        _serving_axes(mesh, model.cfg.n_heads, {"tp"})
        self._mesh = mesh
        self._cfg_local = local_config(model.cfg, mesh, model.cfg.n_heads)
        self._sharded_params = shard_params(model.params, t5_serving_pspecs(model.params), mesh)

    def _params_cfg(self):
        return self._sharded_params, self._cfg_local

    def _int8_modes(self, params, cfg, b: int, l_max: int) -> tuple[bool, bool]:
        """int8 CROSS on the per-op int8 path, where the rank's width
        allows; the self pool stays full precision, as in the JAX package
        (its per-op int8 kernel takes no bias, and T5's self attention has
        the rel-pos bias)."""
        if not _int8_width_ok(cfg.layer):
            return False, False
        return False, _attn.use_int8_kv_cross(b)
