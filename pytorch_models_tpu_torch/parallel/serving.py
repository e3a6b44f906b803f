"""Tensor- and data-parallel SERVING on ``torch.distributed`` (PyTorch port
of ``pytorch_models_tpu/parallel/serving.py``).

A decoder LM (GPT-2), T5 or Whisper generates over a ``("dp", "tp")`` mesh
(:func:`..parallel.make_mesh`), one process per rank:

- dp: the batch's rows split over the dp groups, embarrassingly parallel;
  every rank is given the whole request list and returns the whole result
  list, the rows gathered over dp at the end (the counterpart of the JAX
  package's row-sharded ``out_specs``);
- tp: Megatron head sharding. Each rank holds ``n_heads / tp`` heads: its
  q/k/v columns, its merged-head KV-cache shard ``(B/dp, L, H*D/tp)`` and
  its slice of the MLP's hidden dim. The attention out-projection and the
  MLP's last matrix are row shards with ONE all-reduce each per layer
  (``transformer.reduce_linear``).

The per-rank code IS the single-device generator body (``_generate_batch``
of ``models/text/generator.py``, ``t5.py``, ``whisper.py``) run on the
rank's shard: tensor parallelism enters only through the config's local
head count and its ``tp_axis`` (the tp process group). So every kernel runs
on each rank at its local heads: the encoder attention K1, the decode
attention K2, the embedding K3, the greedy head K4 (replicated) and the
log-mel K5 (replicated). The fused decode step K7 is never a
tensor-parallel path (it has no all-reduce inside), as in the JAX package.
Greedy tokens equal the single-device generator's: the ranks' partial sums
are an exact refactoring of the products, up to summation order.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..models.text.generator import PROMPT_BUCKET, _eos_id, _generate_batch
from ..models.text.t5 import ENC_BUCKET, _t5_generate_batch
from .sharding import shard_params, tree_map_with_path


def decoder_lm_serving_pspecs(params) -> dict:
    """Specs of a decoder-LM (or Whisper) parameter tree under serving TP:
    column-parallel kernels AND their biases (q/k/v, fc1) split on the
    output dim, so each rank's local add is whole; row-parallel kernels
    (o, fc2) split on the input dim, their biases replicated and added after
    the all-reduce."""
    col = ("['q']", "['k']", "['v']", "['fc1']")
    row = ("['o']", "['fc2']")

    def spec(path, leaf):
        if any(k in path for k in col):
            return (None,) * (leaf.ndim - 1) + ("tp",)
        if any(k in path for k in row) and path.endswith("['w']"):
            return (None,) * (leaf.ndim - 2) + ("tp", None)
        return ()

    return tree_map_with_path(spec, params)


def t5_serving_pspecs(params) -> dict:
    """Specs of a T5 parameter tree under serving TP: head sharding extends
    to each stack's rel-pos table (H, n_buckets), so a rank builds only its
    heads' bias rows; the GEGLU ``mlp.w`` / ``mlp.v`` are column-parallel
    and ``mlp.wo`` row-parallel."""
    col = ("['q']", "['k']", "['v']", "['mlp']['w']")
    row = ("['o']", "['wo']")

    def spec(path, leaf):
        if path.endswith("['attn_bias']"):
            return ("tp", None)
        if any(k in path for k in col) and path.endswith("['w']") and not path.endswith("['wo']['w']"):
            return (None,) * (leaf.ndim - 1) + ("tp",)
        if any(k in path for k in row) and path.endswith("['w']"):
            return (None,) * (leaf.ndim - 2) + ("tp", None)
        return ()

    return tree_map_with_path(spec, params)


def left_pad_prompts(token_lists: list[list[int]], max_seq_len: int, max_tokens: int, bucket: int = PROMPT_BUCKET):
    """The prompts LEFT-padded to a ``bucket`` multiple, as the decoder
    generators pack them: ``(buf (B, P) int64, pad_lens (B,) int32, limit)``
    with ``limit`` the cache slot where generation stops; None when nothing
    is generated (``max_tokens <= 0`` or the bucket fills the context)."""
    if max_tokens <= 0:
        return None
    max_n = max(len(ts) for ts in token_lists)
    pad = min(-(-max_n // bucket) * bucket, max_seq_len)
    if max_n > pad:
        raise ValueError(f"prompt too long for context {max_seq_len}")
    if pad >= max_seq_len:
        return None
    buf = np.zeros((len(token_lists), pad), np.int64)
    pad_lens = np.zeros((len(token_lists),), np.int32)
    for i, ts in enumerate(token_lists):  # LEFT-pad: right-align each row
        pad_lens[i] = pad - len(ts)
        buf[i, pad_lens[i]:] = ts
    return buf, pad_lens, min(pad + max_tokens, max_seq_len)


def greedy_generate(forward, prompt_buf: torch.Tensor, pad_lens: torch.Tensor, limit: int, eos_id: int,
                    max_seq_len: int, all_done):
    """Greedy batched generation over LEFT-padded prompts (the loop of
    ``generator._generate_batch``) for the stage- and expert-parallel
    generators: ``forward(tokens (b, S), pos_ids (b, S), pos) -> logits
    (b, S, V)`` runs the model at cache slots [pos, pos+S), writing its
    caches in place; ``all_done(done, step)`` says before decode step
    ``step`` whether every row is finished (finished rows stay parked on
    EOS). Returns ``(tokens (b, max_seq_len), lengths (b,))`` on the host."""
    b, p_len = prompt_buf.shape
    dev = prompt_buf.device
    pos_ids = (torch.arange(p_len, device=dev)[None, :] - pad_lens[:, None].long()).clamp_min(0)
    nxt = torch.argmax(forward(prompt_buf, pos_ids, 0)[:, -1], dim=-1)
    buf = torch.zeros((b, max_seq_len), dtype=torch.int64, device=dev)
    buf[:, :p_len] = prompt_buf
    buf[:, p_len] = nxt
    done = nxt == eos_id
    eos = torch.full_like(nxt, eos_id)
    pos = p_len + 1
    while pos < limit and not all_done(done, pos - p_len - 1):
        p_ids = (pos - 1 - pad_lens.long())[:, None]
        nxt = torch.where(done, eos, torch.argmax(forward(buf[:, pos - 1:pos], p_ids, pos - 1)[:, 0], dim=-1))
        buf[:, pos] = nxt
        done = done | (nxt == eos_id)
        pos += 1
    out = buf.cpu().numpy()
    is_eos = out[:, p_len:pos] == eos_id
    return out, np.where(is_eos.any(axis=1), p_len + is_eos.argmax(axis=1) + 1, pos)


def unpack_rows(out: np.ndarray, lengths: np.ndarray, pad_lens: np.ndarray) -> list[list[int]]:
    """Each row's prompt and generated tokens, its left padding dropped."""
    return [out[i, pad_lens[i]: lengths[i]].tolist() for i in range(out.shape[0])]


def _serving_axes(mesh, n_heads: int, axes: set) -> int:
    """The mesh's tp size, once its axes and the head count are checked."""
    if set(mesh.shape) != axes:
        raise ValueError(f"serving mesh needs {tuple(sorted(axes))} axes, got {tuple(mesh.shape)}")
    tp = mesh.shape["tp"]
    if n_heads % tp:
        raise ValueError(f"{n_heads} heads not divisible by tp={tp}")
    return tp


def local_config(cfg, mesh, n_heads: int):
    """``cfg`` for this rank: ``n_heads / tp`` local heads and the tp
    process group (None at tp=1) as ``tp_axis``."""
    return replace(cfg, local_heads=n_heads // mesh.shape["tp"], tp_axis=mesh.group("tp"))


def _dp_rows(mesh, b: int) -> slice:
    """This rank's dp shard of ``b`` rows."""
    dp = mesh.shape.get("dp", 1)
    if b % dp:
        raise ValueError(f"batch {b} must be divisible by dp={dp}")
    n = b // dp
    return slice(mesh.index("dp") * n, (mesh.index("dp") + 1) * n) if dp > 1 else slice(0, b)


def _gather_rows(mesh, out: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Every dp shard's ``(out, lengths)`` rows, in row order, on every rank."""
    if mesh.size("dp") == 1:
        return out, lengths
    got = [mesh.all_gather(torch.from_numpy(np.ascontiguousarray(a)), "dp").numpy() for a in (out, lengths)]
    return got[0], got[1]


def _dp_seed(seed: int, mesh) -> int:
    """The sampler's seed on this rank: ``seed`` folded with the dp index
    (the JAX package's ``fold_in(key, axis_index("dp"))``), so dp shards
    draw independent streams while every tp rank of a shard draws the same
    one (they see the same all-reduced logits)."""
    if mesh.shape.get("dp", 1) == 1:
        return seed
    return int(np.random.SeedSequence((seed, mesh.index("dp"))).generate_state(1)[0])


class TPDecoderGenerator:
    """Sharded drop-in for ``DecoderGenerator.generate_tokens_batch`` over a
    ``("dp", "tp")`` mesh: "tp" divides the model's head count, "dp" splits
    the batch's rows. The rank's parameter shard is cut once at
    construction; greedy output equals the single-device generator's."""

    def __init__(self, model, tokenizer, mesh) -> None:
        self.model = model
        self.tokenizer = tokenizer
        self.mesh = mesh
        n_heads = model.cfg.layer.n_heads
        _serving_axes(mesh, n_heads, {"dp", "tp"})
        self.dp = mesh.shape["dp"]
        self.cfg_local = local_config(model.cfg, mesh, n_heads)
        self.params = shard_params(model.params, decoder_lm_serving_pspecs(model.params), mesh)

    def generate_batch(self, prompts: list[str], max_tokens: int = 100, topk: int = 1, seed: int = 0) -> list[str]:
        token_lists = [self.tokenizer.encode(p) for p in prompts]
        outs = self.generate_tokens_batch(token_lists, max_tokens=max_tokens, topk=topk, seed=seed)
        return [self.tokenizer.decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100, topk: int = 1,
                              seed: int = 0) -> list[list[int]]:
        """Every rank takes the whole list and returns every row's prompt +
        generated tokens; the rank decodes its dp shard of the rows (greedy,
        or top-k sampled from ``(seed, dp index)``)."""
        cfg = self.model.cfg
        rows = _dp_rows(self.mesh, len(token_lists))
        packed = left_pad_prompts(token_lists, cfg.max_seq_len, max_tokens)
        if packed is None:
            return [list(ts) for ts in token_lists]
        buf, pad_lens, limit = packed
        dev = self.mesh.device
        out, lengths = _generate_batch(self.params, self.cfg_local, torch.from_numpy(buf[rows]).to(dev),
                                       torch.from_numpy(pad_lens[rows]).to(dev), limit, _eos_id(self.tokenizer),
                                       topk=topk, seed=_dp_seed(seed, self.mesh))
        out, lengths = _gather_rows(self.mesh, out, lengths)
        return unpack_rows(out, lengths, pad_lens)


class TPT5Generator:
    """Tensor- and data-parallel T5 batched generation (mirrors
    ``T5Generator.generate_tokens_batch``): encode, cross-KV projection and
    the decode loop run per rank, the rows split over dp, the heads (and the
    rel-pos tables) over tp. Greedy output equals ``T5Generator``'s."""

    def __init__(self, model, tokenizer, mesh) -> None:
        self.model = model
        self.tokenizer = tokenizer
        self.mesh = mesh
        _serving_axes(mesh, model.cfg.n_heads, {"dp", "tp"})
        self.dp = mesh.shape["dp"]
        self.cfg_local = local_config(model.cfg, mesh, model.cfg.n_heads)
        self.params = shard_params(model.params, t5_serving_pspecs(model.params), mesh)

    def generate_batch(self, prompts: list[str], max_tokens: int = 100) -> list[str]:
        token_lists = [self.tokenizer.Encode(p, add_eos=True) for p in prompts]
        outs = self.generate_tokens_batch(token_lists, max_tokens, self.tokenizer.pad_id(), self.tokenizer.eos_id())
        return [self.tokenizer.Decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int, pad_id: int,
                              eos_id: int) -> list[list[int]]:
        b = len(token_lists)
        rows = _dp_rows(self.mesh, b)
        pad = -(-max(len(ts) for ts in token_lists) // ENC_BUCKET) * ENC_BUCKET
        buf = np.zeros((b, pad), np.int64)
        n_enc = np.zeros((b,), np.int64)
        for i, ts in enumerate(token_lists):
            buf[i, : len(ts)] = ts
            n_enc[i] = len(ts)
        dev = self.mesh.device
        out, lengths = _t5_generate_batch(self.params, self.cfg_local, torch.from_numpy(buf[rows]).to(dev),
                                          torch.from_numpy(n_enc[rows]).to(dev), max_tokens, pad_id, eos_id)
        out, lengths = _gather_rows(self.mesh, out, lengths)
        return [out[i, : lengths[i]].tolist() for i in range(b)]


class TPWhisperGenerator:
    """Tensor- and data-parallel Whisper batched transcription: per rank the
    log-mel frontend (K5) and the conv stem run replicated on its dp shard
    of the segments, the encoder (K1 at the local heads), the cross-KV
    projection and the greedy decode run head-sharded (the decoder-LM
    column / row rules apply unchanged). Greedy output equals
    ``WhisperGenerator.transcribe_tokens_batch``'s."""

    N_SAMPLES = 30 * 16_000

    def __init__(self, model, mesh, tokenizer=None) -> None:
        from ..models.audio2text.whisper import DEC_MAX_LEN, WhisperPreprocessor

        self.model = model
        self.tokenizer = tokenizer
        self.mesh = mesh
        self._dec_max_len = DEC_MAX_LEN
        n_heads = model.cfg.dec_layer.n_heads
        _serving_axes(mesh, n_heads, {"dp", "tp"})
        self.dp = mesh.shape["dp"]
        self.cfg_local = local_config(model.cfg, mesh, n_heads)
        self.params = shard_params(model.params, decoder_lm_serving_pspecs(model.params), mesh)
        self.preprocessor = WhisperPreprocessor("large-v3" if model.cfg.n_mels == 128 else "tiny", device=mesh.device)

    @torch.inference_mode()
    def transcribe_tokens_batch(self, audios, initial_tokens: list[int], eot_id: int,
                                max_tokens: int = 448) -> list[list[int]]:
        from ..models.audio2text.whisper import _generate_batch as _whisper_generate_batch
        from ..models.audio2text.whisper import stage_segments, whisper_encode

        if max_tokens > self._dec_max_len:
            raise ValueError(f"max_tokens={max_tokens} exceeds the decoder position table ({self._dec_max_len})")
        if not 0 < len(initial_tokens) <= max_tokens:
            raise ValueError(f"transcription needs 1 to max_tokens={max_tokens} initial tokens")
        dev = self.mesh.device
        b = len(audios)
        rows = _dp_rows(self.mesh, b)
        wav = stage_segments(list(audios)[rows], self.N_SAMPLES, dev)
        memory = whisper_encode(self.params, self.cfg_local, self.preprocessor(wav))
        init = torch.tensor(initial_tokens, dtype=torch.int64, device=dev)
        out, lengths = _whisper_generate_batch(self.params, self.cfg_local, memory, init, max_tokens, eot_id)
        out, lengths = _gather_rows(self.mesh, out, lengths)
        return [out[i, : lengths[i]].tolist() for i in range(b)]
