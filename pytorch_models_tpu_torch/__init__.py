"""pytorch_models_tpu_torch — the PyTorch + CUDA port of pytorch_models_tpu.

It grows beside the JAX package, which stays as the reference it is tested
against, one slice at a time. Parameters keep the JAX package's layouts
(``(in, out)`` linears, merged-head ``(B, L, H*D)`` projections and KV
caches), plain tensor code is PyTorch, and every Pallas kernel on a ported
path becomes a hand-written CUDA kernel for Hopper (``csrc/``), built at
first use with ``nvcc`` and bound with ``ctypes``. Each kernel keeps a plain
PyTorch version beside it; its wrapper runs that version only for CPU
tensors.

Ported so far: GPT-2 (``models.text.GPT2``) with greedy and sampled
(top-k / top-p / temperature) generation, shared-prefill samples, beam
search and scoring (``models.text.DecoderGenerator``) and its tokenizer
(``GPT2Tokenizer``); Whisper (``models.audio2text.Whisper``) with its
log-mel frontend (``WhisperPreprocessor``), greedy single, batched and
long-form transcription and beam search (``WhisperGenerator``) and its
tokenizer (``WhisperTokenizer``); T5 (``models.text.T5Model``) with greedy
and beam generation and teacher-forced scoring (``T5Generator``); GPT-1
(``models.text.GPT``, decoded per-op through the same generator) and the
BERT / RoBERTa encoder (``models.text.BERT``); the image models: ViT
(AugReg / SigLIP / DeiT-3 / DINO loaders), MLP-Mixer, ConvNeXt, MaxViT,
MobileViT and DETR with ``DETRPipeline`` (``models.image``), each with its
checkpoint converter; the audio models: wav2vec2 / HuBERT, SEW,
data2vec-audio and the EnCodec codec (``models.audio``). BERT's, ViT's,
DETR's and the wav2vec2 family's attention runs through the
encoder-attention kernel. With ``model.quantize_int8()`` and
``ops.layers.USE_A8_LINEAR`` the linears run w8a8. The decode
loops run each step as ONE fused kernel (``ops/decode_step.py``; headless
when sampling or in beam search) where it serves the model and batch. The models and frontends run on the CUDA card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
