#!/usr/bin/env python3
"""Time kernels of two source trees in one process, on one card.

    python3 kernel_ab.py BASE_DIR              # K2 and K6; BASE_DIR: a checkout of another commit (git archive)
    python3 kernel_ab.py --k7 BASE_DIR         # K7, the fused decode step
    python3 kernel_ab.py --head-mel BASE_DIR   # K4 (the greedy head, tied and untied) and K5 (log-mel)

Builds the mode's sources of this checkout and of ``BASE_DIR`` (one ``nvcc``
per source, ``sm_90a``), each tree into a shared library of its own, and
times every kernel at ``chip_smoke.py``'s shapes through this checkout's
wrappers with either library loaded, in turns base, new, new, base (device
time per call, ``chip_smoke._time_ms``):

- default: ``csrc/decode_attention.cu`` and ``csrc/int8_kv.cu`` (K2, K6) at
  the bf16 shapes; both trees must share the C signatures of
  ``pmt_decode_attention`` and ``pmt_int8_attention``;
- ``--k7``: ``csrc/decode_step.cu`` (with the ``int8_attn.cuh`` of its own
  tree) at every K7 variant of ``chip_smoke.py`` (GPT-2, Whisper and T5 at
  B=8, and the int8 serving variants of ``I8_VARIANTS``), bf16 and fp32.
  The base tree's ``Args`` must be a prefix of this tree's ``_Args``
  (fields are only ever appended), so its library reads the same call; a
  tree whose wrapper has no ``_unit_major`` is given the packed weights as
  they are (row-major), as its own wrapper would.
  Then ``chip_smoke.decode_step_breakdown`` with each tree's library whose
  kernel takes ``stamps``;
- ``--head-mel``: ``csrc/greedy_head.cu`` and ``csrc/mel.cu`` at
  ``chip_smoke.py``'s shapes: the tied head at GPT-2's (V 50257, d 768, B=8
  to 200) and Whisper's (V 51865, d 512, B=8), the untied head at T5-base's
  (V 32128, d 768, B=8 to 200), bf16 and fp32, each beside the head matmul
  + argmax it replaces (timed in the same turns: base, new, matmul, matmul,
  new, base; where the two cross is where ``ops.attention.use_greedy_head``
  takes the matmul), and the log-mel frontend at B=8 x 30 s (80 mels). A
  tree with the two-pass head (``pmt_greedy_argmax_tied`` / ``_untied`` with partials scratch) or the
  CUDA-core log-mel kernel (``pmt_log_mel`` on the unsplit bases) is called
  through its own C interface (``_LEGACY``), as its wrappers called it.

Prints one line per shape, the card, and a JSON line of the times in µs.
Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke

# mode: (sources, C entry points, timed calls per turn)
MODES = {"attn": (("decode_attention.cu", "int8_kv.cu"), ("pmt_decode_attention", "pmt_int8_attention"), 50),
         "k7": (("decode_step.cu",), ("pmt_decode_step_workspace", "pmt_decode_step"), 20),
         "head-mel": (("greedy_head.cu", "mel.cu"), (), 30)}

# the C interfaces of the two-pass greedy head and the CUDA-core log-mel kernel
_P, _I = ctypes.c_void_p, ctypes.c_int
_LEGACY = {"pmt_greedy_argmax_tied": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], "pmt_greedy_chunk_rows": [],
           "pmt_greedy_argmax_untied": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], "pmt_greedy_untied_cols": [_I],
           "pmt_log_mel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]}
_CURRENT = ("pmt_greedy_argmax", "pmt_greedy_split", "pmt_log_mel", "pmt_log_mel_pass_cols",
            "pmt_log_mel_k_step", "pmt_log_mel_stage")


def build_lib(csrc: Path, out_dir: Path, sources, entries):
    from pytorch_models_tpu_torch.ops import _build as b

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = b._find_nvcc()
    objs, procs = [], []
    for name in sources:
        obj = out_dir / (Path(name).stem + ".o")
        procs.append(subprocess.Popen([nvcc, *b.NVCC_FLAGS, "-c", "-o", str(obj), str(csrc / name)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        objs.append(str(obj))
    for name, p in zip(sources, procs):
        text, _ = p.communicate()
        (out_dir / (Path(name).stem + ".log")).write_text(text)  # nvcc's output, ptxas registers and spills
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed in {csrc}:\n{text[-4000:]}")
    lib_path = out_dir / "libab.so"
    subprocess.run([nvcc, *b.NVCC_FLAGS[:2], "-shared", "-o", str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = b._SIGNATURES[name], ctypes.c_int
    return lib


def _cases(dev):
    """(name, [call per input copy]) at chip_smoke.py's bf16 shapes."""
    import torch

    from pytorch_models_tpu_torch.ops.decode_attention import decode_attention
    from pytorch_models_tpu_torch.ops.int8_kv import int8_decode_attention, quantize_kv_caches

    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    ends, pads = i32([1024, 700, 5, 64, 1, 300, 1000, 512]), i32([0, 10, 5, 0, 0, 299, 3, 100])
    e32 = torch.randint(1, 1025, (32,), generator=g, device=dev, dtype=torch.int32)
    p32 = (torch.rand(32, generator=g, device=dev) * e32).to(torch.int32)
    out = []
    cp = [(rnd(8, 1, 768), rnd(8, 1024, 768), rnd(8, 1024, 768)) for _ in range(4)]
    out.append(("K2 GPT-2 B=8 L=1024", [lambda c=c: decode_attention(*c, ends, 12, pads) for c in cp]))
    cp = [(rnd(8, 1, 512), rnd(8, 1536, 512), rnd(8, 1536, 512)) for _ in range(4)]
    lens = i32([1500] * 8)
    out.append(("K2 Whisper cross B=8 L=1536", [lambda c=c: decode_attention(*c, lens, 8) for c in cp]))
    cp = [(rnd(32, 1, 768), rnd(32, 1024, 768), rnd(32, 1024, 768)) for _ in range(2)]
    out.append(("K2 B=32 L=1024", [lambda c=c: decode_attention(*c, e32, 12, p32) for c in cp]))
    for L, end in ((128, 41), (1024, 1000)):
        cp = [(rnd(8, 1, 768), rnd(8, L, 768), rnd(8, L, 768)) for _ in range(4)]
        bias = 2.0 * rnd(1, L, 12, dtype=torch.float32)
        out.append((f"K2-bias T5 L={L} end={end}",
                    [lambda c=c, b=bias, e=end: decode_attention(*c, e, 12, None, b) for c in cp]))

    def caches(b, lk, hd):
        q = quantize_kv_caches({"k": rnd(b, lk, hd, dtype=torch.float32), "v": rnd(b, lk, hd, dtype=torch.float32)})
        return q["k"], q["v"], q["ks"], q["vs"]

    cp = [(rnd(8, 1, 768), caches(8, 1024, 768)) for _ in range(4)]
    out.append(("K6 GPT-2 B=8 Lk=1024", [lambda c=c: int8_decode_attention(c[0], *c[1], ends, 12, pads) for c in cp]))
    xl = i32([1500, 1500, 7, 1500, 1200, 0, 300, 1500])
    cp = [(rnd(8, 1, 512), caches(8, 1536, 512)) for _ in range(4)]
    out.append(("K6 Whisper cross B=8 Lk=1536", [lambda c=c: int8_decode_attention(c[0], *c[1], xl, 8) for c in cp]))
    for lk, pos in ((128, 41), (1024, 1000)):
        cp = [(rnd(8, 1, 768), caches(8, lk, 768), rnd(8, 768), rnd(8, 768)) for _ in range(4)]
        sb = 2.0 * rnd(lk, 12, dtype=torch.float32)
        out.append((f"K6 T5 Lk={lk} pos={pos} + current + bias",
                    [lambda c=c, p=pos, s=sb: int8_decode_attention(c[0], *c[1], p, 12, None, c[2], c[3], s)
                     for c in cp]))
    return out


def _bind_head_mel(lib) -> bool:
    """Set the C signatures of a head-mel library; True for this tree's
    interface, False for the legacy one (``_LEGACY``)."""
    from pytorch_models_tpu_torch.ops import _build as b

    current = hasattr(lib, "pmt_greedy_argmax")
    for name, argtypes in ({n: b._SIGNATURES[n] for n in _CURRENT} if current else _LEGACY).items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return current


def _legacy_head(lib, x, w, tied: bool):
    """One call of the two-pass head through its own C interface."""
    import torch

    from pytorch_models_tpu_torch.ops import _build as b

    (bs, d), v, code = x.shape, (w.shape[0] if tied else w.shape[1]), b.dtype_code(x)
    n_chunks = -(-v // (lib.pmt_greedy_chunk_rows() if tied else lib.pmt_greedy_untied_cols(code)))
    pv = torch.empty((bs, n_chunks), dtype=torch.float32, device=x.device)
    pi = torch.empty((bs, n_chunks), dtype=torch.int32, device=x.device)
    out = torch.empty((bs,), dtype=torch.int64, device=x.device)
    fn = lib.pmt_greedy_argmax_tied if tied else lib.pmt_greedy_argmax_untied
    b.check("legacy greedy head", fn(x.data_ptr(), w.data_ptr(), pv.data_ptr(), pi.data_ptr(), out.data_ptr(), bs, v,
                                     d, n_chunks, code, b.stream_ptr(x)))
    return out


def _legacy_mel(lib, wav):
    """One call of the CUDA-core log-mel kernel (80 mels) through its own C interface."""
    import torch

    from pytorch_models_tpu_torch.models.audio.spectrogram import reflect_pad
    from pytorch_models_tpu_torch.ops import _build as b
    from pytorch_models_tpu_torch.ops.mel import _device_constants

    xp = reflect_pad(wav, 200)
    bs, lp = xp.shape
    n_frames = (lp - 400) // 160 + 1
    w_re, w_im, filt = _device_constants(400, 80, 16_000, wav.device)
    out = torch.empty((bs, 80, n_frames), dtype=torch.float32, device=wav.device)
    b.check("legacy log-mel", lib.pmt_log_mel(xp.data_ptr(), w_re.data_ptr(), w_im.data_ptr(), filt.data_ptr(),
                                              out.data_ptr(), bs, lp, n_frames, 400, 160, 201, 80, b.stream_ptr(wav)))
    return out


def _head_mel_cases(dev, libs: dict, current: dict):
    """(name, {turn: [call]}) at chip_smoke.py's K4 and K5 shapes; each
    turn's call goes through this tree's wrapper or the legacy interface."""
    import torch

    from pytorch_models_tpu_torch.ops import greedy_head
    from pytorch_models_tpu_torch.ops.mel import log_mel_spectrogram

    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 31)
    out = []

    def head_calls(x, w, tied):
        new = greedy_head.greedy_argmax_tied if tied else greedy_head.greedy_argmax
        calls = {turn: [lambda: new(x, w)] if current[turn] else [lambda t=turn: _legacy_head(libs[t], x, w, tied)]
                 for turn in libs}
        calls["matmul"] = [lambda: torch.argmax(torch.matmul(x, w.t() if tied else w), dim=-1)]
        return calls

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).removeprefix("torch.")
        batches = (8, 16, 24, 32, 48, 64, 96, 128, 200)
        for what, tied, v, d, batches in (("GPT-2 tied", True, 50257, 768, batches),
                                          ("Whisper tied", True, 51865, 512, (8,)),
                                          ("T5 untied", False, 32128, 768, batches)):
            w = torch.randn(*((v, d) if tied else (d, v)), generator=g, device=dev).to(dtype)
            for bs in batches:
                x = torch.randn(bs, d, generator=g, device=dev).to(dtype)
                out.append((f"K4 {what} V={v} d={d} B={bs} {dn}", head_calls(x, w, tied)))
    wav = torch.from_numpy(chip_smoke._waveforms(8, [30.0] * 8, chip_smoke.SEED + 2)).to(dev)
    out.append(("K5 log-mel B=8 x 30 s 80 mels float32",
                {turn: [lambda: log_mel_spectrogram(wav)] if current[turn] else [lambda t=turn: _legacy_mel(libs[t], wav)]
                 for turn in libs}))
    return out


def _k7_cases(dev):
    """(name, [call]) for every K7 variant of chip_smoke.py, bf16 and fp32."""
    import torch

    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 21)
    models = {kind: chip_smoke._k7_model(dev, kind) for kind in ("gpt2", "whisper", "t5")}
    names = {"gpt2": "fused_decode_step", "whisper": "fused_cross_decode_step", "t5": "fused_cross_decode_step_t5"}
    variants = [(names[kind], kind, {}) for kind in names]
    variants += [(name, kind, dict(a8=a8, kv=kv, kvx=kvx, q8=q8, embed=embed))
                 for name, kind, a8, kv, kvx, q8, embed in chip_smoke.I8_VARIANTS]
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, kind, opts in variants:
            call, _, _ = chip_smoke._k7_step(dev, kind, dtype, g, models[kind], **opts)
            out.append((f"K7 {name} {str(dtype).removeprefix('torch.')} B=8", [call]))
    return out


def main() -> int:
    import torch

    argv = sys.argv[1:]
    mode = {"--k7": "k7", "--head-mel": "head-mel"}.get(argv[0] if argv else "", "attn")
    argv = argv[1:] if mode != "attn" else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from pytorch_models_tpu_torch.ops import _build

    here = Path(__file__).resolve().parent
    base = Path(argv[0]).resolve()
    sources, entries, iters = MODES[mode]
    trees = {"base": base / "pytorch_models_tpu_torch" / "csrc", "new": _build.CSRC_DIR}
    with ThreadPoolExecutor(2) as pool:  # both trees' nvcc at once
        built = {turn: pool.submit(build_lib, tree, here / "build" / "ab" / mode / turn, sources, entries)
                 for turn, tree in trees.items()}
        libs = {turn: f.result() for turn, f in built.items()}
    card = chip_smoke._card()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    from pytorch_models_tpu_torch.ops import decode_step

    # the staged weights each tree's kernel reads: unit-major copies, or (older trees) the packed tensors
    staged = {turn: decode_step._STAGED if "_unit_major" in (tree.parent / "ops" / "decode_step.py").read_text()
              else () for turn, tree in trees.items()}

    def use(turn):
        _build._lib = libs[turn]
        decode_step._STAGED = staged[turn]

    if mode == "head-mel":
        current = {turn: _bind_head_mel(lib) for turn, lib in libs.items()}
        cases = _head_mel_cases(dev, libs, current)
    else:
        cases = (_k7_cases if mode == "k7" else _cases)(dev)
    res = {}
    for name, fns in cases:
        t = {}
        matmul = isinstance(fns, dict) and "matmul" in fns
        for turn in ("base", "new", "matmul", "matmul", "new", "base") if matmul else ("base", "new", "new", "base"):
            if turn in libs:
                use(turn)
            calls = fns[turn] if isinstance(fns, dict) else fns
            t.setdefault(turn, []).append(chip_smoke._time_ms(calls, iters) * 1e3)
        res[name] = {k: sum(v) / len(v) for k, v in t.items()}
        print(f"{name}: " + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f} us" for k, v in t.items()) + f" [{card}]")
    if mode == "k7":  # the per-phase breakdown of each tree whose kernel takes stamps
        for turn, tree in (("base", base), ("new", here)):
            if "stamps" in (tree / "pytorch_models_tpu_torch" / "csrc" / "decode_step.cu").read_text():
                use(turn)
                print(f"breakdown of {turn} ({tree}):")
                chip_smoke.decode_step_breakdown(dev, card)
    print(card)
    print(json.dumps({"us": res, "base": str(base)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
