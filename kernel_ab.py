#!/usr/bin/env python3
"""Time kernels of two source trees in one process, on one card.

    python3 kernel_ab.py BASE_DIR              # K2 and K6; BASE_DIR: a checkout of another commit (git archive)
    python3 kernel_ab.py --k7 BASE_DIR         # K7, the fused decode step
    python3 kernel_ab.py --head-mel BASE_DIR   # K4 (the greedy head, tied and untied) and K5 (log-mel)
    python3 kernel_ab.py --k1 BASE_DIR         # K1, the encoder attention

Builds the mode's sources of this checkout and of ``BASE_DIR`` (one ``nvcc``
per source, ``sm_90a``), each tree into a shared library of its own, and
times every kernel at ``chip_smoke.py``'s shapes through this checkout's
wrappers with either library loaded, in turns base, new, new, base (device
time per call, ``chip_smoke._time_ms``):

- default: ``csrc/decode_attention.cu`` and ``csrc/int8_kv.cu`` (K2, K6) at
  the bf16 shapes; both trees must share the C signatures of
  ``pmt_decode_attention`` and ``pmt_int8_attention``;
- ``--k7``: ``csrc/decode_step*.cu`` (one source, or the dispatcher and
  its eight instantiations; with the headers of its own tree) at every K7
  variant of ``chip_smoke.py`` (GPT-2, Whisper and T5, and the int8
  serving variants of ``I8_VARIANTS``) at B=8, 16 and 32 (one launch each)
  and 33, 40 and 64 (row slices) (``K7_AB_BATCHES``), bf16 and fp32; each
  case's outputs (x_out, token) of the two trees are compared: bit-equal
  where both must sum in the same order (``k7_exact``: fp32, one row group,
  w8a8 with the int8 head), else the largest |x_out difference| and the
  tokens that differ are printed.
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
  through its own C interface (``_LEGACY``), as its wrappers called it;
- ``--k1``: ``csrc/encoder_attention.cu`` (with its tree's ``common.cuh``)
  at every K1 shape of ``chip_smoke.py`` (GPT-2's causal prefill, ViT-B/16
  at B=128, Whisper-base's encoder dense and cross, ``K1_FAMILY_SHAPES``)
  and at head widths 32, 80 and 128 (``K1_WIDTH_SHAPES``), bf16 and fp32,
  each beside ``F.scaled_dot_product_attention`` on the split-head view (in
  the same turns: base, new, SDPA, SDPA, new, base), with each tree's time
  over SDPA's and its share of the bound (``chip_smoke._k1_work``). The two
  trees' outputs on the same inputs: fp32 must be bit-equal, as must the
  SASS of the fp32 instantiations (``encoder_attention_kernel<float, D,
  1>``, from ``cuobjdump -sass``, addresses and names aside); bf16 prints
  the largest difference and the rows beyond ``chip_smoke.TOL``.

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
         "k7": (("decode_step*.cu",), ("pmt_decode_step_workspace", "pmt_decode_step"), 20),
         "head-mel": (("greedy_head.cu", "mel.cu"), (), 30),
         "k1": (("encoder_attention.cu",), ("pmt_encoder_attention",), 20)}

# K1 at head widths other than 64: ViT-H/14's 257 tokens of 16 heads of 80, 16 heads of 128 over 512 tokens, and
# chip_smoke.py's head-width cases at L=300 (dense and causal); (name, B, Lq, Lk, heads, head width, causal)
K1_WIDTH_SHAPES = (("ViT-H/14", 32, 257, 257, 16, 80, False), ("D=128", 16, 512, 512, 16, 128, False),
                   ("D=32 L=300", 2, 300, 300, 8, 32, False), ("D=32 L=300 causal", 2, 300, 300, 8, 32, True),
                   ("D=80 L=300", 2, 300, 300, 16, 80, False), ("D=80 L=300 causal", 2, 300, 300, 16, 80, True),
                   ("D=128 L=300", 2, 300, 300, 4, 128, False), ("D=128 L=300 causal", 2, 300, 300, 4, 128, True))

# the C interfaces of the two-pass greedy head and the CUDA-core log-mel kernel
_P, _I = ctypes.c_void_p, ctypes.c_int
_LEGACY = {"pmt_greedy_argmax_tied": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], "pmt_greedy_chunk_rows": [],
           "pmt_greedy_argmax_untied": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], "pmt_greedy_untied_cols": [_I],
           "pmt_log_mel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]}
_CURRENT = ("pmt_greedy_argmax", "pmt_greedy_split", "pmt_log_mel", "pmt_log_mel_pass_cols",
            "pmt_log_mel_k_step", "pmt_log_mel_stage")


# Both trees' libraries live in one process: a function-local static of a template (K7's planner caches its
# attribute and occupancy there) is a GNU unique symbol by default, which the dynamic loader binds once per process
# whatever the library, so the second library's planner would read the first's cache and skip setting its own
# kernel's shared-memory attribute (its launch then fails, error 720). Built without unique symbols, each library
# keeps its own statics.
HOST_FLAGS = ["-Xcompiler", "-fno-gnu-unique"]


def build_lib(csrc: Path, out_dir: Path, sources, entries):
    from pytorch_models_tpu_torch.ops import _build as b

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = b._find_nvcc()
    objs, procs = [], []
    sources = [p.name for pattern in sources for p in sorted(csrc.glob(pattern))]  # K7: one source or several
    for name in sources:
        obj = out_dir / (Path(name).stem + ".o")
        procs.append(subprocess.Popen([nvcc, *b.NVCC_FLAGS, *HOST_FLAGS, "-c", "-o", str(obj), str(csrc / name)],
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


def _k1_shapes():
    """(name, B, Lq, Lk, heads, head width, causal) of every K1 shape that chip_smoke.py times, then
    K1_WIDTH_SHAPES."""
    shapes = [("GPT-2 causal", 2, 1024, 1024, 12, 64, True), ("ViT-B/16", 128, 197, 197, 12, 64, False),
              ("Whisper-base encoder", 8, 1500, 1500, 8, 64, False), ("Whisper-base cross", 8, 448, 1500, 8, 64, False)]
    shapes += [(name, b, lq, lk, h, d, False) for name, b, lq, lk, h, d in chip_smoke.K1_FAMILY_SHAPES]
    return shapes + list(K1_WIDTH_SHAPES)


def _k1_cases(dev):
    """(name, {turn: [call]}, outputs) at every K1 shape, bf16 then fp32; ``outputs()`` gives both trees' outputs
    on the case's inputs."""
    import torch
    import torch.nn.functional as F

    from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention

    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 41)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).removeprefix("torch.")
        for name, b, lq, lk, h, d, causal in _k1_shapes():
            q = torch.randn(b, lq, h * d, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(b, lk, h * d, generator=g, device=dev).to(dtype) for _ in range(2))

            def heads(t, h=h):  # (B, L, H*D) -> the split-head (B, H, L, D) view SDPA takes
                return t.unflatten(-1, (h, -1)).transpose(1, 2)

            call = [lambda q=q, k=k, v=v, h=h, c=causal: encoder_attention(q, k, v, h, c)]
            sdpa = [lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                                                   is_causal=c)]
            yield (f"K1 {name} B={b} Lq={lq} Lk={lk} H={h} D={d} {dn}", {"base": call, "new": call, "sdpa": sdpa},
                   (q, k, causal))


def _k1_compare(name: str, got: dict, dn: str) -> dict:
    """The two trees' outputs of one K1 case: fp32 bit-equal or not; bf16 the largest difference and the rows
    (batch row, query, head) beyond chip_smoke.TOL of the base's output."""
    import torch

    a, b = got["base"].float(), got["new"].float()
    if dn == "float32":
        return {"bit_equal": bool(torch.equal(got["base"], got["new"])), "max_diff": (a - b).abs().max().item()}
    atol, rtol = chip_smoke.TOL[dn]
    d = int(name.split(" D=")[1].split()[0])
    beyond = ((a - b).abs() > atol + rtol * a.abs()).unflatten(-1, (-1, d)).any(-1)
    return {"max_diff": (a - b).abs().max().item(), "rows_beyond_tol": int(beyond.sum())}


def _k1_fp32_sass(lib_path: Path) -> dict:
    """The SASS of each fp32 instantiation of K1 (``encoder_attention_kernel<float, D, 1>``) in a library, by head
    width, with addresses, encodings and symbol names left out."""
    import re
    import shutil

    from pytorch_models_tpu_torch.ops import _build as b

    tool = shutil.which("cuobjdump") or str(Path(b._find_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"encoder_attention_kernelIfLi(\d+)ELi1E", line)
            cur = f"D={m.group(1)}" if m else None
            if cur:
                out[cur] = []
        elif cur is not None:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if ins:
                out[cur].append(re.sub(r"\(\*\"[^\"]*\"\*\)|_Z\w+", "", ins.group(1)))
    return out


K7_AB_BATCHES = (8, 16, 32, 33, 40, 64)


def k7_exact(name: str, dtype: str, b: int) -> bool:
    """The K7 cases whose outputs two trees must give bit for bit: fp32 and
    one row group (B <= 8) keep their CUDA-core sums; w8a8 with the int8
    head sums int8 products in int32, exact in any order. A bf16 launch
    above one row group sums on the tensor cores, in another order."""
    return dtype == "float32" or b <= 8 or name.endswith("_a8")


def _k7_cases(dev):
    """(name, [call], exact) for every K7 variant of chip_smoke.py at K7_AB_BATCHES, bf16 and fp32, made one at a
    time (a case's caches are freed before the next one's are made)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 21)
    models = {kind: chip_smoke._k7_model(dev, kind) for kind in ("gpt2", "whisper", "t5")}
    names = {"gpt2": "fused_decode_step", "whisper": "fused_cross_decode_step", "t5": "fused_cross_decode_step_t5"}
    variants = [(names[kind], kind, {}) for kind in names]
    variants += [(name, kind, dict(a8=a8, kv=kv, kvx=kvx, q8=q8, embed=embed))
                 for name, kind, a8, kv, kvx, q8, embed in chip_smoke.I8_VARIANTS]
    for dtype in (torch.bfloat16, torch.float32):
        for b in K7_AB_BATCHES:
            for name, kind, opts in variants:
                call, _, _ = chip_smoke._k7_step(dev, kind, dtype, g, models[kind], **opts, b=b)
                dn = str(dtype).removeprefix("torch.")
                yield f"K7 {name} {dn} B={b}", [call], k7_exact(name, dn, b)


def main() -> int:
    import torch

    argv = sys.argv[1:]
    mode = {"--k7": "k7", "--head-mel": "head-mel", "--k1": "k1"}.get(argv[0] if argv else "", "attn")
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
    elif mode == "k1":
        cases = _k1_cases(dev)
    else:
        cases = (_k7_cases if mode == "k7" else _cases)(dev)
    res = {}
    for name, fns, *exact in cases:
        t = {}
        lib_call = next((k for k in ("matmul", "sdpa") if isinstance(fns, dict) and k in fns), None)
        for turn in ("base", "new", lib_call, lib_call, "new", "base") if lib_call else ("base", "new", "new", "base"):
            if turn in libs:
                use(turn)
            calls = fns[turn] if isinstance(fns, dict) else fns
            t.setdefault(turn, []).append(chip_smoke._time_ms(calls, iters) * 1e3)
        res[name] = {k: sum(v) / len(v) for k, v in t.items()}
        same = ""
        if mode == "k1":  # both trees' outputs on the same inputs; times over SDPA's and shares of the bound
            q, k, causal = exact[0]
            dn = str(q.dtype).removeprefix("torch.")
            got = {}
            for turn in ("base", "new"):
                use(turn)
                got[turn] = fns[turn][0]()
            torch.cuda.synchronize()
            res[name].update(_k1_compare(name, got, dn))
            nbytes, flops = chip_smoke._k1_work(q, k, causal)
            bound = chip_smoke._rec(0.0, 1.0, 1.0, nbytes, flops, dn, tf32x3=True)
            res[name]["bound_us"], res[name]["bound_by"] = bound["bound_ms"] * 1e3, bound["bound_by"]
            same = ("; " + ", ".join(f"{turn} / SDPA {res[name][turn] / res[name]['sdpa']:.2f}, "
                                     f"{res[name]['bound_us'] / res[name][turn]:.0%} of the bound"
                                     for turn in ("base", "new"))
                    + f" ({res[name]['bound_us']:.2f} us, {res[name]['bound_by']}); outputs: "
                    + (f"bit-equal {res[name]['bit_equal']}" if dn == "float32"
                       else f"max |new - base| {res[name]['max_diff']:.3g}, "
                            f"{res[name]['rows_beyond_tol']} rows beyond TOL"))
        if mode == "k7":  # both trees' outputs on the same inputs (k7_exact: where they must be the same bits)
            got = {}
            for turn in ("base", "new"):
                use(turn)
                got[turn] = fns[0]()
            torch.cuda.synchronize()
            pairs = [(a, b) for a, b in zip(got["base"], got["new"]) if a is not None]
            equal = all(torch.equal(a, b) for a, b in pairs)
            res[name]["bit_equal"] = equal
            res[name]["must_equal"] = exact[0]
            x_diff = (pairs[0][0].float() - pairs[0][1].float()).abs().max().item()
            n_tok = int((pairs[1][0] != pairs[1][1]).sum()) if len(pairs) > 1 else 0
            res[name]["x_out_max_diff"], res[name]["tokens_differ"] = x_diff, n_tok
            same = (f"; outputs bit-equal: {equal}" + ("" if exact[0] else " (need not be)")
                    + ("" if equal else f", x_out max |diff| {x_diff:.3g}, {n_tok} tokens differ"))
        print(f"{name}: " + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f} us" for k, v in t.items()) + same + f" [{card}]")
    if mode == "k7":  # the per-phase breakdown of each tree whose kernel takes stamps
        for turn, tree in (("base", base), ("new", here)):
            if any("stamps" in f.read_text() for f in (tree / "pytorch_models_tpu_torch" / "csrc").glob("decode_step*")):
                use(turn)
                print(f"breakdown of {turn} ({tree}):")
                chip_smoke.decode_step_breakdown(dev, card, rows=(8, 32))
    sass_equal = None
    if mode == "k1":  # the fp32 instantiations' SASS of the two trees
        sass = {turn: _k1_fp32_sass(here / "build" / "ab" / mode / turn / "libab.so") for turn in libs}
        sass_equal = {d: sass["new"].get(d) == code for d, code in sass["base"].items()}
        print("K1 fp32 SASS identical to the base's: " + ", ".join(f"{d} {eq}" for d, eq in sass_equal.items())
              + f" ({', '.join(f'{d} {len(c)} instructions' for d, c in sass['new'].items())})")
    print(card)
    print(json.dumps({"us": res, "base": str(base), **({"k1_fp32_sass_equal": sass_equal} if sass_equal else {})}))
    if mode == "k7" and not all(r["bit_equal"] for r in res.values() if r["must_equal"]):
        print("kernel_ab: the two trees' K7 outputs differ where they must not", file=sys.stderr)
        return 1
    if mode == "k1" and not (all(r["bit_equal"] for r in res.values() if "bit_equal" in r)
                             and sass_equal and all(sass_equal.values())):
        print("kernel_ab: the two trees' fp32 K1 outputs or SASS differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
