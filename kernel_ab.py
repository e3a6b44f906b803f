#!/usr/bin/env python3
"""Time kernels of two source trees in one process, on one card.

    python3 kernel_ab.py BASE_DIR         # K2 and K6; BASE_DIR: a checkout of another commit (git archive)
    python3 kernel_ab.py --k7 BASE_DIR    # K7, the fused decode step

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
  kernel takes ``stamps``.

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
         "k7": (("decode_step.cu",), ("pmt_decode_step_workspace", "pmt_decode_step"), 20)}


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
    mode = "k7" if argv[:1] == ["--k7"] else "attn"
    argv = argv[1:] if mode == "k7" else argv
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

    res = {}
    for name, fns in (_k7_cases if mode == "k7" else _cases)(dev):
        t = {}
        for turn in ("base", "new", "new", "base"):
            use(turn)
            t.setdefault(turn, []).append(chip_smoke._time_ms(fns, iters) * 1e3)
        res[name] = {k: sum(v) / len(v) for k, v in t.items()}
        print(f"{name}: base {t['base'][0]:.2f} / {t['base'][1]:.2f} us, new {t['new'][0]:.2f} / {t['new'][1]:.2f} "
              f"us [{card}]")
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
