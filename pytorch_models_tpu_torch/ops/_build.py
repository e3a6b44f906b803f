"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` (Hopper), one
``nvcc`` process per source, all started together, and link into ONE shared
library with a plain C interface, loaded with ``ctypes``. No PyTorch header
is included, so the build takes seconds, not minutes.

The build runs at first use, from the package's own sources only, into
``build/kernels/`` at the repository root (listed in ``.gitignore``). The
library name carries a hash of the sources, so an edited kernel rebuilds
and a stale library is never loaded.

Every C entry point takes pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code, so a launch the device refused never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC"]

# dtype codes shared with csrc/common.cuh
DT_F32 = 0
DT_BF16 = 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every function returns a cudaError_t as int
_SIGNATURES = {
    "pmt_gather_rows": [_P, _P, _P, _I, _I, _I, _P],
    "pmt_embed_add": [_P, _I, _I, _P, _I, _P, _I, _I, _P, _I, _I, _I, _P, _I, _I, _P],
    "pmt_launch_floor": [_I, _I, _P],
    "pmt_decode_attention": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "pmt_decode_attention_cluster": [_I, _I, _I],
    "pmt_greedy_argmax": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pmt_greedy_split": [_I, _I, _I, _I, _P],
    "pmt_encoder_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "pmt_encoder_attention_k_tile": [_I],
    "pmt_log_mel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "pmt_log_mel_pass_cols": [],
    "pmt_log_mel_k_step": [],
    "pmt_log_mel_stage": [_P, _P, _I, _I, _P],
    "pmt_int8_attention": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "pmt_int8_attention_cluster": [_I, _I, _I],
    # these take a pointer to ops/decode_step.py's _Args structure
    "pmt_decode_step_workspace": [_P, _P],
    "pmt_decode_step_plan": [_P, _P],
    "pmt_decode_step": [_P],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc runs and the link, None when loaded from disk


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return nvcc


def library_path() -> Path:
    sources = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256()
    for p in sources:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpmt_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not on disk yet; return its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f[-8000:] for f in failed))
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def dtype_code(t) -> int:
    import torch

    if t.dtype == torch.float32:
        return DT_F32
    if t.dtype == torch.bfloat16:
        return DT_BF16
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    """Wrapper-side input validation (kept outside ``assert``: it must survive -O)."""
    if not cond:
        raise ValueError(msg)
