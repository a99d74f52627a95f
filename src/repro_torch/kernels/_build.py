"""Build the CUDA sources under ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for ``sm_90a``,
into ``build/repro_torch/<name>-<hash>.so`` at the root of the checkout; the
hash covers the source and the flags, so an edit rebuilds and an unchanged
source loads the library already built. ``build_all`` starts one ``nvcc``
per source at once and waits for all of them. The libraries export plain C
functions (pointers and the stream as ``void*``), so no PyTorch header is
compiled and a build takes seconds.

Nothing here runs at import: the CPU-only test environment imports every
module but has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# --split-compile=0 spreads a source's device optimisation over every core,
# so the matmul library's 16 kernel instances do not serialise the build
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC")

# kernel library -> {C symbol: ctypes argument types}; every symbol returns
# the launch's cudaError_t as an int
_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
SYMBOLS: Dict[str, Dict[str, list]] = {
    "quant_matmul": {
        "qmm_int8_splitk": [_P] * 7 + [_I] * 4 + [_P],
        "qmm_int8_mma": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "qmm_w4_splitk": [_P] * 7 + [_I] * 4 + [_P],
        "qmm_w4_mma": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "qmm_occupancy": [_I, _I, _P],
    },
    "decode_attn_quant": {
        "decode_attn_quant": [_P] * 10 + [_I] * 7 + [_F, _P],
        "decode_attn_quant_paged": [_P] * 11 + [_I] * 8 + [_F, _P],
        "verify_attn_quant": [_P] * 10 + [_I] * 8 + [_F, _P],
        "verify_attn_quant_paged": [_P] * 11 + [_I] * 9 + [_F, _P],
    },
    "fake_quant": {
        "fake_quant_fwd": [_P, _P, _P, _L, _L, _F, _F, _I, _P],
        "fake_quant_bwd": [_P, _P, _P, _P, _P, _L, _L, _F, _F, _I, _P],
    },
    "flash_attention": {
        "flash_fwd": [_P] * 5 + [_I] * 7 + [_P],
        "flash_fwd_occupancy": [_I, _I, _I, _P],
    },
    "wkv": {
        "wkv": [_P] * 10 + [_I] * 5 + [_P],
        "wkv_occupancy": [_I, _I, _P],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; None when built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Optional[List[str]] = None) -> None:
    """Compile every kernel library that is not built yet, all at once."""
    names = list(SYMBOLS) if names is None else list(names)
    with _LOCK:
        jobs = [(n, _start(n)) for n in names]
        errors = []
        for n, job in jobs:         # wait for every nvcc, even after a failure
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_target(name)))
            for sym, argtypes in SYMBOLS[name].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]
