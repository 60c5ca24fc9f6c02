"""Native (C++) host components with ctypes bindings.

The PyTorch counterpart of the JAX package's native/ (the reference's
runtime core is C++): the prefetching data loader (src/dataloader.cc:
GIL-free shuffled batch gather, reference python/flexflow_dataloader.cc)
and the task-graph simulator + MCMC annealing loop (src/simulator.cc:
reference src/runtime/simulator.cc + model.cc mcmc_optimize). The
sources are the JAX package's, copied: both run on the host, none on
the device.

The shared library is built with g++ on first use, into
`build/native/libffnative-<hash>.so` beside the package (the hash is
over the sources, so an edited source builds a new library). The build
writes a temporary file and renames it into place, so processes racing
to build it each load a whole library. Every consumer has a pure-Python
fallback, so the package works without a toolchain: `available()` says
which one runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# the JAX package's flags (its native/__init__.py)
CXXFLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _sources():
    return sorted(str(p) for p in _SRC.glob("*.cc"))


def lib_path() -> Path:
    """Where the library of the current sources lives."""
    h = hashlib.sha1(" ".join(CXXFLAGS).encode())
    for src in _sources():
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"libffnative-{h.hexdigest()[:12]}.so"


def build(force: bool = False) -> Optional[str]:
    """Compile the native library (once per source hash). Returns its path,
    or None when g++ is missing or fails."""
    global _build_failed
    with _lock:
        path = lib_path()
        if path.exists() and not force:
            return str(path)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}-"
                             f"{threading.get_ident()}")
        cmd = ["g++", *CXXFLAGS, "-o", str(tmp), *_sources()]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        finally:
            if tmp.exists():
                tmp.unlink()
        _build_failed = False
        return str(path)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    path = build()
    if path is None:
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(path)
            _configure(lib)
            _lib = lib
    return _lib


def _configure(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    dbl = ctypes.c_double
    ptr = ctypes.c_void_p
    # dataloader
    lib.ffdl_create.restype = ptr
    lib.ffdl_create.argtypes = [ptr, i64, i64, i64, ctypes.c_int, u64, i64]
    lib.ffdl_next.restype = i64
    lib.ffdl_next.argtypes = [ptr, ptr]
    lib.ffdl_reset.restype = None
    lib.ffdl_reset.argtypes = [ptr]
    lib.ffdl_batches_per_epoch.restype = i64
    lib.ffdl_batches_per_epoch.argtypes = [ptr]
    lib.ffdl_destroy.restype = None
    lib.ffdl_destroy.argtypes = [ptr]
    # simulator
    I64P = ctypes.POINTER(i64)
    DP = ctypes.POINTER(dbl)
    lib.ffsim_create.restype = ptr
    lib.ffsim_create.argtypes = [
        i64, i64, I64P, I64P, I64P, i64, I64P, I64P, i64, I64P, I64P, I64P,
        i64, DP, DP, DP, dbl, dbl,
    ]
    lib.ffsim_simulate.restype = dbl
    lib.ffsim_simulate.argtypes = [ptr, I64P]
    lib.ffsim_mcmc.restype = dbl
    lib.ffsim_mcmc.argtypes = [ptr, I64P, i64, dbl, u64]
    lib.ffsim_destroy.restype = None
    lib.ffsim_destroy.argtypes = [ptr]


def available() -> bool:
    return get_lib() is not None
