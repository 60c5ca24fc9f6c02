"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use nvcc compiles
it for sm_90a into `build/kernels/lib<name>-<hash>.so` beside the package
(the hash covers the sources and flags, so an edited kernel rebuilds) and
ctypes loads it. Nothing is built at import: the CPU test suite imports
every module on machines with no nvcc. `build()` starts one nvcc per
source, all at once, and is what a caller uses to build everything up
front; `load()` builds a single missing library on demand.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("flash_fwd", "flash_bwd", "paged_decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "flexflow_tpu_torch are built from source at first use")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """nvcc's output for the last build of `name` (ptxas register and
    shared-memory report), or "" when it was never built here."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every library in `names` that is missing, one nvcc process
    per source, all started together. Returns name -> library path;
    raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    failed = []
    for n, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_text(
            f"# {n}: rc={proc.returncode} in "
            f"{time.perf_counter() - t0:.1f}s\n{text}")
        if proc.returncode != 0:
            failed.append(f"{n} (rc {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str, signature) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed.
    `signature` maps each C entry point to its ctypes argtypes; every
    entry point returns a cudaError_t as int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signature.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


# dtype codes of csrc/common.cuh
DTYPE_CODES = {"float32": 0, "float16": 1, "bfloat16": 2}

# Launches per kernel. A wrapper adds one where it launches its kernel and
# nowhere else (never for the plain version), so a run can prove which
# kernels its path went through. The flash kernels' dropout variants (a
# template flag of the same sources) count apart.
KERNELS = KERNEL_SOURCES + ("flash_fwd_dropout", "flash_bwd_dropout")
launch_counts: Dict[str, int] = {n: 0 for n in KERNELS}
# Beside them, the launches by the kernel path that ran them: flash
# (kernels/attention.py `flash_path`), dropout or not, "flash_fwd_wgmma",
# "flash_bwd_rows", ...; paged decode (kernels/decode.py `paged_path`)
# "paged_decode_cluster", "paged_decode_block".
PATH_KERNELS = tuple(f"{k}_{p}" for k in ("flash_fwd", "flash_bwd")
                     for p in ("wgmma", "wmma", "rows")) + (
    "paged_decode_block", "paged_decode_cluster")
path_counts: Dict[str, int] = {n: 0 for n in PATH_KERNELS}


def reset_launch_counts() -> None:
    for counts in (launch_counts, path_counts):
        for n in counts:
            counts[n] = 0


# A launch made while a CUDA graph is being captured is recorded, not run,
# and a replay runs every recorded launch again without passing through
# the wrappers. So a capture takes its launches back out of the counts and
# keeps them (`captured_launches`), and every replay adds them
# (`add_launches`): the counts stay the launches the card ran.
@contextlib.contextmanager
def captured_launches(record: dict):
    """Around a capture: on exit the counts are what they were on entry,
    and `record` holds what the capture added ({"launches": {...},
    "paths": {...}}). Counts are process-wide: no other thread should
    launch kernels while one captures."""
    before = dict(launch_counts), dict(path_counts)
    try:
        yield record
    finally:
        for key, counts, base in (("launches", launch_counts, before[0]),
                                  ("paths", path_counts, before[1])):
            record[key] = {n: counts[n] - base[n] for n in counts
                           if counts[n] != base[n]}
            counts.update(base)


def add_launches(record: dict) -> None:
    """Count one replay of a graph whose capture recorded `record`."""
    for key, counts in (("launches", launch_counts), ("paths", path_counts)):
        for n, c in record.get(key, {}).items():
            counts[n] += c


def check_launch(rc: int, what: str, path: str = None) -> None:
    """Raise if a kernel entry point reported a CUDA error (a refused
    launch never runs, and a later synchronize would not report it);
    count the launch otherwise, under `what` and under `path` if given."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
    launch_counts[what] += 1
    if path is not None:
        path_counts[path] += 1


def stream_ptr(t) -> int:
    """The current CUDA stream of `t`'s device, as the C entry points take it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_operands(what: str, tensors, dtypes) -> None:
    """Validate what every kernel entry point assumes of its operands:
    CUDA tensors on one device, an accepted dtype, 16-byte aligned data."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device "
                             f"(got {t.device} and {dev})")
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operand data must be 16-byte aligned")
