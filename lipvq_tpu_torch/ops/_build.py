"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>-<digest>.so``; the digest covers the source, every
header under ``csrc/`` and the flags, so an edited source or shared header
never loads a stale library. Nothing is built when
a module is imported: the first call that needs a kernel builds it, and
``build`` starts one nvcc per source, all at once, for callers that want the
build out of the way up front (``chip_smoke.py``).

``load`` is the one library cache and ``launch`` the one foreign call of
the kernel modules.

There is no fallback: a missing nvcc or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of lipvq_tpu_torch build only where it is")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, tuple[float, str]]:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, all started together. Returns {name: (seconds,
    compiler log)}; a library already built reports (0.0, "")."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    results = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            results[name] = (0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                               f"{proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        results[name] = (seconds, log)
    return results


def load(name: str, declare=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed. On
    the first load ``declare(name, lib)`` gives the entry points their
    ctypes signatures and checks the constants its module shares with the
    library."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.lipvq_error_string.argtypes = [ctypes.c_int]
        lib.lipvq_error_string.restype = ctypes.c_char_p
        if declare is not None:
            declare(name, lib)
        _LOADED[name] = lib
    return lib


def addresses(tensors) -> ctypes.Array:
    """The tensors' device addresses as a C array, for an entry point that
    takes a list of tensors."""
    return (ctypes.c_uint64 * len(tensors))(*[t.data_ptr() for t in tensors])


def launch(lib: ctypes.CDLL, entry: str, dev: torch.device, *args) -> None:
    """Call ``lib``'s ``entry`` with ``args`` and ``dev``'s current stream,
    under ``dev``'s guard only where it is not the current device; a
    non-zero cudaError_t raises with the library's text for it."""
    fn = getattr(lib, entry)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: {lib.lipvq_error_string(err).decode()} ({err})")
