"""The port's native BPE library (``bpe.cpp``, a copy of the JAX package's),
built with g++ at first use and bound through ctypes.

``load_bpe_lib`` compiles ``bpe.cpp`` into ``build/libbpe-<digest>.so``,
the digest covering the source and the flags, so an edited source never
loads a stale library; nothing is built when a module is imported. There is
no Python fallback: a missing g++ or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "bpe.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOADED: dict[str, ctypes.CDLL] = {}


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libbpe-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``bpe.cpp`` unless its library is already built; returns the
    library's path."""
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the port's BPE library builds only "
                           "where it is")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load_bpe_lib() -> ctypes.CDLL:
    """The loaded BPE library, built first if needed, with the ctypes
    signatures of its C API."""
    path = str(build())
    lib = _LOADED.get(path)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(path)
    lib.bpe_new.restype = ctypes.c_void_p
    lib.bpe_new.argtypes = []
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_free.restype = None
    lib.bpe_train.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                              ctypes.c_int64, ctypes.c_int32]
    lib.bpe_train.restype = None
    lib.bpe_vocab_size.argtypes = [ctypes.c_void_p]
    lib.bpe_vocab_size.restype = ctypes.c_int32
    lib.bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.bpe_encode.restype = ctypes.c_int32
    lib.bpe_decode.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                               ctypes.c_char_p, ctypes.c_int32]
    lib.bpe_decode.restype = ctypes.c_int32
    lib.bpe_token.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
                              ctypes.c_int32]
    lib.bpe_token.restype = ctypes.c_int32
    lib.bpe_serialize.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.bpe_serialize.restype = ctypes.c_int32
    lib.bpe_deserialize.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bpe_deserialize.restype = None
    _LOADED[path] = lib
    return lib
