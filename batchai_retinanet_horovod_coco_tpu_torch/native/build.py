"""Build a C++ source of this package into a shared library and load it.

Each source (``native/<name>.cpp``) exposes a plain C interface and is
compiled by ``g++ -O3 -shared -fPIC`` at first use into ``build/native/``
at the root of the checkout (listed in ``.gitignore``), then loaded with
``ctypes``, which releases the interpreter lock for the length of each
call.  The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.

Nothing here runs at import time, and there is no fallback: a missing
``g++`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parents[1] / "build" / "native"

# No -march=native: a library may be loaded on another host of the same
# checkout.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall")


def library_path(name: str) -> Path:
    """Where the library of ``native/<name>.cpp`` is built."""
    source = (SOURCE_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(source + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def compile_library(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless its library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH; native/{name}.cpp is built from source")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}) building native/{name}.cpp:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """The library of ``native/<name>.cpp``, built unless it exists, then
    loaded (the caller keeps it)."""
    return ctypes.CDLL(str(compile_library(name)))
