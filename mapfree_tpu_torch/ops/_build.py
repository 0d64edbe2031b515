"""Build the port's CUDA C++ sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled on its
own by ``nvcc`` for sm_90a into a shared library under ``ops/_build/``
(a directory git ignores), named by a hash of the source, the headers it
includes from ``csrc/`` and the flags, so an edited source or header rebuilds
and an unchanged one loads the existing library.
No PyTorch headers are included: a build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_name_locks: dict = {}
_libs: dict = {}
# per library: seconds spent in nvcc (0.0 when an earlier build was reused)
# and the compiler's report (ptxas registers, shared memory, spills)
build_seconds: dict = {}
build_logs: dict = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, then PATH, then the toolkit's
    default install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source with the CUDA "
        "toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def source_files(src: Path) -> list:
    """``src`` and every file it includes with quotes, directly or through
    another such file, resolved beside the including file."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (path.parent / inc).is_file():
                todo.append(path.parent / inc)
    return seen


def source_digest(src: Path) -> str:
    """Names a build: changes when ``src``, a header it includes or a
    compiler flag changes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(source_files(src)):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library.
    Each library has a lock of its own, so different sources build at once."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        so = BUILD_DIR / f"lib{name}-{source_digest(src)}.so"
        if so.is_file():
            build_seconds[name] = 0.0
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds[name] = time.perf_counter() - t0
            build_logs[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                    f"{build_logs[name]}")
            os.replace(tmp, so)
        lib = _libs[name] = ctypes.CDLL(str(so))
        return lib


def load_libraries(names) -> None:
    """Build and load several sources at once, one nvcc process each."""
    threads = [threading.Thread(target=load_library, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in names:
        load_library(n)  # raises here if that source failed to build
