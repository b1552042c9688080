"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout
(a directory ``.gitignore`` lists), then loaded with ``ctypes``. The hash
covers the source, the ``csrc/`` headers it includes (``lora_chain.cuh`` is
shared by two kernels) and the flags, so an edited source or header is
rebuilt and a finished build is reused. :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module of the port,
and this machine-independent module only touches ``nvcc`` when a kernel is
asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterable, List, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> loaded library (one load per process)
_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Any] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes with
    ``#include "..."``, directly or through another header."""
    files: List[Path] = []
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return files


def library_path(name: str) -> Path:
    """The build of ``csrc/<name>.cu``, named by a hash of its source, the
    headers it includes and the flags: editing any of them rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, Path(tmp), proc


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no finished build, all ``nvcc``
    processes running at once. Returns each name's compiler output (register
    and shared-memory use from ``-Xptxas -v``); raises on any failure."""
    jobs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    logs: Dict[str, str] = {}
    for name in names:
        if library_path(name).exists():
            logs[name] = "(cached)"
            continue
        out, tmp, proc = _start(name)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: Sequence[Any]) -> Any:
    """The C function ``symbol`` of ``csrc/<name>.cu`` with its argument
    types set (``ctypes.c_void_p`` for pointers and the stream, so 64-bit
    values are not cut) and an ``int`` (a ``cudaError_t``) result."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn
