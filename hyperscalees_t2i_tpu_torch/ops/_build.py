"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout
(a directory ``.gitignore`` lists), then loaded with ``ctypes``. The hash
covers the source, the ``csrc/`` headers it includes (``lora_chain.cuh`` is
shared by two kernels) and the flags, so an edited source or header is
rebuilt and a finished build is reused. :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them together. A source
whose text carries a ``// HSES_PARTS n`` line is compiled ``n`` times at
once, with ``-DHSES_PART=0`` to ``n - 1``, into objects linked into its one
library: the source itself says what each part holds.

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
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_PARTS = re.compile(rb"^// HSES_PARTS (\d+)$", re.MULTILINE)

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


def parts(name: str) -> int:
    """How many compilations ``csrc/<name>.cu`` is built from (1 unless it
    says ``// HSES_PARTS n``)."""
    m = _PARTS.search((CSRC_DIR / f"{name}.cu").read_bytes())
    return int(m.group(1)) if m else 1


def library_path(name: str) -> Path:
    """The build of ``csrc/<name>.cu``, named by a hash of its source, the
    headers it includes and the flags: editing any of them rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, part: int = -1) -> Tuple[Path, subprocess.Popen]:
    """One ``nvcc`` into a temporary file of ``BUILD_DIR``: the whole
    library, or (``part`` ≥ 0) the object of one part."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so" if part < 0 else f".part{part}.o", dir=BUILD_DIR)
    os.close(fd)
    flags = list(NVCC_FLAGS) if part < 0 else [f for f in NVCC_FLAGS if f != "-shared"] + ["-c", f"-DHSES_PART={part}"]
    cmd = [_nvcc(), *flags, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    return Path(tmp), subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all(names: Iterable[str], seconds: Optional[Dict[str, float]] = None) -> Dict[str, str]:
    """Compile every named source that has no finished build, all ``nvcc``
    processes running at once. Returns each name's compiler output (register
    and shared-memory use from ``-Xptxas -v``); raises on any failure.
    ``seconds``, when given, receives each compiled source's wall seconds
    from its start to its ``nvcc``'s exit."""
    # (name, part or -1, temporary output, process)
    jobs: List[Tuple[str, int, Path, subprocess.Popen]] = []
    logs: Dict[str, str] = {}
    texts: Dict[Tuple[str, int], str] = {}
    t0 = time.perf_counter()
    todo = []
    for name in names:
        if library_path(name).exists():
            logs[name] = "(cached)"
            continue
        todo.append(name)
        n = parts(name)
        for part in (range(n) if n > 1 else (-1,)):
            jobs.append((name, part, *_start(name, part)))

    def drain(job):
        # each compiler's output read on its own thread, so that its exit
        # is timed when it happens and no process waits on a full pipe
        name, part, _, proc = job
        texts[(name, part)] = proc.communicate()[0]
        if seconds is not None:
            seconds[name if part < 0 else f"{name}[{part}]"] = time.perf_counter() - t0

    readers = [threading.Thread(target=drain, args=(job,)) for job in jobs]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    failed = []
    for name in todo:
        mine = [(part, tmp, proc) for n, part, tmp, proc in jobs if n == name]
        logs[name] = "".join(texts[(name, part)] for part, _, _ in mine)
        bad = [p for p in mine if p[2].returncode != 0]
        if bad:
            failed.append(f"{name}: nvcc exited {bad[0][2].returncode}\n{logs[name]}")
        elif mine[0][0] < 0:
            os.replace(mine[0][1], library_path(name))
        else:
            # link the parts' objects into the library
            fd, lib = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", lib, *(str(t) for _, t, _ in mine)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                Path(lib).unlink(missing_ok=True)
                failed.append(f"{name}: linking its parts exited {link.returncode}\n{link.stdout}{link.stderr}")
            else:
                os.replace(lib, library_path(name))
            if seconds is not None:
                seconds[name] = time.perf_counter() - t0
        for _, tmp, _ in mine:
            tmp.unlink(missing_ok=True)
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
