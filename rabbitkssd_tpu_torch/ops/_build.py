"""Build the port's CUDA sources into plain-C shared libraries.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``rabbitkssd_tpu_torch/build/``, keyed by a hash of the source and
of every ``csrc`` header it includes (``#include "x.cuh"``, followed
recursively), at first use; the library is loaded with ctypes (no
PyTorch headers, so a build takes seconds).  :func:`load_cuda_libs`
starts one nvcc for each source not yet built, all at once.  A failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_digest(source: str) -> str:
    """Hash of ``csrc/<source>`` and of the csrc headers it includes."""
    h = hashlib.sha256()
    seen: set[str] = set()
    todo = [source]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        with open(os.path.join(CSRC, name), "rb") as f:
            text = f.read()
        h.update(name.encode() + b"\0" + text)
        todo.extend(inc.decode() for inc in _INCLUDE.findall(text)
                    if os.path.isfile(os.path.join(CSRC, inc.decode())))
    return h.hexdigest()[:16]


def load_cuda_libs(sources: list[str]) -> list[ctypes.CDLL]:
    """Compile each ``csrc/<source>`` for sm_90a (cached by content hash;
    the missing ones by concurrent nvcc processes) and load them.
    Thread-safe; raises on any build or load failure."""
    with _LOCK:
        todo = {s: os.path.join(BUILD_DIR, f"lib{os.path.splitext(s)[0]}_"
                                f"{_source_digest(s)}.so")
                for s in sources if s not in _LIBS}
        procs = []
        for source, so in todo.items():
            if os.path.exists(so):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-o", tmp, os.path.join(CSRC, source)]
            procs.append((source, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for source, so, tmp, proc in procs:  # wait for every nvcc
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {source}:\n{err[-4000:]}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        for source, so in todo.items():
            _LIBS[source] = ctypes.CDLL(so)
        return [_LIBS[s] for s in sources]


def load_cuda_lib(source: str) -> ctypes.CDLL:
    """:func:`load_cuda_libs` of one source."""
    return load_cuda_libs([source])[0]
