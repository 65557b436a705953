"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` (with the headers it includes) becomes one
shared library with a plain C interface, compiled for ``sm_90a`` into
``build/repro_torch/`` at the root of the checkout and keyed by a hash
of the sources and flags, so a library is rebuilt only when a source
changes.  ``build_all`` starts one nvcc per source, all at once, and
waits for them together.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on
a nonzero code.  Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "build_all", "load", "bind", "check", "on_device",
           "ptxas_report"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _ROOT / "build" / "repro_torch"
SOURCES = ("zero_stall_matmul", "zero_stall_sm90", "quantized_matmul",
           "quantized_sm90", "flash_attention", "paged_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str) -> subprocess.Popen | None:
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    log = open(out.with_suffix(".log"), "w")
    try:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def _finish(name: str, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    rc = proc.wait()
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if rc != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {rc}):\n"
                           + out.with_suffix(".log").read_text())
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every source that is not built yet, all nvcc's at once."""
    with _LOCK:
        procs = {n: _start(n) for n in SOURCES if n not in _LIBS}
        try:
            for n, p in procs.items():
                _finish(n, p)
        finally:
            for p in procs.values():
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            _finish(name, _start(name))
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return _LIBS[name]


def bind(name: str, argtypes: list, source: str | None = None
         ) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<source>.cu`` (``source``
    defaults to ``name``), built at first use and given its signature
    once: ``argtypes`` and an ``int`` result."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(load(source or name), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
    return fn


def on_device(device: torch.device):
    """A context that makes ``device`` current, or nothing when it is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said for the last build of ``name``: registers,
    shared memory and spills of each kernel instantiation."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(name: str, code: int) -> None:
    """Raise if the C entry point of ``csrc/<name>.cu`` returned a CUDA
    error code."""
    if code != 0:
        fn = load(name).repro_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {code} at launch: "
                           f"{fn(code).decode()}")
