"""Build and load the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, ``build/repro_torch/lib<name>-<hash>.so`` under the
repository root, and loaded with ``ctypes``.
The hash covers the sources and the flags, so an edited kernel rebuilds and
an unchanged one is loaded as it is. The sources are compiled in parallel,
one ``nvcc`` process each, the first time any kernel is asked for.

Nothing here runs when a module is imported: the CPU tests import every
module and have no ``nvcc``.

Every call of a C entry point runs with its tensors' device current
(``function(..., device=)``): a stream of ``cuda:1`` used while ``cuda:0``
is current would fail or launch into the wrong context, and the per-device
state the sources keep (attributes set by ``cudaFuncSetAttribute``, SM
counts and occupancy) is looked up by the current device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds each source took to compile in this process (0.0 if it was cached)
build_seconds: Dict[str, float] = {}


def build_dir() -> Path:
    """Where the libraries go: ``<repo>/build/repro_torch`` (``build/`` is
    git-ignored)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch finds it, else
    ``nvcc`` on the PATH. Raises if there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels "
                           "are built on a machine with the CUDA toolkit")
    return found


def sources() -> Dict[str, Path]:
    """Kernel name -> ``.cu`` source, for every source in ``csrc/``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _target(name: str, src: Path) -> Path:
    h = hashlib.sha256()
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every source that is not built yet, all ``nvcc`` processes
    started together; returns name -> build seconds (0.0 when cached).
    Raises ``RuntimeError`` with nvcc's stderr if any build fails."""
    with _lock:
        return _build_locked()


def _build_locked() -> Dict[str, float]:
    todo = {}
    for name, src in sources().items():
        if name in build_seconds:
            continue
        out = _target(name, src)
        if out.exists():
            build_seconds[name] = 0.0
        else:
            todo[name] = (src, out)
    if not todo:
        return dict(build_seconds)
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, (src, out) in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu (exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)
        build_seconds[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("repro_torch: nvcc failed\n" + "\n".join(errors))
    return dict(build_seconds)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _build_locked()
            lib = ctypes.CDLL(str(_target(name, sources()[name])))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int, *,
             device) -> callable:
    """C entry point ``symbol`` of library ``name`` with its ``argtypes``
    declared (pointers and the stream as ``c_void_p``) and its ``restype``
    (by default an int, the CUDA error code), called with ``device`` (the
    CUDA device of the tensors it is given) as the current device."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, restype

    def on_device(*args):
        with torch.cuda.device(device):
            return fn(*args)
    return on_device


def check(name: str, rc: int, what: str) -> None:
    """Raise if a C entry point of library ``name`` returned a CUDA error
    code (its ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        msg: Optional[bytes] = getattr(library(name),
                                       f"{name}_error_string")(rc)
        raise RuntimeError(f"repro_torch: {what} launch failed with CUDA "
                           f"error {rc}: {msg.decode() if msg else '?'}")
