"""The nvcc build shared by every kernel source of the port.

Each source under ``csrc/`` compiles with nvcc (sm_90a, plain C interface)
into ``build/kernels/<stem>-<hash>.so``, where the hash covers the source,
every header under ``csrc/`` (a source may include any of them) and the
flags: an edited source or header builds anew, an unchanged one is reused.
The library is written under a temporary name and renamed into place, so
a reader never loads a half-written file. nvcc's output (the ptxas
register, shared-memory and spill lines) is kept and returned.

``build_all`` starts one nvcc per source at once, so the sources build in
parallel; ``load`` builds (if needed) and binds one C symbol with ctypes.
``sm_count`` and ``split_workspace`` serve the wrappers' split plans.
Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_sms: Dict[object, int] = {}
_workspaces: Dict[Tuple[str, object], object] = {}


def source(name: str) -> str:
    """Absolute path of a kernel source under csrc/."""
    return os.path.join(CSRC, name)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels build from source on the machine with the card")
    return path


HEADER_SUFFIXES = (".cuh", ".h")


def library_path(src: str) -> str:
    digest = hashlib.sha1()
    with open(src, "rb") as f:
        digest.update(f.read())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith(HEADER_SUFFIXES):
            with open(os.path.join(CSRC, name), "rb") as f:
                digest.update(name.encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")


def build_all(sources: Iterable[str]) -> List[dict]:
    """Compile every source whose library is missing, all nvcc processes
    started together. Returns [{"source", "path", "log"}] in the order
    given (log empty when the library was already built); raises with
    nvcc's output when a build fails."""
    sources = list(sources)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for src in sources:
        path = library_path(src)
        if os.path.exists(path):
            jobs.append((src, path, None, None))
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, path, tmp, proc))
    out, failed = [], []
    for src, path, tmp, proc in jobs:
        if proc is None:
            out.append({"source": src, "path": path, "log": ""})
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out.append({"source": src, "path": path, "log": log})
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(src: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C launcher `symbol` of `src` (built on first use), with its
    argtypes set and an int (cudaError_t) return."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = ctypes.CDLL(build_all([src])[0]["path"])
            _libs[src] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


def sm_count(device) -> int:
    """The CUDA device's SM count (cached): the unit of the split plans'
    one wave."""
    n = _sms.get(device)
    if n is None:
        import torch
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sms[device] = n
    return n


def split_workspace(owner: str, device, floats: int):
    """`owner`'s fp32 split workspace on the CUDA device (at least
    `floats`), kept beyond the launch: the kernel that reads it may be a
    programmatic dependent that starts while the writer still runs, so a
    buffer freed when the wrapper returned could be handed to that
    kernel's own outputs. One buffer serves every launch of `owner` on
    the stream; each owner keeps its own."""
    ws = _workspaces.get((owner, device))
    if ws is None or ws.numel() < floats:
        import torch
        ws = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                         device=device)
        _workspaces[(owner, device)] = ws
    return ws
