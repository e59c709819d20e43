"""Build the package's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Every ``kernels/*/csrc/*.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so <name>.cu

The output lands in ``build/kernels/`` at the root of the checkout.  The file
name carries a hash of the source, of every local header it includes
(``#include "..."``, such as ``kernels/hopper.cuh``, followed recursively) and
of the flags, so an edited source or header never loads a stale library.  All
sources build in parallel, one ``nvcc`` each.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

#: device types whose tensors take a kernel's plain version: the CPU's, and
#: ``meta`` (shapes only: the dry run's FLOP count allocates and launches
#: nothing); a CUDA tensor launches the kernel or raises
PLAIN_DEVICES = ("cpu", "meta")

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, tuple] = {}
_SAME_DEVICE = contextlib.nullcontext()


def plain(t: torch.Tensor) -> bool:
    """True where ``t`` takes the plain version (``PLAIN_DEVICES``)."""
    return t.device.type in PLAIN_DEVICES


def sources() -> Dict[str, Path]:
    """Kernel name (file stem) -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(_PKG.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    cand = [os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin/nvcc",
            shutil.which("nvcc") or ""]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def includes(src: Path) -> list:
    """The local headers ``src`` includes, recursively, each once, in the
    order first met (a quoted include is found beside the including file)."""
    seen, todo = [], [src]
    while todo:
        cur = todo.pop(0)
        for name in _INCLUDE.findall(cur.read_bytes()):
            dep = (cur.parent / name.decode()).resolve()
            if dep.exists() and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for dep in includes(src):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Compile every source whose library is missing, all ``nvcc`` runs at
    once.  Returns {name: seconds} for the sources compiled now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: s for n, s in sources().items() if not _target(s).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, src in todo.items():
        out = _target(src)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, out)            # atomic: readers never see a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name] = ctypes.CDLL(str(_target(sources()[name])))
    return lib


def entry(name: str, fn_name: str, argtypes) -> tuple:
    """(library, C entry point) of kernel ``name``, its argument types set
    once: a wrapper on every layer of every decode step pays for no more."""
    key = (name, fn_name)
    got = _entries.get(key)
    if got is None:
        lib = load(name)
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        got = _entries[key] = (lib, fn)
    return got


def on_device(index: int):
    """A context in which launches land on CUDA device ``index``; nothing to
    switch when it is the current one."""
    return _SAME_DEVICE if index == torch.cuda.current_device() \
        else torch.cuda.device(index)


def current_stream(index: int) -> int:
    """The raw handle of device ``index``'s current stream, without the
    Stream object that ``torch.cuda.current_stream()`` builds per call."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point; every
    library exports ``error_string`` (``cudaGetErrorString``)."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
