"""Build and load the hand-written CUDA kernels under ``metrics_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, from the sources in the checkout only, into
``metrics_tpu_torch/_build/`` (listed in ``.gitignore``). A library's file name
carries a hash of its source, so an edited kernel is rebuilt and a stale one is
never loaded. :func:`build` starts one ``nvcc`` per source, all at once.

Nothing here runs when the package is imported: the CPU tests import every
module, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("binned_hist", "ssim_window")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # the compiler's output of each library built by this process


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed by a hash of its sources and flags."""
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES, ptxas_verbose: bool = False) -> Dict[str, Path]:
    """Compile every named kernel library that is not built yet, one ``nvcc`` each, in parallel.

    With ``ptxas_verbose`` the compiler also reports each kernel's registers,
    spills and shared memory (``-Xptxas -v``), kept in :data:`build_logs`.
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    paths = {name: library_path(name) for name in names}
    running = []
    for name, path in paths.items():
        if path.exists():
            continue
        # write to a private name and rename: a concurrent build never sees half a file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose else ()), "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in running:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            os.unlink(tmp)
            failures.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({lib.kernel_error_string(rc).decode()})")
