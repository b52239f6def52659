"""Build and load the native libraries under ``metrics_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface, loaded with ``ctypes``; each
``csrc/<name>.cpp`` (the host-side RLE codec) is compiled the same way by the
host compiler (``g++ -O3 -shared -fPIC``). The build happens at first use, from
the sources in the checkout only, into ``metrics_tpu_torch/_build/`` (listed in
``.gitignore``). A library's file name carries a hash of its source, so an
edited source is rebuilt and a stale library is never loaded. :func:`build`
starts one compiler per source, all at once, each writing a private file that
is renamed into place, so processes that build at the same time never load
half a file. A failed build raises: nothing falls back to a plain version.

Nothing here runs when the package is imported: the CPU tests import every
module, and a machine may have no ``nvcc``.
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
HOST_SOURCES = ("rle_codec",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_CXX_FLAGS = ("-O3", "-shared", "-fPIC")

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


def _cxx() -> str:
    for candidate in (os.environ.get("CXX"), "g++", "c++"):
        found = candidate and shutil.which(candidate)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found: set CXX or put g++ on PATH to build the RLE codec")


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (or ``.cpp``) lives: keyed by a hash of its sources and
    flags."""
    digest = hashlib.sha256()
    headers = [] if name in HOST_SOURCES else sorted(CSRC.glob("*.cuh"))
    for src in headers + [_source(name)]:
        digest.update(src.read_bytes())
    digest.update(" ".join(HOST_CXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES, ptxas_verbose: bool = False) -> Dict[str, Path]:
    """Compile every named library that is not built yet, one compiler each, in parallel.

    With ``ptxas_verbose`` ``nvcc`` also reports each kernel's registers,
    spills and shared memory (``-Xptxas -v``), kept in :data:`build_logs`.
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = []
    for name, path in paths.items():
        if path.exists():
            continue
        compiler = _cxx() if name in HOST_SOURCES else _nvcc()
        # write to a private name and rename: a concurrent build never sees half a file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        if name in HOST_SOURCES:
            cmd = [compiler, *HOST_CXX_FLAGS, "-o", tmp, str(_source(name))]
        else:
            cmd = [compiler, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose else ()), "-I", str(CSRC), "-o", tmp,
                   str(_source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, proc, compiler))
    failures = []
    for name, path, tmp, proc, compiler in running:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            os.unlink(tmp)
            failures.append(
                f"{os.path.basename(compiler)} failed for csrc/{_source(name).name} (exit {proc.returncode}):\n{out}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cpp``), built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        if name not in HOST_SOURCES:
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({lib.kernel_error_string(rc).decode()})")
