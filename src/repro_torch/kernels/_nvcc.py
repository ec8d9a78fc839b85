"""Build a kernel's CUDA source with ``nvcc`` and bind its entry point with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` with plain ``extern "C"`` entry points:
the launcher, which returns ``cudaGetLastError()``, and
``<name>_error_string(int)``. ``build`` compiles one source into the
repository's git-ignored ``build/`` directory; each library is named by a hash
of its source and the flags, so an edit rebuilds and an unchanged source is not
compiled again. Nothing is built or loaded at import time: a ``Kernel`` builds
and loads at its first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTR, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"    # the toolkit's standard install prefix
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Tuple[Path, str]:
    """Compile `source` unless it has been built; returns the shared library's
    path and nvcc's output (empty when it was cached)."""
    lib = library_path(source)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {lib.name} ({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)     # atomic: a concurrent loader never sees half a file
    return lib, proc.stdout


class Kernel:
    """One ``extern "C"`` launcher of a ``.cu`` source, loaded at first use."""

    def __init__(self, source: Path, entry: str, argtypes: Sequence):
        self.source = source
        self.entry = entry
        self.argtypes = list(argtypes)
        self._fn = None
        self._err_str = None

    def _load(self):
        if self._fn is None:
            path, _ = build(self.source)
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err_str = getattr(lib, f"{self.source.stem}_error_string")
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._fn, self._err_str = fn, err_str
        return self._fn

    def launch(self, *args) -> None:
        """Call the launcher; raise if CUDA refused the launch."""
        err = self._load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.entry} launch failed: CUDA error {err} "
                               f"({self._err_str(err).decode()})")
