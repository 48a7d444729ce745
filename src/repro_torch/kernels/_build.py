"""Build the CUDA kernels with ``nvcc`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes) under ``<repo>/build/kernels/``, named by a hash of its source,
the shared ``csrc/*.cuh`` headers and the flags, so an edited source or
header rebuilds.  :func:`build` starts one ``nvcc`` per
source that is not built yet, all at once, and waits for them together.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`Kernel.launch` raises when that is not 0
(a refused launch never runs, and a later synchronise would not report
it).  Each :class:`Kernel` keeps a plain integer count of its launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
#: build outputs live beside the checkout, in a directory .gitignore lists
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "built on the machine with the card"
        )
    return path


class Kernel:
    """One CUDA source: its build, its C entry point and its launch count.

    ``argtypes`` are the ctypes types of the entry point's arguments, the
    trailing stream pointer excluded.  ``launches`` counts every
    successful :meth:`launch`; nothing else touches it but a caller that
    resets it to 0.
    """

    def __init__(self, name: str, argtypes: Sequence, *, replaces: str):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.replaces = replaces
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None
        self.build_log = ""

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):  # shared by the sources
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = h.hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def _bind(self):
        if self._fn is not None:
            return
        build([self])
        lib = ctypes.CDLL(str(self.library))
        fn = getattr(lib, f"{self.name}_launch")
        fn.argtypes = self.argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib = lib
        self._fn = (fn, err)

    def call(self, name: str, argtypes: Sequence, *args) -> None:
        """Call the library's C function ``name`` (an int return, 0 on
        success) with ``args`` of ``argtypes``; raise on a nonzero return.
        Not a launch: the count does not move."""
        self._bind()
        fn = getattr(self._lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{name} failed: error {rc} "
                               f"({self._fn[1](rc).decode()})")

    def launch(self, *args, stream: int):
        """Launch on ``stream`` (a ``cudaStream_t`` as an int); raise on a
        nonzero ``cudaGetLastError()``, else count the launch."""
        self._bind()
        fn, err = self._fn
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: error {rc} "
                f"({err(rc).decode()})"
            )
        self.launches += 1


def build(kernels: Iterable[Kernel]) -> List[Kernel]:
    """Compile every kernel whose library is missing, all ``nvcc`` runs in
    parallel; raise with the compiler's output if any fails.  Returns the
    kernels that were compiled (their ``build_log`` holds ``-Xptxas -v``)."""
    todo = [k for k in kernels if not k.library.exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for k in todo:
        tmp = k.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        procs.append((k, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for k, tmp, proc in procs:
        out, _ = proc.communicate()
        k.build_log = out
        if proc.returncode != 0:
            failed.append(f"{k.source.name} (rc={proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, k.library)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return todo
