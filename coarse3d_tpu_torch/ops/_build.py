"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source ``csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use into ``coarse3d_tpu_torch/build/lib<name>_<hash>.so``
(a directory git ignores), keyed on a hash of the source and the flags:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC [per-kernel flags] -o lib<name>_<hash>.so <name>.cu

The same pattern as the JAX package's ``native/`` host library, with one
difference: nothing here degrades. A missing nvcc or a failed build raises;
there is no CPU fallback for a CUDA tensor. ``build_all`` starts one nvcc per
source at once, so a fresh checkout builds in the time of the slowest file.
The ptxas report (registers, spills) of each build is kept beside the
library as ``lib<name>_<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.access(cand, os.X_OK):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
            "are built from csrc/ at first use and need the CUDA toolkit")
    return nvcc


class KernelLibrary:
    """One ``csrc/<name>.cu`` source, built at first ``load()``.

    ``bind`` sets the ctypes signatures of the loaded library. Building and
    loading happen only when a CUDA tensor first reaches the kernel, never at
    import, so the CPU tests import every module without nvcc.
    """

    def __init__(self, name: str, bind, extra_flags: tuple[str, ...] = ()):
        self.name = name
        self.source = os.path.join(CSRC_DIR, f"{name}.cu")
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self._bind = bind
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        self.build_s: float | None = None   # nvcc's wall seconds, if it ran

    @property
    def lib_path(self) -> str:
        h = hashlib.sha256()
        with open(self.source, "rb") as f:
            h.update(f.read())
        h.update(" ".join(self.flags).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}_{h.hexdigest()[:16]}.so")

    @property
    def log_path(self) -> str:
        return self.lib_path[:-3] + ".log"

    def start_build(self) -> subprocess.Popen | None:
        """Start nvcc if the library is not built yet; None when it is."""
        out = self.lib_path
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *self.flags, "-o", tmp, self.source]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp_path = tmp  # type: ignore[attr-defined]
        proc.t0 = time.perf_counter()  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: subprocess.Popen | None) -> str | None:
        """Wait for nvcc; return its error report if it failed, else None."""
        if proc is None:
            return None
        log, _ = proc.communicate()
        self.build_s = time.perf_counter() - proc.t0  # type: ignore
        with open(self.log_path, "w") as f:
            f.write(log)
        if proc.returncode != 0:
            return f"nvcc failed ({proc.returncode}) on {self.source}:\n{log}"
        os.replace(proc.tmp_path, self.lib_path)  # type: ignore[attr-defined]
        return None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    error = self.finish_build(self.start_build())
                    if error:
                        raise RuntimeError(error)
                    lib = ctypes.CDLL(self.lib_path)
                    self._bind(lib)
                    self._lib = lib
        return self._lib


def build_all(libraries: list[KernelLibrary]) -> None:
    """Compile every library that is not built yet, all nvcc runs at once,
    then load each. Waits for every nvcc before raising on a failed one;
    each library's ``build_s`` is its own nvcc's wall time."""
    procs = [(lib, lib.start_build()) for lib in libraries]
    results: list[str | None] = [None] * len(procs)

    def finish(i: int) -> None:
        results[i] = procs[i][0].finish_build(procs[i][1])

    waiters = [threading.Thread(target=finish, args=(i,))
               for i in range(len(procs))]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    errors = [e for e in results if e]
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        lib.load()


def launch_check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the device of tensor ``t``."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
