"""Build and bind the port's hand-written Hopper kernels.

Each kernel is one CUDA C++ source with a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` into a shared library, loaded with ``ctypes``
(seconds to build, where a source that includes PyTorch's headers takes
minutes).  Libraries go into ``.torch_ext_build/`` at the root of the
checkout, named by a hash of the source and the flags, and are built at
first use: importing this module builds nothing.

A library exports ``<name>_error_string(int)``; its launch functions
return the CUDA error of the launch, and :meth:`KernelLibrary.call` raises
on any that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# A block may use at most 227 KB of shared memory on Hopper.
MAX_SMEM_BYTES = 232_448


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / ".torch_ext_build"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels "
                       "are built from their .cu sources at first use")


def check_smem(need: int, what: str) -> None:
    """Refuse a launch whose shared memory exceeds one block's limit."""
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"{what} needs {need} bytes of shared memory, over the "
            f"{MAX_SMEM_BYTES}-byte limit of one block")


class KernelLibrary:
    """One ``.cu`` source, its library and its C functions.

    ``signatures`` maps each exported launch function to its ctypes
    argument types; every one returns an ``int`` CUDA error code.
    """

    def __init__(self, name: str, source: Path,
                 signatures: dict[str, list]):
        self.name = name
        self.source = source
        self.signatures = signatures
        self._lib: ctypes.CDLL | None = None

    def path(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes()
                             + " ".join(ARCH_FLAGS).encode()).hexdigest()[:16]
        return build_dir() / f"lib{self.name}_{tag}.so"

    def _command(self, out: Path, verbose: bool) -> list[str]:
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(out), str(self.source)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        return cmd

    def build(self, verbose: bool = False) -> tuple[Path, str]:
        """Compile unless a library of the same source exists.

        Returns ``(library path, compiler output)``; with ``verbose`` the
        output carries ``ptxas``'s register and shared-memory report.
        """
        return build_all([self], verbose)[0]

    def library(self) -> ctypes.CDLL:
        """The loaded library (built on first call)."""
        if self._lib is None:
            path, _ = self.build()
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in self.signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err_fn = getattr(lib, f"{self.name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, fn_name: str, *args) -> None:
        """Call a launch function; raise if the launch was refused."""
        lib = self.library()
        err = getattr(lib, fn_name)(*args)
        if err != 0:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} "
                               f"({err})")


def build_all(libs: list[KernelLibrary], verbose: bool = False,
              ) -> list[tuple[Path, str]]:
    """Build several libraries at once: one ``nvcc`` per source, all
    started together.  Returns ``(path, compiler output)`` per library and
    raises, naming the source, if any build fails."""
    out_dir = build_dir()
    jobs, started = [], set()
    for kl in libs:
        lib = kl.path()
        # a library already built, or being built for an identical source
        if (lib.exists() and not verbose) or lib in started:
            jobs.append((kl, lib, None, None))
            continue
        started.add(lib)
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".{lib.name}.{os.getpid()}.tmp"
        proc = subprocess.Popen(kl._command(tmp, verbose),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((kl, lib, tmp, proc))
    results, failed = [], []
    for kl, lib, tmp, proc in jobs:
        if proc is None:
            results.append((lib, ""))
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {kl.source.name} "
                          f"({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        results.append((lib, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return results
