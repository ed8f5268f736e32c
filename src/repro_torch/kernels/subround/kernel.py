"""Build and bind the Hopper subround kernel (``kernel.cu``).

``nvcc`` compiles the source for ``sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes`` (seconds to build, where a
source that includes PyTorch's headers takes minutes).  The library goes
into ``.torch_ext_build/`` at the root of the checkout, named by a hash of
the source, and is built at first use: importing this module builds
nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).with_name("kernel.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# A block may use at most 227 KB of shared memory on Hopper.
MAX_SMEM_BYTES = 232_448

_lib: ctypes.CDLL | None = None


def build_dir() -> Path:
    return Path(__file__).resolve().parents[4] / ".torch_ext_build"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the subround kernel "
                       "is built from kernel.cu at first use")


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``kernel.cu`` unless a library of the same source exists.

    Returns ``(library path, compiler output)``; with ``verbose`` the
    output carries ``ptxas``'s register and shared-memory report.
    """
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(ARCH_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    lib = out_dir / f"libsubround_{tag}.so"
    if lib.exists() and not verbose:
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for fn in (lib.subround_launch, lib.subround_empty_launch):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.subround_error_string.argtypes = [ctypes.c_int]
        lib.subround_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(b: int, c: int, s: int, f: int) -> int:
    """Shared memory one launch needs (mirrors ``smem_bytes`` in
    ``kernel.cu``)."""
    return 4 * (b + c * (18 + f + s) + 1)


def launch(ptrs: list[int], b: int, c: int, s: int, f: int, j: int,
           stream: int, empty: bool = False) -> None:
    """Launch on ``stream``; ``ptrs`` are the 31 input then 32 output
    device addresses.  Raises if the launch is refused.  ``empty`` launches
    a kernel that does nothing, with the same parameters, block and shared
    memory, to time the launch floor."""
    need = smem_bytes(b, c, s, f)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"subround kernel: B={b}, C={c}, S={s}, F={f} needs {need} bytes "
            f"of shared memory, over the {MAX_SMEM_BYTES}-byte limit of one "
            f"block (B + C*(18+F+S) + 1 must stay <= {MAX_SMEM_BYTES // 4})")
    lib = library()
    arr = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    fn = lib.subround_empty_launch if empty else lib.subround_launch
    err = fn(arr, b, c, s, f, j, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.subround_error_string(err).decode()
        raise RuntimeError(f"subround kernel launch failed: {msg} ({err})")
