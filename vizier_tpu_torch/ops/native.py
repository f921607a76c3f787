"""Builds the CUDA sources under ``csrc/`` and binds them with ctypes.

The kernels have a plain C interface, so ``nvcc`` compiles them in seconds
into a shared library with no PyTorch headers; PyTorch's own extension
builder would compile a binding file against its headers for minutes on
every fresh machine. The library is built at first use into
``build/vizier_tpu_torch_kernels/`` beside the package (git-ignored), or into
the directory :func:`set_build_dir` names (the serving config's
``compilation_cache_dir``), named by a hash of the source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is: that
directory is the port's compile cache across processes.

Nothing here runs at import time: the CPU path never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PACKAGE / "csrc" / "matern52.cu"
BUILD_DIR = _PACKAGE.parent / "build" / "vizier_tpu_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


def _nvcc() -> str:
    from torch.utils import cpp_extension

    candidates = []
    if cpp_extension.CUDA_HOME:
        candidates.append(os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit.")


def build(source: pathlib.Path, build_dir: pathlib.Path) -> ctypes.CDLL:
    """Builds ``source`` with ``NVCC_FLAGS`` into ``build_dir`` (unless a
    library of the same source and flags is there) and loads it. The result
    carries ``build_seconds`` and ``build_log`` (ptxas' register report)."""
    text = source.read_bytes()
    digest = hashlib.sha256(text + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    target = build_dir / f"lib{source.stem}_{digest}.so"
    log = ""
    start = time.perf_counter()
    if not target.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        partial = target.with_name(f"{target.name}.{os.getpid()}.part")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(partial, target)
        log = proc.stderr
    lib = ctypes.CDLL(str(target))
    lib.build_seconds = time.perf_counter() - start
    lib.build_log = log
    return lib


_build_dir = BUILD_DIR


def set_build_dir(path) -> pathlib.Path:
    """Makes ``path`` (None: :data:`BUILD_DIR`) the directory :func:`library`
    builds into and loads from. A library already loaded in this process
    stays loaded: the directory applies to the first load and to later
    processes."""
    global _build_dir
    _build_dir = pathlib.Path(path).expanduser().resolve() if path else BUILD_DIR
    return _build_dir


def build_dir() -> pathlib.Path:
    """The directory :func:`library` builds into and loads from."""
    return _build_dir


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on first call)."""
    lib = build(_SOURCE, _build_dir)
    lib.matern52_bwd_num_blocks.argtypes = [_I] * 4
    lib.matern52_bwd_num_blocks.restype = _I
    # kernel (0 K1, 1 K2), B, N, M, symmetric; out: tile rows, cols, threads.
    lib.matern52_occupancy.argtypes = [_I] * 5 + [_P] * 3
    lib.matern52_occupancy.restype = _I
    # tile kind (0 big, 1 tiny; -1 chosen by shape).
    lib.matern52_force_tile.argtypes = [_I]
    lib.matern52_force_tile.restype = _I
    # x1, z1, x2, z2, amp, inv_c, inv_s, mask1, mask2, diag; group strides of
    # x1, x2, z1, z2, mask1, mask2; group, B, N, M, Dc, Ds, symmetric; out,
    # stream.
    lib.matern52_ard_fwd.argtypes = [_P] * 10 + [_L] * 6 + [_I] * 7 + [_P, _P]
    lib.matern52_ard_fwd.restype = _I
    # gk, x1, z1, x2, z2, amp, inv_c, inv_s, mask1, mask2; group strides as
    # in the forward; group, B, N, M, Dc, Ds, symmetric; grads, partials
    # (both null: features only), gx1, gx2, stream.
    lib.matern52_ard_bwd.argtypes = [_P] * 10 + [_L] * 6 + [_I] * 7 + [_P] * 5
    lib.matern52_ard_bwd.restype = _I
    return lib


def check(status: int, what: str) -> None:
    """Raises when a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch.")
