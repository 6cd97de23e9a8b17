"""Build the hand-written CUDA kernels at first use, then dlopen them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``. The library
is named after a hash of its source and the compiler flags, so a stale
build is never loaded. The build goes under ``build/luminoth_tpu_torch/``
beside the package (the directory ``.gitignore`` lists).

A failed build raises: there is no fallback to the plain PyTorch version.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "luminoth_tpu_torch"

# -fmad=false: the kernels replay the plain versions' float arithmetic
# operation by operation (an IoU that lands exactly on the NMS threshold
# must not flip), so nvcc may not contract a multiply and an add into an FMA.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false",
)

_LOCK = threading.Lock()
_NAME_LOCKS = {}  # one per library: different sources build in parallel
_LIBS = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of luminoth_tpu_torch cannot be built"
        )
    return found


def library_path(name):
    """Where ``csrc/<name>.cu`` is built, named by a hash of its inputs."""
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load(name, configure):
    """Build (if needed) and load ``csrc/<name>.cu``; memoized per name.

    ``configure(lib)`` declares the ctypes ``argtypes``/``restype``.
    Loads of different names may run in parallel threads.
    """
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name not in _LIBS:
            path = library_path(name)
            if not path.exists():
                _compile(CSRC_DIR / f"{name}.cu", path)
            lib = ctypes.CDLL(str(path))
            configure(lib)
            _LIBS[name] = lib
        return _LIBS[name]


def _compile(source, path):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def check_status(lib, status, what):
    """Raise if a C entry point of ``lib`` returned a ``cudaError_t`` != 0."""
    if status != 0:
        message = lib.lumi_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({message})")
