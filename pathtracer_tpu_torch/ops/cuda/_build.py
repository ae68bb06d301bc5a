"""Build-and-load helper shared by the port's native sources.

Each source is compiled at first use into a shared library with a plain C
interface under the gitignored ``pathtracer_tpu_torch/build/``, named by a
hash of the source and the flags, and loaded with ctypes. A library that
is already there is reused; concurrent builds agree, as each writes a
temporary file and renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

# -fmad=false: eager PyTorch never fuses a*b + c, so neither may the
# kernels, or they stop matching their plain versions bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build_library(source: str, compiler: str, flags: tuple,
                  verbose: bool = False) -> str:
    """Compile ``source`` with ``compiler`` and ``flags`` into BUILD_DIR
    unless a library of the same source and flags is already there.
    Returns the library's path."""
    with open(source, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{key}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags]
    if verbose and compiler.endswith("nvcc"):
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, source]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed "
                               f"({res.returncode}):\n{res.stdout}\n"
                               f"{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_cuda(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>`` with nvcc for sm_90a. Returns its path."""
    return build_library(os.path.join(CSRC_DIR, name), nvcc(), NVCC_FLAGS,
                         verbose=verbose)


def load_cuda(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>``, declaring each C
    function's argument types; every function returns an int error code
    (0 = cudaSuccess)."""
    lib = ctypes.CDLL(build_cuda(name))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def stream_of(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
