"""Build, load and launch helpers shared by the port's native sources.

Each source is compiled at first use into a shared library with a plain C
interface under the gitignored ``pathtracer_tpu_torch/build/``, named by a
hash of the source and the flags, and loaded with ctypes. A library that
is already there is reused; concurrent builds agree, as each writes a
temporary file and renames it into place.

Every kernel wrapper goes through ``check`` (its tensors, in one pass) and
``launch`` (the C launcher on PyTorch's current stream). The launch path is
the host's cost of every call, so it does the least it can: each C
function is resolved once, at load; the stream's raw handle comes from
``torch._C._cuda_getCurrentRawStream`` (what ``torch.compile``'s generated
code calls), not from a ``torch.cuda.Stream`` built per call; a device
guard is entered only for a tensor that is not on the current device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

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
            print(" ".join(cmd) + "\n" + res.stdout + res.stderr, flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_cuda(name: str, verbose: bool = False, defines: tuple = ()) -> str:
    """Compile ``csrc/<name>`` with nvcc for sm_90a, with ``-D`` for each
    of ``defines`` ("NAME=value": a source's tuning constants). Returns its
    path."""
    return build_library(os.path.join(CSRC_DIR, name), nvcc(),
                         NVCC_FLAGS + tuple(f"-D{d}" for d in defines),
                         verbose=verbose)


def load_cuda(name: str, signatures: dict, defines: tuple = ()) -> dict:
    """Build (if needed) and load ``csrc/<name>``, and resolve each C
    launcher of ``signatures`` ({name: argument types, the stream last})
    once. Every launcher returns an int error code (0 = cudaSuccess).
    Returns {name: ctypes function}."""
    lib = ctypes.CDLL(build_cuda(name, defines=defines))
    fns = {}
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[fn_name] = fn
    return fns


def check(what: str, tensors: dict, dtypes) -> torch.device:
    """One pass over ``tensors`` ({name: tensor}, the first one's device
    the reference): each must be a torch.Tensor of its dtype (``dtypes``:
    one dtype, or {name: dtype}) on that device, and contiguous on a CUDA
    device; the device must be cpu or cuda. Returns the device."""
    dev = None
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        want = dtypes if isinstance(dtypes, torch.dtype) else dtypes[name]
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        # is_cuda / is_cpu: torch.device.type costs several times more
        if dev is None:
            dev, cuda = x.device, x.is_cuda
            if not (cuda or x.is_cpu):
                raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
        elif x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if cuda and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def launch(fn, what: str, dev: torch.device, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on PyTorch's current
    stream of CUDA device ``dev``; raise if the launch reports an error."""
    index = dev.index
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
