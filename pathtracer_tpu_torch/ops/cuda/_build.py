"""Build, load and launch helpers shared by the port's native sources.

Each source is compiled at first use into a shared library under the
gitignored ``pathtracer_tpu_torch/build/``, named by a hash of the source
and the flags. A library that is already there is reused; concurrent
builds agree, as each writes a temporary file and renames it into place.

A CUDA source exports plain C launchers (``pt_<kernel>_launch``). They are
called through ``csrc/pylaunch.c``, a CPython module of one METH_FASTCALL
function per launcher signature, built with the host C compiler against
Python's own headers (no PyTorch headers: it builds in a second or two).
``bind`` resolves each launcher's address once, when its library is
loaded; a launcher is then the pair (trampoline, address).

Every kernel wrapper checks its tensors with a fast test of the case it
launches for (dtype by identity, ``get_device()``, ``is_contiguous()``,
its shapes) and, only where that test fails, with ``check`` (one pass
that raises the error for what is wrong, or finds CPU tensors);
``device`` does both for a wrapper whose inputs are (N, width) rows and
tensors of fixed shape. Then it calls ``launch``, which runs the
launcher on PyTorch's current stream. The launch path is the host's cost
of every call, so it does the least it can: the stream's raw handle
comes from
``torch._C._cuda_getCurrentRawStream`` (what ``torch.compile``'s generated
code calls), and a device guard is entered only for a tensor that is not
on the current device. Each wrapper calls ``launch`` itself, with no
helper frame between them, and ``launch`` counts the launch in the
wrapper module's ``LAUNCHES`` (``counted``); a wrapper counts more of a
launch, such as the bytes it moves, through ``count``. A CUDA graph's
capture launches nothing: inside ``capturing`` the launches and counts
are tallied instead, and each replay of the graph counts the tally
(``replayed``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import tempfile

import torch

from ...utils.spans import span

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
    Returns the library's path. The compiler's output is kept beside the
    library (``report_path``); an nvcc build asks ptxas for its report
    (registers, spills) in it. ``verbose`` prints the command and the
    output."""
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
    if compiler.endswith("nvcc"):
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
        with open(tmp + ".txt", "w") as fh:
            fh.write(res.stdout + res.stderr)
        os.replace(tmp + ".txt", report_path(out))
        os.replace(tmp, out)
    finally:
        for path in (tmp, tmp + ".txt"):
            if os.path.exists(path):
                os.remove(path)
    return out


def report_path(library: str) -> str:
    """Where ``build_library`` keeps the compiler's report of
    ``library``."""
    return os.path.splitext(library)[0] + ".report.txt"


def ptxas_report(library: str) -> dict:
    """Registers, static shared memory and spills of each kernel of an
    nvcc-built ``library``, from the ptxas report kept beside it: {mangled
    kernel name: dict(registers, smem, stack, spill_stores, spill_loads)}
    (bytes but the registers). Empty where the library was built
    elsewhere."""
    path = report_path(library)
    if not os.path.exists(path):
        return {}
    kernels, name = {}, None
    with open(path) as fh:
        for line in fh:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
                kernels[name] = {}
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                kernels[name].update(stack=int(m.group(1)),
                                     spill_stores=int(m.group(2)),
                                     spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels[name]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                kernels[name]["smem"] = int(m.group(1)) if m else 0
    return kernels


def build_cuda(name: str, verbose: bool = False, defines: tuple = ()) -> str:
    """Compile ``csrc/<name>`` with nvcc for sm_90a, with ``-D`` for each
    of ``defines`` ("NAME=value": a source's tuning constants). Returns its
    path."""
    return build_library(os.path.join(CSRC_DIR, name), nvcc(),
                         NVCC_FLAGS + tuple(f"-D{d}" for d in defines),
                         verbose=verbose)


def macro(name: str, define: str) -> int:
    """A tuning constant of a source's default build: the value of
    ``#define <define>`` in ``csrc/<name>``."""
    with open(os.path.join(CSRC_DIR, name)) as fh:
        return int(re.search(rf"#define {define} (\d+)", fh.read()).group(1))


def load_cuda(name: str, signatures: dict, defines: tuple = ()) -> dict:
    """Build (if needed) and load ``csrc/<name>``, and bind the launcher of
    each kernel of ``signatures`` (as ``bind``). Returns {kernel:
    launcher}."""
    return bind(build_cuda(name, defines=defines), signatures)


def load_extension(path: str):
    """Load the CPython module ``pylaunch`` (``csrc/pylaunch.c``) from the
    library at ``path``."""
    loader = importlib.machinery.ExtensionFileLoader("pylaunch", path)
    module = importlib.util.module_from_spec(
        importlib.util.spec_from_loader("pylaunch", loader))
    loader.exec_module(module)
    return module


def build_pylaunch() -> str:
    """Compile ``csrc/pylaunch.c`` with ``cc`` against this interpreter's
    headers into BUILD_DIR (once). Returns its path; a failed build
    raises."""
    include = sysconfig.get_paths()["include"]
    return build_library(os.path.join(CSRC_DIR, "pylaunch.c"), "cc",
                         ("-O2", "-shared", "-fPIC", f"-I{include}"))


_pylaunch = None


def pylaunch():
    """The trampoline module, built (``build_pylaunch``) and loaded once."""
    global _pylaunch
    if _pylaunch is None:
        _pylaunch = load_extension(build_pylaunch())
    return _pylaunch


def bind(path: str, signatures: dict) -> dict:
    """Load the shared library at ``path`` and resolve the C launcher
    ``pt_<kernel>_launch`` of each kernel of ``signatures`` ({kernel:
    signature}) once. A signature has one letter an argument (p a pointer,
    i an int, f a float; the stream last) and names the trampoline of
    ``csrc/pylaunch.c`` that calls the launcher. Every launcher returns an
    int error code (0 = cudaSuccess). Returns {kernel: (trampoline,
    address)}; ctypes never unloads a library, so the addresses stay
    valid."""
    lib, tramp = ctypes.CDLL(path), pylaunch()
    return {kernel: (getattr(tramp, sig), ctypes.cast(
        getattr(lib, f"pt_{kernel}_launch"), ctypes.c_void_p).value)
        for kernel, sig in signatures.items()}


def check(what: str, tensors: dict, dtypes) -> int:
    """One pass over ``tensors`` ({name: tensor}, the first one's device
    the reference): each must be a torch.Tensor of its dtype (``dtypes``:
    one dtype, or {name: dtype}) on that device, and contiguous on a CUDA
    device; the device must be cpu or cuda. Raises for the first that is
    not. Returns the CUDA device's index, or -1 for CPU tensors."""
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
    return dev.index if cuda else -1


def fits(tensors: dict, widths: dict, dtypes) -> bool:
    """Whether ``tensors`` ({name: tensor}) are laid out as a kernel takes
    them: each of its dtype (``dtypes``: one dtype, or {name: dtype}), on
    the first one's device, contiguous, and of its shape in ``widths``
    ({name: the width of its (N, width) rows, N the first tensor's; or its
    whole shape, a tuple}; a name not there may have any shape). A value
    that is not a tensor raises AttributeError."""
    first = next(iter(tensors.values()))
    dev, n = first.get_device(), first.shape[0] if first.dim() else -1
    one = isinstance(dtypes, torch.dtype)
    for name, t in tensors.items():
        if not (t.dtype is (dtypes if one else dtypes[name])
                and t.get_device() == dev and t.is_contiguous()):
            return False
        want = widths.get(name)
        if want is None:
            continue
        if isinstance(want, int):
            if t.dim() != 2 or t.shape[0] != n or t.shape[1] != want:
                return False
        elif t.shape != want:
            return False
    return True


def device(what: str, tensors: dict, widths: dict, dtypes=torch.float32,
           shapes_ok: bool = True) -> int:
    """The CUDA device index of a kernel call on ``tensors`` (``fits``,
    and ``shapes_ok``: the wrapper's own test of shapes ``widths`` cannot
    state), -1 for CPU tensors (the plain twin); raise for what the
    kernel cannot take: a type, device or layout (``check``), else the
    shapes."""
    first = next(iter(tensors.values()))
    try:  # the case a launch takes
        if first.is_cuda and shapes_ok and fits(tensors, widths, dtypes):
            return first.get_device()
    except AttributeError:  # not a tensor
        pass
    if all(isinstance(t, torch.Tensor) and t.is_cpu
           for t in tensors.values()):
        return -1
    check(what, tensors, dtypes)
    raise ValueError(f"{what}: shapes the kernel cannot take: " + ", ".join(
        f"{name} {tuple(t.shape)}" for name, t in tensors.items()))


# PyTorch's current CUDA device and the raw handle of a device's current
# stream (absent from a CPU-only build of PyTorch, where nothing launches)
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


# the module whose ``LAUNCHES`` counts each kernel, by the name it
# launches under, and of each other count the module that keeps it
# (``counted``); the counter a count adds to, where not ``LAUNCHES``
_COUNTERS: dict = {}
_ATTRS: dict = {}
# the launches of the CUDA graph being captured, by kernel; None while
# none is (``capturing``)
_tally = None


def counted(module: str, kernels, attr: str = "LAUNCHES") -> None:
    """Count each launch of ``kernels`` (their names) in ``LAUNCHES`` of
    the module named ``module``: an int where it launches one kernel,
    else a dict by kernel. With ``attr``, ``kernels`` name counts of the
    module's counter ``attr`` instead, that ``count`` adds to."""
    for what in kernels:
        _COUNTERS[what] = module
        if attr != "LAUNCHES":
            _ATTRS[what] = attr


def _count(what: str, n: int) -> None:
    module = _COUNTERS.get(what)
    if module is None:  # a launcher no wrapper module counts
        return
    mod = sys.modules[module]
    attr = _ATTRS.get(what, "LAUNCHES")
    counter = getattr(mod, attr)
    if isinstance(counter, dict):
        counter[what] += n
    else:
        setattr(mod, attr, counter + n)


def count(what: str, n: int) -> None:
    """Add ``n`` to the count ``what`` (``counted``), or to the tally of
    the CUDA graph being captured (``capturing``)."""
    if _tally is None:
        _count(what, n)
    else:
        _tally[what] = _tally.get(what, 0) + n


@contextlib.contextmanager
def capturing():
    """Inside, launches and counts are tallied and not counted, as a CUDA
    graph's capture launches nothing. Yields the tally ({kernel or count:
    number}) that each replay of the graph counts (``replayed``)."""
    global _tally
    _tally = tally = {}
    try:
        yield tally
    finally:
        _tally = None


def replayed(tally: dict) -> None:
    """Count the launches of one replay of a graph whose capture tallied
    ``tally``."""
    for what, n in tally.items():
        _count(what, n)


def launch(fn, what: str, index: int, *args) -> None:
    """Call the C launcher ``fn`` (from ``bind``) with ``(*args, stream)``
    on PyTorch's current stream of CUDA device ``index``, inside the span
    ``pt::k:<what>``, which holds the launch's runtime call; raise if the
    launch reports an error, else count it (``counted``, ``capturing``)."""
    call, address = fn
    with span("pt::k:" + what):
        if index == _current_device():
            err = call(address, *args, _raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = call(address, *args, _raw_stream(index))
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    if _tally is None:
        _count(what, 1)
    else:
        _tally[what] = _tally.get(what, 0) + 1
