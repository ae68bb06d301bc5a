"""The CPython launch module (``csrc/pylaunch.c``) on the CPU.

Each trampoline is built here with the host C compiler beside a stand-in
launcher of its signature that records what arrives and returns a code
the test sets. No card is needed: the trampolines call any C function of
their prototype. The kernels themselves are held to their plain versions
through this path in ``tests/test_torch_cuda.py``.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import sysconfig
import types

import pytest

from pathtracer_tpu_torch.ops.cuda import (_build, bsdf_cu, bvhw_cu,
                                           env_cu, intersect_cu, sobol_cu,
                                           texture_cu)
from pathtracer_tpu_torch.probes import gather, gather2

SIGS = ("ppiipp", "ppipp", "ppiiipp", "ppppiiifffppppp", "ppppiiiiffffppppp",
        "ppppppiippppiiipp", "pppppppifppppp",
        "pipiipiipipiipiipipipippppppiipppp",
        "pipiipiipipiipiipipipippppppiippppppp", "ppppppiiiippp",
        "ppppiiiipp", "ppppppiiiiippp", "pppppppppiiiiipppp")
MODULES = (intersect_cu, bvhw_cu, texture_cu, bsdf_cu, sobol_cu, env_cu,
           gather, gather2)
# slots of the stand-ins' records: the longest signature's arguments
SLOTS = max(len(sig) for sig in SIGS)
CTYPE = {"p": "void*", "i": "int", "f": "float"}
SEEN = {"p": "seen_p[{k}] = (uintptr_t)a{k};", "i": "seen_i[{k}] = a{k};",
        "f": "seen_f[{k}] = a{k};"}


def _stand_ins() -> str:
    """C launchers ``pt_<sig>_launch`` that store their arguments by
    position in seen_p / seen_i / seen_f and return ``ret_code``."""
    lines = ["#include <stdint.h>", f"uint64_t seen_p[{SLOTS}];",
             f"int seen_i[{SLOTS}];", f"float seen_f[{SLOTS}];",
             "int ret_code;"]
    for sig in SIGS:
        params = ", ".join(f"{CTYPE[c]} a{k}" for k, c in enumerate(sig))
        body = " ".join(SEEN[c].format(k=k) for k, c in enumerate(sig))
        lines.append(f"int pt_{sig}_launch({params}) {{ {body} "
                     "return ret_code; }")
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The trampoline source and the stand-ins in one library, loaded
    both as the extension module and with ctypes (one dlopen handle)."""
    include = sysconfig.get_paths()["include"]
    if shutil.which("cc") is None or not os.path.exists(
            os.path.join(include, "Python.h")):
        pytest.skip("needs a C compiler and Python's headers")
    tmp = tmp_path_factory.mktemp("pylaunch")
    stand_ins = tmp / "stand_ins.c"
    stand_ins.write_text(_stand_ins())
    lib = tmp / "pylaunch_test.so"
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", f"-I{include}", "-o",
                    str(lib), os.path.join(_build.CSRC_DIR, "pylaunch.c"),
                    str(stand_ins)], check=True, capture_output=True)
    return _build.load_extension(str(lib)), ctypes.CDLL(str(lib))


def _args(sig):
    """Pointers above 2**32 (and 0, and the top of the 64-bit range),
    negative ints and the int limits, floats of both signs."""
    ptrs = [(1 << 32) + 0x1234, (1 << 47) - 8, (1 << 64) - 16, 0,
            0x7F00_0000_1000]
    ints = [-7, -(1 << 31), (1 << 31) - 1, 0]
    floats = [1.1920928955078125e-07, -2.5, 3.0e38, -0.0]
    out, counts = [], {"p": 0, "i": 0, "f": 0}
    for c in sig:
        src = {"p": ptrs, "i": ints, "f": floats}[c]
        out.append(src[counts[c] % len(src)])
        counts[c] += 1
    return out


@pytest.mark.parametrize("sig", SIGS)
def test_trampoline_passes_every_argument_intact(built, sig):
    mod, lib = built
    addr = ctypes.cast(getattr(lib, f"pt_{sig}_launch"),
                       ctypes.c_void_p).value
    seen_p = (ctypes.c_uint64 * SLOTS).in_dll(lib, "seen_p")
    seen_i = (ctypes.c_int * SLOTS).in_dll(lib, "seen_i")
    seen_f = (ctypes.c_float * SLOTS).in_dll(lib, "seen_f")
    ctypes.c_int.in_dll(lib, "ret_code").value = 0
    args = _args(sig)
    assert getattr(mod, sig)(addr, *args) == 0
    for k, (c, want) in enumerate(zip(sig, args)):
        got = {"p": seen_p, "i": seen_i, "f": seen_f}[c][k]
        if c == "f":  # a C float: the double rounded once
            want = ctypes.c_float(want).value
        assert got == want, (sig, k, got, want)
    ctypes.c_int.in_dll(lib, "ret_code").value = -3
    assert getattr(mod, sig)(addr, *args) == -3


def test_trampoline_rejects_bad_arguments(built):
    mod, lib = built
    addr = ctypes.cast(lib.pt_ppipp_launch, ctypes.c_void_p).value
    ok = [1 << 40, 8, 5, 16, 0]
    with pytest.raises(TypeError, match="takes 6 arguments.*got 5"):
        mod.ppipp(addr, *ok[:4])
    with pytest.raises(OverflowError, match="C int"):
        mod.ppipp(addr, 1, 2, 1 << 31, 3, 4)
    with pytest.raises(TypeError):
        mod.ppipp(addr, 1.5, 2, 3, 4, 5)  # a float for a pointer
    with pytest.raises(TypeError):
        mod.ppipp(addr, None, 2, 3, 4, 5)  # NULL is 0, not None
    with pytest.raises(ValueError, match="address is 0"):
        mod.ppipp(0, *ok)


def test_launch_raises_on_a_nonzero_code(built, monkeypatch):
    """``_build.launch`` passes the current stream last and turns a
    launcher's nonzero return into RuntimeError."""
    mod, lib = built
    fn = (mod.ppipp, ctypes.cast(lib.pt_ppipp_launch, ctypes.c_void_p).value)
    stream = (1 << 45) + 0x40
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: stream)
    ret = ctypes.c_int.in_dll(lib, "ret_code")
    seen_p = (ctypes.c_uint64 * SLOTS).in_dll(lib, "seen_p")
    ret.value = 0
    assert _build.launch(fn, "probe", 0, 1 << 33, 2, 7, 3) is None
    assert seen_p[4] == stream
    ret.value = 700
    with pytest.raises(RuntimeError,
                       match="probe kernel launch failed: CUDA error 700"):
        _build.launch(fn, "probe", 0, 1 << 33, 2, 7, 3)


def test_launch_counts_and_a_capture_tallies(built, monkeypatch):
    """``_build.launch`` counts each launch in its module's ``LAUNCHES``
    (an int, or a dict by kernel); inside ``capturing`` it tallies the
    launches instead, and ``replayed`` counts the tally once a replay. A
    failed launch counts nothing."""
    mod, lib = built
    fn = (mod.ppipp, ctypes.cast(lib.pt_ppipp_launch, ctypes.c_void_p).value)
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 1 << 45)
    ret = ctypes.c_int.in_dll(lib, "ret_code")
    one = types.ModuleType("one_kernel")
    one.LAUNCHES = 0
    two = types.ModuleType("two_kernels")
    two.LAUNCHES = {"probe_a": 0, "probe_b": 0}
    for m in (one, two):
        monkeypatch.setitem(sys.modules, m.__name__, m)
    monkeypatch.setattr(_build, "_COUNTERS", {})
    _build.counted("one_kernel", {"probe": "ppipp"})
    _build.counted("two_kernels", ("probe_a", "probe_b"))
    ret.value = 0
    args = (1 << 33, 2, 7, 3)
    for what in ("probe", "probe_b", "probe_b", "unlisted"):
        _build.launch(fn, what, 0, *args)
    assert one.LAUNCHES == 1 and two.LAUNCHES == dict(probe_a=0, probe_b=2)
    with _build.capturing() as tally:
        _build.launch(fn, "probe", 0, *args)
        _build.launch(fn, "probe_a", 0, *args)
        _build.launch(fn, "probe", 0, *args)
    assert tally == dict(probe=2, probe_a=1) and _build._tally is None
    assert one.LAUNCHES == 1 and two.LAUNCHES == dict(probe_a=0, probe_b=2)
    for _ in range(3):
        _build.replayed(tally)
    assert one.LAUNCHES == 7 and two.LAUNCHES == dict(probe_a=3, probe_b=2)
    ret.value = 700
    with pytest.raises(RuntimeError):
        _build.launch(fn, "probe", 0, *args)
    assert one.LAUNCHES == 7
    ret.value = 0


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__)
def test_every_wrapper_kernel_is_counted_in_its_module(module):
    """Each kernel of a wrapper module's ``SIGNATURES`` counts in that
    module's ``LAUNCHES`` (its own key where that is a dict)."""
    for kernel in module.SIGNATURES:
        assert _build._COUNTERS[kernel] == module.__name__
        if isinstance(module.LAUNCHES, dict):
            assert kernel in module.LAUNCHES
    if not isinstance(module.LAUNCHES, dict):
        assert len(module.SIGNATURES) == 1


def test_every_wrapper_signature_has_its_trampoline():
    """The module the wrappers use, built into build/ as at first use,
    has a trampoline for each launcher signature of every wrapper module;
    every signature ends with the stream."""
    mod = _build.pylaunch()
    sigs = {sig for m in MODULES for sig in m.SIGNATURES.values()}
    assert sigs == set(SIGS)
    for sig in sigs:
        assert set(sig) <= set("pif") and sig.endswith("pp")
        assert callable(getattr(mod, sig))
