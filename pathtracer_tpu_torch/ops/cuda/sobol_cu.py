"""Kernel K7 wrapper: the Sobol' sampler's sample index and its draws.

``sobol_index``, ``sobol_sample_dim`` and ``sobol_sample_dim2`` keep the
signatures and results of the plain functions of ``ops/sobol.py`` (the
reference's ``pathtracer_tpu/ops/sobol.py``); a draw's ``scramble`` may
also be None, for the camera's unscrambled dimensions. CUDA tensors go to
the hand-written kernels of ``csrc/sobol.cu`` (a thread a lane, the index
bits in registers, one launch a call); CPU tensors go to the plain
functions. There is no fallback between the two: a CUDA input that a
kernel cannot take raises.

The frame's words of ``sobol_index`` are host ints (numpy's included) or
0-d int64 tensors on the lanes' device (a CUDA graph's buffers), which
the kernel reads on the device: the same bits either way. Each launch lies
in its ``pt::k:sobol_index`` / ``pt::k:sobol_draw`` span
(``_build.launch``), inside the caller's ``pt::sampler``.
"""

from __future__ import annotations

import torch

from .. import sobol as sb
from . import _build

SOURCE = "sobol.cu"
# the launchers' signatures (ops/cuda/_build.bind): sobol_index (b_base,
# inv_lo, inv_hi; the frame words' tensors (delta, lo, hi), then their
# values; n; lo, hi, stream) and sobol_draw (idx_lo, idx_hi, scramble,
# table; dim, k, rows, n; out, stream)
SIGNATURES = {"sobol_index": "ppp" + "ppp" + "iii" + "i" + "ppp",
              "sobol_draw": "pppp" + "iiii" + "pp"}

# kernel launches made by ``sobol_index`` and the draws (``_build.launch``
# counts them; CPU calls never launch)
LAUNCHES = {"sobol_index": 0, "sobol_draw": 0}
_build.counted(__name__, SIGNATURES)

# a table row: the words of the 52 index bits a dimension reads
ROW_WORDS = 52

I64 = torch.int64
F32 = torch.float32

_fns = None


def build(verbose: bool = False) -> str:
    """Compile csrc/sobol.cu into build/ (once). Returns its path."""
    return _build.build_cuda(SOURCE, verbose=verbose)


def _load() -> dict:
    global _fns
    if _fns is None:
        _fns = _build.load_cuda(SOURCE, SIGNATURES)
    return _fns


def _slow_check(what: str, tensors: dict) -> int:
    """Where a call's fast test fails: -1 for CPU tensors (the plain
    function), else raise for what the kernel cannot take: a type, device
    or layout (``_build.check``), else the shapes."""
    if all(isinstance(x, torch.Tensor) and x.is_cpu
           for x in tensors.values()):
        return -1
    _build.check(what, tensors, I64)
    raise ValueError(f"{what}: shapes the kernel cannot take: " + ", ".join(
        f"{name} {tuple(x.shape)}" for name, x in tensors.items()))


def _word(w, dev: int) -> tuple:
    """A frame word as the launcher takes it: (its pointer, 0) for a 0-d
    int64 tensor on cuda:``dev``, (0, its bits as a C int) for a host
    integer in [0, 2^32)."""
    if isinstance(w, torch.Tensor):
        if (w.dtype is not I64 or w.dim() != 0 or not w.is_cuda
                or w.get_device() != dev):
            raise ValueError(f"a frame word tensor must be a 0-d int64 on "
                             f"cuda:{dev}, got {w.dtype} {tuple(w.shape)} "
                             f"on {w.device}")
        return w.data_ptr(), 0
    v = int(w)
    if not 0 <= v < 1 << 32:
        raise ValueError(f"a frame word must lie in [0, 2^32), got {v}")
    return 0, v - (1 << 32) if v >= 1 << 31 else v


def sobol_index(b_base, delta, shifted_lo, shifted_hi, inv_lo, inv_hi):
    """The lanes' 64-bit Sobol sample index as (lo, hi) int64 words, as
    ``ops/sobol.sobol_index`` (its docstring has the arguments): kernel
    K7's ``sobol_index`` on the card, the plain function on the CPU."""
    try:  # the case a launch takes, in the fewest attribute reads
        dev, n = b_base.get_device(), b_base.shape[0]
        fast = (b_base.is_cuda and b_base.dtype is I64
                and b_base.dim() == 1 and b_base.is_contiguous()
                and all(x.dtype is I64 and x.get_device() == dev
                        and x.is_contiguous() and x.shape == (ROW_WORDS,)
                        for x in (inv_lo, inv_hi)))
    except (AttributeError, IndexError):  # not a tensor or not 1-D
        fast = False
    if not fast:
        dev = _slow_check("sobol_index", dict(b_base=b_base, inv_lo=inv_lo,
                                              inv_hi=inv_hi))
    if dev < 0:
        return sb.sobol_index(b_base, delta, shifted_lo, shifted_hi, inv_lo,
                              inv_hi)
    words = [_word(w, dev) for w in (delta, shifted_lo, shifted_hi)]
    lo = torch.empty((n,), dtype=I64, device=b_base.device)
    hi = torch.empty((n,), dtype=I64, device=b_base.device)
    if n > 0:
        _build.launch(
            (_fns or _load())["sobol_index"], "sobol_index", dev,
            b_base.data_ptr(), inv_lo.data_ptr(), inv_hi.data_ptr(),
            *(p for p, _ in words), *(v for _, v in words), n,
            lo.data_ptr(), hi.data_ptr())
    return lo, hi


def _draw(what: str, idx_lo, idx_hi, dim: int, scramble, sm32, k: int):
    """``k`` consecutive dimensions from ``dim``: (N,) for one, (N, 2)
    for two."""
    lanes = (idx_hi,) if scramble is None else (idx_hi, scramble)
    try:  # the case a launch takes, in the fewest attribute reads
        dev, n = idx_lo.get_device(), idx_lo.shape[0]
        fast = (idx_lo.is_cuda and idx_lo.dtype is I64
                and idx_lo.dim() == 1 and idx_lo.is_contiguous()
                and all(x.dtype is I64 and x.get_device() == dev
                        and x.is_contiguous() and x.shape == (n,)
                        for x in lanes)
                and sm32.dtype is I64 and sm32.get_device() == dev
                and sm32.is_contiguous() and sm32.dim() == 2
                and sm32.shape[1] == ROW_WORDS and sm32.shape[0] >= k)
    except (AttributeError, IndexError):  # not a tensor or not 1-D
        fast = False
    if not fast:
        tensors = dict(idx_lo=idx_lo, idx_hi=idx_hi, sm32=sm32)
        if scramble is not None:
            tensors["scramble"] = scramble
        dev = _slow_check(what, tensors)
    if dev < 0:
        plain = sb.sobol_sample_dim if k == 1 else sb.sobol_sample_dim2
        return plain(idx_lo, idx_hi, dim,
                     torch.zeros_like(idx_lo) if scramble is None
                     else scramble, sm32)
    if dim < 0:
        raise ValueError(f"{what}: dimension {dim} is negative")
    out = torch.empty((n, k) if k > 1 else (n,), dtype=F32,
                      device=idx_lo.device)
    if n > 0:
        _build.launch(
            (_fns or _load())["sobol_draw"], "sobol_draw", dev,
            idx_lo.data_ptr(), idx_hi.data_ptr(),
            0 if scramble is None else scramble.data_ptr(), sm32.data_ptr(),
            dim, k, sm32.shape[0], n, out.data_ptr())
    return out


def sobol_sample_dim(idx_lo, idx_hi, dim: int, scramble, sm32):
    """One dimension (N,) in [0, 1), as ``ops/sobol.sobol_sample_dim``
    (scramble None: unscrambled): K7's ``sobol_draw`` on the card, the
    plain function on the CPU."""
    return _draw("sobol_sample_dim", idx_lo, idx_hi, dim, scramble, sm32, 1)


def sobol_sample_dim2(idx_lo, idx_hi, dim: int, scramble, sm32):
    """Two consecutive dimensions (N, 2), as
    ``ops/sobol.sobol_sample_dim2`` (scramble None: unscrambled): K7's
    ``sobol_draw`` on the card, the plain function on the CPU."""
    return _draw("sobol_sample_dim2", idx_lo, idx_hi, dim, scramble, sm32, 2)
