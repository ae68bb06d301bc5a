"""The gather probes P1-P5 (``probes/gather.py``) on the CPU, at the TPU
probe's shapes and on its ``default_rng(0)`` draws, against the probe's own
numpy references (``tools/probe_pallas_gather.py``: ``table[idx]`` for the
row gathers, the transposed table for the lane gather, and ``v`` for the
stack push / read-back), and at ragged shapes, the row gathers also on a
table view that starts one float past an allocation. They only move words,
so equality is exact. The tool itself is not imported: it runs its TPU
calls at import.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.probes import gather as pg


def _numpy_draws():
    """The tool's draws, in its order."""
    rng = np.random.default_rng(0)
    table = rng.random((pg.M, pg.W), np.float32)
    idx = rng.integers(0, pg.M, pg.N).astype(np.int32)
    sp = rng.integers(0, pg.D, pg.N).astype(np.int32)
    v = rng.random(pg.N).astype(np.float32)
    return table, idx, sp, v


def test_probe_inputs_are_the_tools_draws():
    table, idx, sp, v = _numpy_draws()
    x = pg.probe_inputs("cpu")
    assert x["table"].shape == (65536, 8) and x["idx"].shape == (8192,)
    np.testing.assert_array_equal(x["table"].numpy(), table)
    np.testing.assert_array_equal(x["table_t"].numpy(), table.T)
    np.testing.assert_array_equal(x["idx"].numpy(), idx)
    np.testing.assert_array_equal(x["sp"].numpy(), sp)
    np.testing.assert_array_equal(x["v"].numpy(), v)


@pytest.mark.parametrize("pid", ["P1", "P2", "P3", "P4", "P5"])
def test_plain_probe_matches_numpy_reference(pid):
    table, idx, sp, v = _numpy_draws()
    before = dict(pg.LAUNCHES)
    got = pg.run_probes("cpu")[pid].numpy()
    assert pg.LAUNCHES == before  # CPU tensors: the plain versions
    want = {"P1": table[idx], "P2": table[idx], "P3": table.T[:, idx],
            "P4": table[idx], "P5": v}[pid]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if pid == "P3":  # the tool transposes the lane gather back
        np.testing.assert_array_equal(got.T, table[idx])


def test_probe_wrappers_reject_bad_inputs():
    x = pg.probe_inputs("cpu")
    with pytest.raises(TypeError, match="int32"):
        pg.gather_rows(x["table"], x["idx"].long())
    with pytest.raises(TypeError, match="float32"):
        pg.stack_push_read(x["sp"], x["v"].double())
    with pytest.raises(ValueError, match="depth"):
        pg.stack_push_read(x["sp"], x["v"], depth=65)
    with pytest.raises(ValueError, match="expected"):
        pg.gather_cols(x["table_t"], torch.zeros(4, dtype=torch.int32,
                                                 device="meta"))


@pytest.mark.parametrize("w", [1, 3, 8, 13])
@pytest.mark.parametrize("n", [1, 33, 257, 8193])
def test_plain_gather_cols_ragged_shapes(n, w):
    """P3's plain version at ragged lane counts and table widths, against
    numpy's column gather."""
    rng = np.random.default_rng(n * 100 + w)
    m = 1000
    table_t = rng.random((w, m), np.float32)
    idx = rng.integers(0, m, n).astype(np.int32)
    idx[0], idx[-1] = 0, m - 1  # the table's first and last columns
    got = pg.gather_cols(torch.as_tensor(table_t), torch.as_tensor(idx))
    assert got.shape == (w, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), table_t[:, idx])


@pytest.mark.parametrize("sp_at", ["bottom", "top", "mixed"])
@pytest.mark.parametrize("depth", [1, 33, 64])
def test_plain_stack_push_read_ragged_depths(depth, sp_at):
    """P5's plain version at ragged depths, every pointer at 0, every one
    at depth - 1, or drawn over [0, depth) with both ends present: each
    lane reads back its own value."""
    rng = np.random.default_rng(depth)
    n = 257
    sp = {"bottom": np.zeros(n), "top": np.full(n, depth - 1),
          "mixed": rng.integers(0, depth, n)}[sp_at].astype(np.int32)
    if sp_at == "mixed":
        sp[:2] = 0, depth - 1
    v = rng.normal(size=n).astype(np.float32)
    got = pg.stack_push_read(torch.as_tensor(sp), torch.as_tensor(v), depth)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), v)


def offset_table(table: np.ndarray, offset: int) -> torch.Tensor:
    """``table`` as a contiguous view that starts ``offset`` floats into
    its allocation (an allocation starts 16-byte aligned, so offset 1 does
    not)."""
    m, w = table.shape
    flat = torch.zeros(m * w + offset, dtype=torch.float32)
    view = flat[offset:].view(m, w)
    view.copy_(torch.as_tensor(table))
    return view


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("w", [1, 3, 4, 8, 13, 40])
@pytest.mark.parametrize("n", [0, 1, 33, 257, 8193])
def test_plain_gather_rows_ragged_shapes(n, w, offset):
    """P1 / P2's and P4's plain versions (what their wrappers run on the
    CPU) at ragged lane counts and widths, indices at the table's first
    and last rows, on a table that starts at the allocation and one float
    past it: numpy's row gather."""
    rng = np.random.default_rng(n * 100 + w)
    m = 1000
    table = rng.random((m, w), np.float32)
    idx = rng.integers(0, m, n).astype(np.int32)
    idx[:1], idx[-1:] = 0, m - 1
    view = offset_table(table, offset)
    assert view.is_contiguous() and (view.data_ptr() % 16 != 0) == offset
    idx_t = torch.as_tensor(idx)
    for fn in (pg.gather_rows_plain, pg.gather_rows, pg.gather_rows_warp):
        got = fn(view, idx_t)
        assert got.shape == (n, w) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), table[idx])
