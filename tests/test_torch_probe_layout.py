"""A numpy model of how kernels P1 / P2, P3, P4 and P5
(``csrc/gather_probe.cu``) and P8 (``csrc/gather_probe2.cu``) map their
threads to the words they read and write, held to the plain versions.

The CUDA kernels cannot run on the CPU, so this file runs their thread
maps instead, at the default build's block sizes and rows a warp (read
from the source):

- P1 / P2, ``gather_rows``: blocks of ``threads("P1")``; at W = 8 on
  16-byte aligned table and out pointers, thread k moves float4 ``k % 2``
  of lane ``k // 2``'s row; any other width or alignment a 2-D grid of
  words (lanes along x, columns along y);
- P3, ``gather_cols``: one thread per lane, blocks of ``threads("P3")``;
  thread ``lane`` loads ``idx[lane]``, then ``table_t[c, idx[lane]]`` for
  every column c, and stores each at ``out[c * n + lane]``;
- P4, ``gather_rows_warp``: a warp per run of ``macro("P4_ROWS")`` rows,
  blocks of ``threads("P4")``; lane l loads the run's index l, and the
  lanes that copy row r (at W = 8 on aligned pointers a pair, a float4 a
  lane, 16 rows a pass; else the whole warp, a row at a time) take its
  index by shuffle from lane r;
- P5, ``stack_push_read``: blocks of ``threads("P5")``, each with a
  (depth, threads) slab of shared memory; thread t's stack entry k is slab
  word ``k * threads + t``, so its bank is ``t mod 32`` whatever k.
- P8, ``gather_two_step``: a block of 128 threads an index row,
  ``macro("P8_ROWS")`` rows a block; thread l of row s loads idx[s, l],
  then idx[s, m] and idx[s, idx[s, m] & 127] (m = idx[s, l] & 127), one
  flat2 word, and stores out[s, l]: no shared memory, no barrier.

Each model checks that every output word is written exactly once at
ragged shapes and that a warp's index loads are consecutive words; P3's
stores are consecutive too, and the 32 pushes of a warp of P5 at any stack
pointers fall in 32 distinct banks. P4's shuffles take each row's index
from the lane that loaded it, and no row is copied by two groups. P1's
and P4's float4 paths are taken only at W = 8 with both pointers 16-byte
aligned, and then every float4 address is 16-byte aligned. P8's threads
read idx only within their own row (the lines their block loads, so the
second and third reads hit in L1), every index that addresses flat2 is
range-checked, and a ragged last block's spare rows load and store
nothing. P8's model is also held to the TPU body ``k_two`` in interpret
mode.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops.cuda import _build
from pathtracer_tpu_torch.probes import gather as pg
from pathtracer_tpu_torch.probes import gather2 as pg2

WARP = 32
BANKS = 32
DEFAULT_SMEM = 48 * 1024  # shared memory a block gets without opting in


def _warp_slices(live_lanes):
    """The live lanes of each warp of a 1-D grid of consecutive lanes."""
    return [live_lanes[first:first + WARP]
            for first in range(0, live_lanes.size, WARP)]


def gather_rows_model(table, idx, table_ptr, out_ptr):
    """P1 / P2's thread map. ``table_ptr`` and ``out_ptr`` are the byte
    addresses the launcher is given. Returns (out, writes per output word,
    per warp the idx words it loads, the grid, the bytes a thread
    moves)."""
    m, w = table.shape
    n = idx.shape[0]
    block = pg.threads("P1")
    vec4 = w == 8 and (table_ptr | out_ptr) % 16 == 0
    flat = table.reshape(-1)
    out = np.full(n * w, np.nan, np.float32)
    writes = np.zeros(n * w, np.int64)
    assert ((idx >= 0) & (idx < m)).all()  # the kernel traps otherwise
    if vec4:  # a thread a float4, two a row
        grid = (-(-2 * n // block), 1)
        k = np.arange(grid[0] * block)
        k = k[k < 2 * n]
        lane, part = k // 2, k % 2
        src = idx[lane].astype(np.int64) * 2 + part
        dst = lane * 2 + part
        assert ((table_ptr + 16 * src) % 16 == 0).all()
        assert ((out_ptr + 16 * dst) % 16 == 0).all()
        for e in range(4):
            np.add.at(writes, dst * 4 + e, 1)
            out[dst * 4 + e] = flat[src * 4 + e]
    else:  # a 2-D grid of words: lanes along x, columns along y
        grid = (-(-n // block), min(w, 65535))
        lane = np.arange(grid[0] * block)
        lane = lane[lane < n]
        row = idx[lane].astype(np.int64)
        for y in range(grid[1]):
            for c in range(y, w, grid[1]):
                np.add.at(writes, lane * w + c, 1)
                out[lane * w + c] = flat[row * w + c]
    loads = [lane[first:first + WARP] for first in range(0, lane.size, WARP)]
    return out.reshape(n, w), writes, loads, grid, 16 if vec4 else 4


def gather_rows_warp_model(table, idx, table_ptr, out_ptr):
    """P4's thread map, on the byte addresses the launcher is given.
    Returns (out, writes per output word, per warp the idx words it
    loads, the groups that copied each row, the block count)."""
    m, w = table.shape
    n = idx.shape[0]
    runs, block = pg.macro("P4_ROWS"), pg.threads("P4")
    blocks = -(-n // (runs * block // WARP))
    pairs = w == 8 and (table_ptr | out_ptr) % 16 == 0
    flat = table.reshape(-1)
    out = np.full(n * w, np.nan, np.float32)
    writes = np.zeros(n * w, np.int64)
    copies = np.zeros(n, np.int64)
    loads = []
    lanes = np.arange(WARP)
    for warp in range(blocks * block // WARP):
        base = warp * runs
        if base >= n:
            continue
        rows = min(runs, n - base)
        mine = np.zeros(WARP, np.int64)  # each lane's register
        held = lanes < rows
        mine[held] = idx[base + lanes[held]]
        loads.append(base + lanes[held])
        assert ((mine[held] >= 0) & (mine[held] < m)).all()  # else a trap
        if pairs:  # two lanes a row, a float4 each, 16 rows a pass
            g, h = lanes // 2, lanes % 2
            for p in range(-(-runs // 16)):
                r = p * 16 + g  # each lane's row, its shuffle source
                row = mine[r % WARP]
                ok = r < rows
                np.testing.assert_array_equal(row[ok], idx[base + r[ok]])
                for rr in np.unique(r[ok]):  # one pair a row
                    assert (h[r == rr] == [0, 1]).all()
                    copies[base + rr] += 1
                src = row[ok] * 2 + h[ok]
                dst = (base + r[ok]) * 2 + h[ok]
                assert ((table_ptr + 16 * src) % 16 == 0).all()
                assert ((out_ptr + 16 * dst) % 16 == 0).all()
                for e in range(4):
                    np.add.at(writes, dst * 4 + e, 1)
                    out[dst * 4 + e] = flat[src * 4 + e]
        else:  # the whole warp a row, lanes along the columns
            for r in range(rows):
                row = mine[r]
                assert row == idx[base + r]
                copies[base + r] += 1
                for first in range(0, w, WARP):
                    col = first + lanes[first + lanes < w]
                    np.add.at(writes, (base + r) * w + col, 1)
                    out[(base + r) * w + col] = flat[row * w + col]
    return out.reshape(n, w), writes, loads, copies, blocks


def gather_cols_model(table_t, idx):
    """P3's thread map: returns (out, writes per output word, per warp the
    idx words it loads and per column the out words it stores, the block
    count)."""
    w, m = table_t.shape
    n = idx.shape[0]
    block = pg.threads("P3")
    blocks = -(-n // block)
    lane = np.arange(blocks * block)
    live = lane < n
    out = np.full(w * n, np.nan, np.float32)
    writes = np.zeros(w * n, np.int64)
    warps = []
    for first in range(0, blocks * block, WARP):
        wl = lane[first:first + WARP][live[first:first + WARP]]
        if wl.size:
            warps.append((wl, [c * n + wl for c in range(w)]))
    row = idx[lane[live]]
    assert ((row >= 0) & (row < m)).all()  # the kernel traps otherwise
    for c in range(w):
        dest = c * n + lane[live]
        np.add.at(writes, dest, 1)
        out[dest] = table_t[c, row]
    return out.reshape(w, n), writes, warps, blocks


def stack_push_read_model(sp, v, depth):
    """P5's thread map over shared-memory slabs: returns (out, writes per
    output word, per warp the slab words of its pushes, slab bytes, the
    block count)."""
    n = sp.shape[0]
    block = pg.threads("P5")
    blocks = -(-n // block)
    out = np.full(n, np.nan, np.float32)
    writes = np.zeros(n, np.int64)
    warp_words = []
    for b in range(blocks):
        slab = np.full(depth * block, np.nan, np.float32)  # not zeroed
        t = np.arange(block)
        lane = b * block + t
        live = lane < n
        t, lane = t[live], lane[live]
        s = sp[lane]
        assert ((s >= 0) & (s < depth)).all()  # the kernel traps otherwise
        word = s * block + t
        assert np.unique(word).size == word.size  # no two threads collide
        slab[word] = v[lane]
        out[lane] = slab[word]
        np.add.at(writes, lane, 1)
        for first in range(0, t.size, WARP):
            warp_words.append((t[first:first + WARP],
                               word[first:first + WARP]))
    return out, writes, warp_words, 4 * depth * block, blocks


def gather_two_step_model(flat2, idx):
    """P8's thread map. Returns (out, writes per output word, per warp the
    idx words of its first loads and the out words it stores, the block
    count)."""
    c, lanes = flat2.shape
    s = idx.shape[0]
    rows = pg2.macro("P8_ROWS")
    blocks = -(-s // rows)
    flat, words_of = flat2.reshape(-1), idx.reshape(-1).astype(np.int64)
    out = np.full(s * lanes, np.nan, np.float32)
    writes = np.zeros(s * lanes, np.int64)
    warps = []
    l = np.arange(lanes)  # thread r * 128 + l of a block: row r's lane l
    for b in range(blocks):
        for r in range(rows):
            row = b * rows + r
            if row >= s:
                continue  # a ragged last block: the thread returns
            k0 = row * lanes + l
            i = words_of[k0]
            assert ((i >= 0) & (i < c * lanes)).all()  # else a trap
            m = i & (lanes - 1)
            k1 = row * lanes + m  # the second and third loads: this
            k2 = row * lanes + (words_of[k1] & (lanes - 1))  # row's lines
            assert ((k1 // lanes == row) & (k2 // lanes == row)).all()
            cas = words_of[k2]
            assert ((cas >= 0) & (cas < c * lanes)).all()  # else a trap
            np.add.at(writes, k0, 1)
            out[k0] = flat[(cas >> 7) * lanes + m]
            warps += [k0[first:first + WARP]
                      for first in range(0, lanes, WARP)]
    return out.reshape(s, lanes), writes, warps, blocks


def _consecutive(words):
    return np.array_equal(words, np.arange(words[0], words[0] + words.size))


@pytest.mark.parametrize("w", [1, 3, 8, 13])
@pytest.mark.parametrize("n", [1, 33, 257, 8193])
def test_gather_cols_writes_each_word_once(n, w):
    rng = np.random.default_rng(n + 7 * w)
    m = 1000
    table_t = rng.random((w, m), np.float32)
    idx = rng.integers(0, m, n).astype(np.int32)
    out, writes, warps, _ = gather_cols_model(table_t, idx)
    assert (writes == 1).all()
    want = pg.gather_cols_plain(torch.as_tensor(table_t),
                                torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(out, want)
    for lanes, stores in warps:  # coalesced: 32 consecutive words at most
        assert lanes.size <= WARP and _consecutive(lanes)
        assert all(_consecutive(s) for s in stores)


def _rows_case(n, w, m=1000):
    rng = np.random.default_rng(n * 100 + w)
    table = rng.random((m, w), np.float32)
    idx = rng.integers(0, m, n).astype(np.int32)
    idx[:1], idx[-1:] = 0, m - 1
    return table, idx


def _pointers(table, n, shift):
    """A contiguous (M, W) view of ``table`` and the out pointer a launch
    gets: both 16-byte aligned, the table one float into its allocation,
    or out one float past 16 bytes."""
    off = int(shift == "table")
    view = torch.zeros(table.size + off)[off:].view(table.shape)
    view.copy_(torch.as_tensor(table))
    out_ptr = torch.empty(n, table.shape[1]).data_ptr() + 4 * (shift == "out")
    return view, out_ptr


@pytest.mark.parametrize("shift", ["none", "table", "out"])
@pytest.mark.parametrize("w", [1, 3, 4, 8, 13, 40])
@pytest.mark.parametrize("n", [1, 33, 257, 8193])
def test_gather_rows_writes_each_word_once(n, w, shift):
    """P1 / P2 on an aligned table and out, with the table one float past
    its allocation, and with out one float past 16 bytes: each output word
    written once, a warp's idx loads consecutive words, float4 (every
    address 16-byte aligned) only at W = 8 with both pointers 16-byte
    aligned."""
    table, idx = _rows_case(n, w)
    view, out_ptr = _pointers(table, n, shift)
    out, writes, loads, grid, size = gather_rows_model(
        table, idx, view.data_ptr(), out_ptr)
    vec4 = w == 8 and shift == "none"
    assert size == (16 if vec4 else 4)
    block = pg.threads("P1")
    assert grid == ((-(-2 * n // block), 1) if vec4 else
                    (-(-n // block), w))
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, pg.gather_rows_plain(
        view, torch.as_tensor(idx)).numpy())
    for lanes in loads:  # at W = 8 two threads load each word
        assert lanes.size <= WARP and _consecutive(np.unique(lanes))


@pytest.mark.parametrize("shift", ["none", "table"])
@pytest.mark.parametrize("w", [1, 3, 4, 8, 13, 40])
@pytest.mark.parametrize("n", [1, 33, 257, 8193])
def test_gather_rows_warp_shuffles_each_row_once(n, w, shift):
    """P4: each output word written once, each row copied by one group
    whose shuffle source lane loaded that row's index, a warp's idx loads
    one run of consecutive words; lane pairs of float4 only at W = 8 on
    aligned pointers."""
    table, idx = _rows_case(n, w)
    view, out_ptr = _pointers(table, n, shift)
    out, writes, loads, copies, blocks = gather_rows_warp_model(
        table, idx, view.data_ptr(), out_ptr)
    assert (writes == 1).all() and (copies == 1).all()
    np.testing.assert_array_equal(out, pg.gather_rows_plain(
        view, torch.as_tensor(idx)).numpy())
    runs = pg.macro("P4_ROWS")
    assert all(run.size <= runs and _consecutive(run) for run in loads)
    assert np.array_equal(np.concatenate(loads), np.arange(n))
    assert blocks == -(-n // (runs * pg.threads("P4") // WARP))


def test_row_gather_grids_reach_almost_every_sm():
    """At the probe's shapes P1 / P2 and P4 launch at least 128 blocks (of
    132 SMs), whole warps each, P1 on float4, P4 at most 32 rows a
    warp."""
    x = pg.probe_inputs("cpu")
    table, idx = x["table"].numpy(), x["idx"].numpy()
    ptrs = x["table"].data_ptr(), torch.empty(pg.N, pg.W).data_ptr()
    *_, grid, size = gather_rows_model(table, idx, *ptrs)
    *_, blocks_p4 = gather_rows_warp_model(table, idx, *ptrs)
    assert size == 16 and grid[0] >= 128 and blocks_p4 >= 128
    assert pg.threads("P1") % WARP == 0 and pg.threads("P4") % WARP == 0
    assert pg.macro("P4_ROWS") <= WARP


@pytest.mark.parametrize("sp_at", ["bottom", "top", "mixed"])
@pytest.mark.parametrize("depth", [1, 33, 64])
def test_stack_slab_banks_distinct_in_a_warp(depth, sp_at):
    rng = np.random.default_rng(depth)
    n = 8193
    sp = {"bottom": np.zeros(n), "top": np.full(n, depth - 1),
          "mixed": rng.integers(0, depth, n)}[sp_at].astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    out, writes, warp_words, slab_bytes, _ = stack_push_read_model(sp, v,
                                                                   depth)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, v)
    np.testing.assert_array_equal(out, pg.stack_push_read_plain(
        torch.as_tensor(sp), torch.as_tensor(v), depth).numpy())
    for t, words in warp_words:
        assert np.unique(words % BANKS).size == t.size
        np.testing.assert_array_equal(words % BANKS, t % BANKS)
    assert slab_bytes <= DEFAULT_SMEM


@pytest.mark.parametrize("n", [1, 63, 65, 129])
def test_stack_push_read_ragged_lanes(n):
    rng = np.random.default_rng(n)
    depth = pg.D
    sp = rng.integers(0, depth, n).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    out, writes, _, _, blocks = stack_push_read_model(sp, v, depth)
    assert (writes == 1).all() and blocks == -(-n // pg.threads("P5"))
    np.testing.assert_array_equal(out, v)


def test_probe_grids_reach_almost_every_sm():
    """At the probe's shapes both kernels launch at least 128 blocks (of
    132 SMs); the slab of P5's block is 16 KB at depth 64."""
    x = pg.probe_inputs("cpu")
    *_, blocks_p3 = gather_cols_model(x["table_t"].numpy(),
                                      x["idx"].numpy())
    *_, slab_bytes, blocks_p5 = stack_push_read_model(
        x["sp"].numpy(), x["v"].numpy(), pg.D)
    assert blocks_p3 >= 128 and blocks_p5 >= 128
    assert pg.threads("P3") % WARP == 0 and pg.threads("P5") % WARP == 0
    assert slab_bytes == 4 * pg.D * pg.threads("P5") == 16384


def test_ptxas_report_reads_shared_memory(tmp_path):
    """``_build.ptxas_report`` reads each kernel's registers, static
    shared memory (0 where ptxas names none) and spills."""
    lib = tmp_path / "libprobe.so"
    (tmp_path / "libprobe.report.txt").write_text(
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1av\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 12 registers, 380 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bv\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 40 registers, 4096 bytes smem, 380 bytes "
        "cmem[0]\n")
    assert _build.ptxas_report(str(lib)) == {
        "_Z1av": dict(registers=12, smem=0, stack=0, spill_stores=0,
                      spill_loads=0),
        "_Z1bv": dict(registers=40, smem=4096, stack=8, spill_stores=4,
                      spill_loads=4)}


def _two_step_case(s, c, pattern):
    """(C, 128) flat2 and (S, 128) indices: over the table's whole range
    ("random"), every row's lanes in one chunk ("one chunk"), or only the
    first and last lanes of chunks ("ends"); the first row opens with a
    chunk's first and last lane, the table's first and last word."""
    rng = np.random.default_rng(1000 * s + c)
    flat2 = rng.random((c, pg2.L), np.float32)
    lane = rng.integers(0, pg2.L, (s, pg2.L))
    chunk = {"random": rng.integers(0, c, (s, pg2.L)),
             "one chunk": rng.integers(0, c, (s, 1)),
             "ends": rng.integers(0, c, (s, pg2.L))}[pattern]
    if pattern == "ends":
        lane = (pg2.L - 1) * (lane % 2)
    idx = (chunk * pg2.L + lane).astype(np.int32)
    if s:
        idx[0, :4] = (0, pg2.L - 1, (c - 1) * pg2.L, c * pg2.L - 1)
    return flat2, idx


@pytest.mark.parametrize("pattern", ["random", "one chunk", "ends"])
@pytest.mark.parametrize("c", [1, 7, 548])
@pytest.mark.parametrize("s", [0, 1, 3, 64, 65])
def test_gather_two_step_writes_each_word_once(s, c, pattern):
    """P8 at ragged row counts and table sizes: each output word written
    once, each warp's first loads 32 consecutive idx words and its stores
    32 consecutive out words; equal to the plain version (and, where a
    row's lanes share their chunk, to flat[idx])."""
    flat2, idx = _two_step_case(s, c, pattern)
    out, writes, warps, blocks = gather_two_step_model(flat2, idx)
    assert (writes == 1).all() and len(warps) == 4 * s
    assert blocks == -(-s // pg2.macro("P8_ROWS"))
    assert all(w.size == WARP and _consecutive(w) for w in warps)
    want = pg2.gather_two_step_plain(torch.as_tensor(flat2),
                                     torch.as_tensor(idx))
    np.testing.assert_array_equal(out, want.numpy())
    if pattern == "one chunk" and s:
        np.testing.assert_array_equal(out[1:], flat2.reshape(-1)[idx[1:]])


def test_gather_two_step_model_matches_tpu_body():
    """At the probe's inputs (S = 64, C = 548) P8's thread map equals the
    TPU body ``k_two`` run by ``pl.pallas_call(interpret=True)``."""
    from test_torch_probes2 import _interpret
    x = pg2.probe_inputs("cpu")
    out, writes, *_ = gather_two_step_model(x["flat2"].numpy(),
                                            x["idx_i"].numpy())
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, _interpret("P8", x))


def test_gather_two_step_grid():
    """At the probe's shapes: 128 threads a row (four whole warps), 64 /
    P8_ROWS blocks."""
    x = pg2.probe_inputs("cpu")
    *_, warps, blocks = gather_two_step_model(x["flat2"].numpy(),
                                              x["idx_i"].numpy())
    rows = pg2.macro("P8_ROWS")
    assert len(warps) == 4 * pg2.S and blocks * rows == pg2.S
    assert pg2.L % WARP == 0 and 1 <= rows <= 8
