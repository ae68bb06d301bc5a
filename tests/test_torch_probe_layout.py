"""A numpy model of how kernels P3 and P5 (``csrc/gather_probe.cu``) map
their threads to the words they read and write, held to the plain versions.

The CUDA kernels cannot run on the CPU, so this file runs their thread
maps instead, at the default build's block sizes (read from the source):

- P3, ``gather_cols``: one thread per lane, blocks of ``threads("P3")``;
  thread ``lane`` loads ``idx[lane]``, then ``table_t[c, idx[lane]]`` for
  every column c, and stores each at ``out[c * n + lane]``;
- P5, ``stack_push_read``: blocks of ``threads("P5")``, each with a
  (depth, threads) slab of shared memory; thread t's stack entry k is slab
  word ``k * threads + t``, so its bank is ``t mod 32`` whatever k.

Each model checks that every output word is written exactly once at
ragged shapes, that a warp's index loads and stores are consecutive words,
and that the 32 pushes of a warp at any stack pointers fall in 32 distinct
banks.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops.cuda import _build
from pathtracer_tpu_torch.probes import gather as pg

WARP = 32
BANKS = 32
DEFAULT_SMEM = 48 * 1024  # shared memory a block gets without opting in


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
