"""Gather probes P6-P9 (``probes/gather2.py``) on the CPU.

The plain versions (what the wrappers run for CPU tensors) are held
exactly to the TPU kernel bodies of ``tools/probe_pallas_gather2.py``,
copied here and run through ``pl.pallas_call(..., interpret=True)`` on
the probe's own inputs. The card kernels are held to the plain versions
in ``tests/test_torch_cuda.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pathtracer_tpu_torch.probes import gather2 as pg

S, L = pg.S, pg.L


# --- the tool's kernel bodies, as written there


def k_sub(d_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(d_ref[:], i_ref[:], axis=0)


def k_lane(d_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(d_ref[:], i_ref[:], axis=1)


def k_two(d_ref, i_ref, o_ref):
    idx = i_ref[:]
    chunk = idx >> 7
    lanepos = idx & 127
    chunk_at_src = jnp.take_along_axis(chunk, lanepos, axis=1)
    t2 = jnp.take_along_axis(d_ref[:], chunk_at_src, axis=0)
    o_ref[:] = jnp.take_along_axis(t2, lanepos, axis=1)


def k_mxu(t_ref, i_ref, o_ref):
    idx = i_ref[:].reshape(S * 128, 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (S * 128, 128), 1)
    onehot = (cols == idx).astype(jnp.float32)
    o_ref[:] = jnp.dot(onehot, t_ref[:],
                       preferred_element_type=jnp.float32
                       ).reshape(S, 128, 128)


_TPU = {"P6": (k_sub, "data_g", "idx_g", (S, L)),
        "P7": (k_lane, "data_h", "idx_h", (S, L)),
        "P8": (k_two, "flat2", "idx_i", (S, L)),
        "P9": (k_mxu, "tbl_j", "idx_j", (S, L, L))}


def _interpret(pid, x):
    kernel, a, b, shape = _TPU[pid]
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        interpret=True)(jnp.asarray(x[a].numpy()), jnp.asarray(x[b].numpy())))


@pytest.fixture(scope="module")
def x():
    return pg.probe_inputs("cpu")


def test_probe_inputs_are_the_tools_draws(x):
    rng = np.random.default_rng(0)
    want = dict(
        data_g=rng.random((548, 128), np.float32),
        idx_g=rng.integers(0, 548, (64, 128)).astype(np.int32),
        data_h=rng.random((64, 128), np.float32),
        idx_h=rng.integers(0, 128, (64, 128)).astype(np.int32),
        flat=rng.random(548 * 128, np.float32),
        idx_i=rng.integers(0, 548 * 128, (64, 128)).astype(np.int32),
        tbl_j=rng.random((128, 128), np.float32),
        idx_j=rng.integers(0, 128, (64, 128)).astype(np.int32))
    want["flat2"] = want["flat"].reshape(548, 128)
    assert set(x) == set(want)
    for key, arr in want.items():
        assert x[key].dtype == torch.from_numpy(arr).dtype, key
        np.testing.assert_array_equal(x[key].numpy(), arr, err_msg=key)


@pytest.mark.parametrize("pid", ["P6", "P7", "P8", "P9"])
def test_plain_probe_matches_tpu_body_in_interpret_mode(x, pid):
    before = dict(pg.LAUNCHES)
    got = pg.run_probes("cpu", x)[pid].numpy()
    assert pg.LAUNCHES == before  # CPU tensors: the plain versions
    want = _interpret(pid, x)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_numpy_references_of_p6_p7_p9(x):
    """P6, P7 and P9 compute the tool's numpy references exactly."""
    out = pg.run_probes("cpu", x)
    n = {k: v.numpy() for k, v in x.items()}
    np.testing.assert_array_equal(
        out["P6"].numpy(), np.take_along_axis(n["data_g"], n["idx_g"], 0))
    np.testing.assert_array_equal(
        out["P7"].numpy(), np.take_along_axis(n["data_h"], n["idx_h"], 1))
    np.testing.assert_array_equal(
        out["P9"].numpy(), n["tbl_j"][n["idx_j"].ravel()].reshape(64, 128,
                                                                  128))


def test_p8_is_not_the_tools_flat_gather(x):
    """The TPU body of P8 does not compute its tool's reference flat[idx]:
    out[s, l] = flat2[chunk[s, lp[s, lp[s, l]]], lp[s, l]], which is
    flat[idx[s, l]] only where that chunk is lane l's own."""
    got = pg.run_probes("cpu", x)["P8"].numpy()
    idx = x["idx_i"].numpy()
    flat_ref = x["flat"].numpy()[idx]
    agree = got == flat_ref
    assert 0.0 < agree.mean() < 0.05
    chunk, lp = idx >> 7, idx & 127
    read = np.take_along_axis(chunk, np.take_along_axis(lp, lp, 1), 1)
    assert agree[read == chunk].all()
    assert not agree[read != chunk].any()


def test_p8_equals_flat_gather_when_rows_share_a_chunk():
    rng = np.random.default_rng(5)
    flat2 = torch.as_tensor(rng.random((8, 128), np.float32))
    rows = rng.integers(0, 8, (4, 1))
    idx = torch.as_tensor((rows * 128 + rng.integers(0, 128, (4, 128)))
                          .astype(np.int32))
    got = pg.gather_two_step(flat2, idx)
    assert torch.equal(got, flat2.reshape(-1)[idx.long()])


def _p8_closed_form(flat2, idx):
    """out[s, l] = flat2[chunk[s, lp[s, m]], m] with m = lp[s, l]: the
    TPU body substituted, what the card kernel computes word by word."""
    chunk, lp = idx >> 7, idx & 127
    m = lp
    read = np.take_along_axis(chunk, np.take_along_axis(lp, m, 1), 1)
    return flat2[read, m]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("rows", [0, 1, 3, 65])
def test_p8_plain_ragged_rows(rows, offset):
    """The plain P8 at ragged row counts (idx a view at a word offset or
    not): equal to the substituted closed form, and to the TPU body
    ``k_two`` in interpret mode where there is a row."""
    x = pg.ragged_inputs(rows, "cpu", offset)
    before = dict(pg.LAUNCHES)
    got = pg.gather_two_step(x["flat2"], x["idx_i"])
    assert pg.LAUNCHES == before and got.shape == (rows, L)
    flat2, idx = x["flat2"].numpy(), x["idx_i"].numpy()
    np.testing.assert_array_equal(got.numpy(), _p8_closed_form(flat2, idx))
    if rows:
        body = pl.pallas_call(
            k_two, out_shape=jax.ShapeDtypeStruct((rows, L), jnp.float32),
            interpret=True)(jnp.asarray(flat2), jnp.asarray(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(body))


@pytest.mark.parametrize("c", [1, 7, 548])
def test_p8_plain_table_sizes(c):
    """The plain P8 on (C, 128) tables of 1, 7 and 548 rows, the indices
    opening with each chunk's first and last lane (as many chunks as 384
    indices hold): the closed form."""
    rng = np.random.default_rng(c)
    flat2 = rng.random((c, L), np.float32)
    idx = rng.integers(0, c * L, (3, L)).astype(np.int32)
    ends = np.arange(c)[:, None] * L + np.array([0, L - 1])
    idx.reshape(-1)[:ends.size] = ends.reshape(-1)[:3 * L]
    got = pg.gather_two_step_plain(torch.as_tensor(flat2),
                                   torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), _p8_closed_form(flat2, idx))


def test_probe_wrappers_reject_bad_inputs(x):
    with pytest.raises(TypeError, match="int32"):
        pg.gather_sublane(x["data_g"], x["idx_g"].long())
    with pytest.raises(TypeError, match="float32"):
        pg.gather_lane(x["data_h"].double(), x["idx_h"])
    with pytest.raises(ValueError, match="128"):
        pg.gather_two_step(x["flat2"], x["idx_i"][:, :64])
    with pytest.raises(ValueError, match="rows"):
        pg.gather_lane(x["data_h"][:8], x["idx_h"])
    with pytest.raises(ValueError, match="rows"):
        pg.onehot_matmul(x["data_g"], x["idx_j"])
    with pytest.raises(ValueError, match="expected"):
        pg.gather_sublane(x["data_g"], torch.zeros((64, 128),
                                                   dtype=torch.int32,
                                                   device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        pg.gather_sublane(x["data_g"].to("meta"),
                          x["idx_g"].to("meta"))


def _closed_form(tbl, idx):
    """P9's closed form in numpy: the selected row + 0.0 (so -0 becomes
    +0), and NaN in a column that holds an inf or NaN in another row."""
    bad = ~np.isfinite(tbl)
    k = idx.ravel()
    other = bad.sum(axis=0)[None] - bad[k] > 0
    return np.where(other, np.float32(np.nan), tbl[k] + np.float32(0.0)
                    ).reshape(idx.shape[0], L, L)


def test_p9_special_values_match_tpu_body_and_closed_form():
    """On a table of -0, +inf, -inf, NaN and all-negative columns, the
    plain P9 equals the TPU body ``k_mxu`` in interpret mode and the
    closed form the card kernel writes: NaN in the same places, equal
    values and sign bits elsewhere."""
    sv = pg.special_inputs(S, "cpu")
    got = pg.onehot_matmul(sv["tbl"], sv["idx"])
    body = _interpret("P9", dict(tbl_j=sv["tbl"], idx_j=sv["idx"]))
    closed = _closed_form(sv["tbl"].numpy(), sv["idx"].numpy())
    assert pg.equal_off_nan(got, torch.as_tensor(body.copy()))
    assert pg.equal_off_nan(got, torch.as_tensor(closed))
    rows = got.reshape(-1, L)
    # lane 1 selects row 9, whose -0 in the all-negative column 4 sums to +0
    assert rows[1, 4] == 0 and not rows[1, 4].signbit()
    assert rows[:, 3].lt(0).all()
    assert rows.isinf().any() and rows.isnan().any()


@pytest.mark.parametrize("rows", [1, 3, 65])
def test_p9_special_values_ragged_rows(rows):
    sv = pg.special_inputs(rows, "cpu")
    got = pg.onehot_matmul(sv["tbl"], sv["idx"])
    assert got.shape == (rows, L, L)
    assert pg.equal_off_nan(got, torch.as_tensor(_closed_form(
        sv["tbl"].numpy(), sv["idx"].numpy())))


def _misuse_cases():
    """One wrapper of each module and its arguments, made on a device."""
    from pathtracer_tpu_torch.ops.cuda import bvhw_cu, intersect_cu
    from pathtracer_tpu_torch.probes import gather as pg1

    def f32(*shape):
        return lambda dev: torch.zeros(shape, device=dev)

    def i32(*shape):
        return lambda dev: torch.zeros(shape, dtype=torch.int32, device=dev)
    return {
        "intersect_cu": (intersect_cu, intersect_cu.intersect,
                         [f32(8, 3), f32(8, 3), f32(8), f32(4, 12)]),
        "bvhw_cu": (bvhw_cu, bvhw_cu.bvhw_intersect,
                    [f32(2, 256), f32(8, 3), f32(8, 3), f32(8)]),
        "gather": (pg1, pg1.gather_rows, [f32(16, 8), i32(4)]),
        "gather2": (pg, pg.onehot_matmul, [f32(L, L), i32(1, L)]),
    }


@pytest.mark.parametrize("module", ["intersect_cu", "bvhw_cu", "gather",
                                    "gather2"])
def test_shared_launcher_rejects_misuse(module):
    """Every wrapper module checks its tensors through the shared
    launcher's one pass: tensors on a device that is neither cpu nor cuda
    raise, as does a tensor on another device than the first; neither
    counts a launch."""
    mod, fn, makers = _misuse_cases()[module]
    before = copy.deepcopy(mod.LAUNCHES)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn(*[make("meta") for make in makers])
    mixed = [make("cpu") for make in makers[:-1]] + [makers[-1]("meta")]
    with pytest.raises(ValueError, match="expected"):
        fn(*mixed)
    assert mod.LAUNCHES == before
