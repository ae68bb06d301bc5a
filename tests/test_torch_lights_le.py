"""The emission API (``power``, ``sample_le``, ``pdf_le``) of the port
against the JAX package's, and the reference's own consistency cases
(tests/test_lights_le.py) on the port.

Light rows: a triangle area light, a point, a distant and an infinite
light in one scene (the reference test's); config B's point and distant
lights; config D's environment. Uniforms from numpy, shared by both
packages; every output at rtol 1e-5 / atol 1e-6 (the same f32 formulas;
only transcendental last bits and the map mean's summation order differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import lights as jlt
from pathtracer_tpu.scene import procedural as jprocedural
from pathtracer_tpu.scene.scene import SceneBuilder as JSceneBuilder
from pathtracer_tpu.scene.scene import pack_light_attr as jpack_light_attr
from pathtracer_tpu_torch.ops.lights import ALL_LIGHTS, pdf_le, power, \
    sample_le
from pathtracer_tpu_torch.scene import procedural
from pathtracer_tpu_torch.scene.scene import (MAT_MATTE, SceneBuilder,
                                              pack_light_attr)

torch.set_num_threads(1)

EMIT = np.array([4.0, 5.0, 6.0], np.float32)
INTENS = np.array([2.0, 3.0, 4.0], np.float32)
RAD = np.array([1.0, 0.5, 0.25], np.float32)


def _fill(b):
    mat = b.add_material(mtype=MAT_MATTE, kd=(0.5, 0.5, 0.5))
    p = np.array([[0, 0, 0], [2, 0, 0], [0, 3, 0]], np.float32)
    b.add_mesh(p, np.array([[0, 1, 2]], np.int32), None, None, mat,
               emission=EMIT)
    b.add_point_light([1.0, 2.0, 3.0], INTENS)
    b.add_distant_light([0.0, -1.0, 0.5], RAD)
    b.set_environment(np.ones((4, 8, 3), np.float32), np.eye(3))
    # light indices: 0 = area triangle, 1 = point, 2 = distant, 3 = infinite


def _scene():
    b = SceneBuilder()
    _fill(b)
    return b.build(device="cpu")


def _jscene():
    b = JSceneBuilder()
    _fill(b)
    return b.build()


def _rows(sd, idx, n):
    la = pack_light_attr(sd)
    return torch.as_tensor(np.tile(la[idx][None, :], (n, 1)))


def _draws(n, seed=7):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.random((n, 2), np.float32)),
            torch.as_tensor(rng.random((n, 2), np.float32)))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _scenes(name):
    """(port scene, JAX scene, light indices) of one case."""
    if name == "mixed":
        return _scene(), _jscene(), [0, 1, 2, 3]
    builder = {"B": "small_scene", "D": "envmap_disney_scene"}[name]
    _, sd = getattr(procedural, builder)((16, 16), device="cpu")
    _, jsd = getattr(jprocedural, builder)((16, 16))
    return sd, jsd, list(range(int(sd.n_lights)))


@pytest.mark.parametrize("name", ["mixed", "B", "D"])
def test_emission_api_matches_jax(name):
    sd, jsd, lights = _scenes(name)
    n = 1024
    u_pos, u_dir = _draws(n, seed=5)
    la = pack_light_attr(sd)
    np.testing.assert_array_equal(la, np.asarray(jpack_light_attr(jsd)))
    lset = tuple(sorted(set(sd.light_type.tolist())))
    # every light of the scene, mixed in one batch and one by one
    idx = np.arange(n) % len(lights)
    batches = [idx] + [np.full(n, i) for i in lights]
    for b in batches:
        rows = torch.as_tensor(la[b])
        jrows = jnp.asarray(la[b])
        s = sample_le(sd, rows, u_pos, u_dir, light_set=lset)
        js = jlt.sample_le(jsd, jrows, jnp.asarray(u_pos.numpy()),
                           jnp.asarray(u_dir.numpy()), light_set=lset)
        for key in ("o", "d", "n_light", "pdf_pos", "pdf_dir", "le"):
            _close(s[key], js[key])
        pp, pd = pdf_le(sd, rows, s["d"], s["n_light"], light_set=lset)
        jpp, jpd = jlt.pdf_le(jsd, jrows, jnp.asarray(s["d"].numpy()),
                              jnp.asarray(s["n_light"].numpy()),
                              light_set=lset)
        _close(pp, jpp)
        _close(pd, jpd)
        _close(power(sd, rows, lset), jlt.power(jsd, jrows, lset))
    # the whole light_set evaluated (types absent from the scene too)
    rows = torch.as_tensor(la[idx])
    s = sample_le(sd, rows, u_pos, u_dir)
    js = jlt.sample_le(jsd, jnp.asarray(la[idx]), jnp.asarray(u_pos.numpy()),
                       jnp.asarray(u_dir.numpy()))
    for key in ("o", "d", "pdf_pos", "pdf_dir", "le"):
        _close(s[key], js[key])


# --- the reference's consistency cases on the port


def test_area_power_estimator_zero_variance():
    sd = _scene()
    n = 1024
    rows = _rows(sd, 0, n)
    u_pos, u_dir = _draws(n)
    s = sample_le(sd, rows, u_pos, u_dir)
    cos = torch.sum(s["n_light"] * s["d"], -1).numpy()
    est = s["le"].numpy() * cos[:, None] / (
        s["pdf_pos"].numpy() * s["pdf_dir"].numpy())[:, None]
    area = 0.5 * np.linalg.norm(np.cross([2, 0, 0], [0, 3, 0]))
    phi = EMIT * area * np.pi
    np.testing.assert_allclose(est, np.tile(phi, (n, 1)), rtol=2e-4)
    np.testing.assert_allclose(power(sd, rows, ALL_LIGHTS)[0].numpy(), phi,
                               rtol=1e-5)


def test_sample_pdf_le_consistency():
    sd = _scene()
    n = 512
    u_pos, u_dir = _draws(n, seed=11)
    for idx, check_pos, check_dir in ((0, True, True), (1, False, True),
                                      (2, True, False), (3, True, True)):
        rows = _rows(sd, idx, n)
        s = sample_le(sd, rows, u_pos, u_dir)
        pp, pd = pdf_le(sd, rows, s["d"], s["n_light"])
        if check_pos:
            np.testing.assert_allclose(pp.numpy(), s["pdf_pos"].numpy(),
                                       rtol=1e-4, err_msg=f"light {idx}")
        else:
            assert (pp.numpy() == 0).all()
        if check_dir:
            np.testing.assert_allclose(pd.numpy(), s["pdf_dir"].numpy(),
                                       rtol=2e-3, atol=1e-6,
                                       err_msg=f"light {idx}")
        else:
            assert (pd.numpy() == 0).all()
        np.testing.assert_allclose(
            np.linalg.norm(s["d"].numpy(), axis=-1), 1.0, atol=1e-5)


def test_point_light_sphere_sampling():
    sd = _scene()
    n = 4096
    rows = _rows(sd, 1, n)
    u_pos, u_dir = _draws(n, seed=3)
    s = sample_le(sd, rows, u_pos, u_dir)
    assert np.abs(s["d"].numpy().mean(0)).max() < 0.05
    np.testing.assert_allclose(s["o"].numpy(), np.tile([1, 2, 3], (n, 1)),
                               atol=1e-6)
    np.testing.assert_allclose(s["pdf_dir"].numpy(), 0.25 / np.pi,
                               rtol=1e-6)
    np.testing.assert_allclose(power(sd, rows)[0].numpy(),
                               4 * np.pi * INTENS, rtol=1e-5)


def test_distant_light_disk_origin():
    sd = _scene()
    n = 256
    rows = _rows(sd, 2, n)
    u_pos, u_dir = _draws(n, seed=5)
    s = sample_le(sd, rows, u_pos, u_dir)
    w = np.array([0.0, -1.0, 0.5]) / np.linalg.norm([0.0, -1.0, 0.5])
    np.testing.assert_allclose(s["d"].numpy(), np.tile(-w, (n, 1)),
                               atol=1e-6)
    r = float(sd.world_radius)
    off = s["o"].numpy() - sd.world_center.numpy()
    np.testing.assert_allclose(off @ w, r, rtol=1e-4)
    assert (np.linalg.norm(off - np.outer(off @ w, w), axis=-1)
            <= r * (1 + 1e-4)).all()
    np.testing.assert_allclose(s["pdf_pos"].numpy(), 1.0 / (np.pi * r * r),
                               rtol=1e-5)


def test_env_emission_furnace():
    sd = _scene()
    n = 8192
    rows = _rows(sd, 3, n)
    u_pos, u_dir = _draws(n, seed=13)
    s = sample_le(sd, rows, u_pos, u_dir)
    np.testing.assert_allclose(s["le"].numpy(), 1.0, rtol=1e-5)
    inv = 1.0 / s["pdf_dir"].numpy()
    np.testing.assert_allclose(inv.mean(), 4 * np.pi, rtol=0.05)
