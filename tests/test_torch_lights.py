"""The port's lights against the JAX package's: the point, distant and
infinite branches of ``sample_li`` / ``pdf_li`` (with the area branch
beside them), ``env_le``, ``_env_sample_li`` and ``env_pdf_li`` at
rtol 1e-5 / atol 1e-6 (the same f32 formulas; only the last bits of
transcendental functions differ between XLA's CPU kernels and
PyTorch's), and the Distribution1D / Distribution2D samples exactly (they
are IEEE adds, divides and searches, with the same ties).

Inputs are drawn with numpy from a seed; the environment is either a
small synthetic map with zero rows and zero texels (so the cdf tables
hold ties and uniform rows) or the repository's HDR map, as Config D
loads it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.core import sampling as jsm
from pathtracer_tpu.ops import lights as jlt
from pathtracer_tpu.scene import meshgen as jmeshgen
from pathtracer_tpu.scene.scene import SceneBuilder as JSceneBuilder
from pathtracer_tpu.scene.scene import pack_light_attr as jpack_light_attr
from pathtracer_tpu_torch.core import sampling as psm
from pathtracer_tpu_torch.ops import lights as plt
from pathtracer_tpu_torch.scene import meshgen as pmeshgen
from pathtracer_tpu_torch.scene.scene import (LIGHT_AREA, LIGHT_DISTANT,
                                              LIGHT_INFINITE, LIGHT_POINT)
from pathtracer_tpu_torch.scene.scene import SceneBuilder as PSceneBuilder
from pathtracer_tpu_torch.utils.image import read_hdr

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 4096
HDR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "abandoned_tank_farm_04_1k.hdr")


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, mask=None):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if mask is not None:
        g, w = g[mask], w[mask]
    if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _synthetic_env():
    rng = np.random.default_rng(21)
    img = rng.uniform(0, 4, (8, 16, 3)).astype(np.float32)
    img[0] = 0.0          # a zero row: uniform conditional
    img[3, 5:9] = 0.0     # zero texels: repeated cdf entries
    img[5, 2] = 50.0      # a bright spot
    return img


def _build(builder_cls, meshgen, env):
    b = builder_cls()
    mat = b.add_material(kd=(0.5, 0.5, 0.5))
    pos, idx, nrm, _ = meshgen.gen_rectangle()
    m = np.eye(4)
    m[:3, :3] *= 0.7
    m[:3, 3] = (0.3, 2.0, -0.2)
    p, n = meshgen.transform_mesh(pos, nrm, m)
    b.add_mesh(p, idx, n, None, mat, emission=np.float32([4.0, 3.0, 2.0]))
    b.add_mesh(pos * 3.0, idx, nrm, None, mat)
    b.add_point_light((0.0, 5.0, 2.0), (60.0, 50.0, 40.0))
    b.add_distant_light((-0.3, -1.0, -0.4), (1.5, 1.5, 1.4))
    a = 0.4
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]])
    b.set_environment(env, rot, scale=1.5)
    return b.build() if builder_cls is JSceneBuilder \
        else b.build(device="cpu")


@pytest.fixture(scope="module", params=["synthetic", "hdr"])
def scenes(request):
    env = _synthetic_env() if request.param == "synthetic" \
        else read_hdr(HDR)
    jsd = _build(JSceneBuilder, jmeshgen, env)
    psd = _build(PSceneBuilder, pmeshgen, env)
    return jsd, psd


def test_scene_tables_match(scenes):
    jsd, psd = scenes
    for name in ("light_type", "light_emit", "light_vec", "light_tri",
                 "env_map", "env_cond_func", "env_cond_cdf", "env_cond_int",
                 "env_marg_func", "env_marg_cdf", "env_marg_int",
                 "env_to_world", "world_to_env", "has_env", "n_lights"):
        np.testing.assert_array_equal(getattr(psd, name).numpy(),
                                      np.asarray(getattr(jsd, name)),
                                      err_msg=name)
    assert list(psd.light_type.numpy()) == [0, 0, 1, 2, 3]


def _uniforms(rng, n, cdf_u=None, cdf_v=None):
    """Uniforms in [0, 1), a share of them exactly on cdf entries (ties of
    the 'right' search)."""
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    if cdf_v is not None:
        k = n // 8
        u[:k, 1] = rng.choice(cdf_v[:-1], k)
        u[k:2 * k, 0] = rng.choice(cdf_u[:-1], k)
        u[2 * k:2 * k + 4] = 0.0
    return u


def _refs(rng, n):
    p = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    err = rng.uniform(0, 1e-6, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return p, err, nrm.astype(np.float32)


def _on_texel_edge(jsd, wi, eps=4e-6):
    """Directions within eps (in uv, some 40 ulps) of an edge of the
    environment's pdf table, or in its polar caps (v < 0.03 or v > 0.97),
    where the table's texel is ill-conditioned. In the caps
    acos is ill-conditioned: one ulp of the direction moves sin(theta) by
    about 6e-8 / sin(theta)^2 relative (over 1e-5 where sin(theta) <
    0.08) and moves the azimuth, and so the texel."""
    nv, nu = np.asarray(jsd.env_cond_func).shape
    uv = np.asarray(jlt.env_direction_to_uv(jsd, jnp.asarray(wi)))
    n = np.array([nu, nv])
    frac = np.abs(uv * n - np.round(uv * n))
    return (frac < eps * n).any(-1) | (uv[:, 1] < 0.03) | (uv[:, 1] > 0.97)


_SETS = [(LIGHT_POINT,), (LIGHT_DISTANT,), (LIGHT_INFINITE,),
         (LIGHT_AREA, LIGHT_POINT, LIGHT_DISTANT, LIGHT_INFINITE)]


@pytest.mark.parametrize("light_set", _SETS,
                         ids=["point", "distant", "infinite", "all"])
def test_sample_li_and_pdf_li_match(scenes, light_set):
    jsd, psd = scenes
    rng = np.random.default_rng(30 + len(light_set))
    types = np.asarray(psd.light_type.numpy())
    choice = np.nonzero(np.isin(types, light_set))[0]
    lidx = rng.choice(choice, N).astype(np.int64)
    jrows = jnp.asarray(jpack_light_attr(jsd))[lidx]
    prows = _t(jpack_light_attr(jsd))[lidx]
    p, err, nrm = _refs(rng, N)
    u = _uniforms(rng, N, np.asarray(jsd.env_cond_cdf)[0],
                  np.asarray(jsd.env_marg_cdf))
    jls = jlt.sample_li(jsd, jrows, jnp.asarray(p), jnp.asarray(err),
                        jnp.asarray(nrm), jnp.asarray(u), light_set=light_set)
    pls = plt.sample_li(psd, prows, _t(p), _t(err), _t(nrm), _t(u),
                        light_set=light_set)
    assert set(pls) == set(jls)
    for key in jls:
        _close(pls[key], jls[key])
    assert (np.asarray(jls["pdf"]) > 0).mean() > 0.3
    # along the sampled directions, leave out the lanes on a texel edge
    # of the pdf table (all whose u sits on a cdf entry, and a few more)
    # or in a polar cap: there the last bit of acos / atan2, which XLA
    # and PyTorch round differently, picks the texel
    wi_s = np.asarray(jls["wi"])
    for wi, mask in ((wi_s, ~_on_texel_edge(jsd, wi_s)),
                     (_refs(rng, N)[2], None)):
        jpdf = jlt.pdf_li(jsd, jrows, jnp.asarray(p), jnp.asarray(err),
                          jnp.asarray(nrm), jnp.asarray(wi),
                          light_set=light_set)
        ppdf = plt.pdf_li(psd, prows, _t(p), _t(err), _t(nrm), _t(wi),
                          light_set=light_set)
        _close(ppdf, jpdf, mask)


def test_env_functions_match(scenes):
    jsd, psd = scenes
    rng = np.random.default_rng(40)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1]]  # poles, seams
    _close(plt.env_pdf_li(psd, _t(d)), jlt.env_pdf_li(jsd, jnp.asarray(d)),
           ~_on_texel_edge(jsd, d))
    uv = rng.uniform(-0.2, 1.2, (N, 2)).astype(np.float32)
    _close(plt.env_lookup(psd, _t(uv)), jlt.env_lookup(jsd, jnp.asarray(uv)))
    puv = plt.env_direction_to_uv(psd, _t(d))
    _close(puv, jlt.env_direction_to_uv(jsd, jnp.asarray(d)))
    # env_le is the lookup at that uv: the bilinear weights scale the
    # last-bit difference of acos by the map's texel gradient, so its
    # parity is held piecewise, on the port's own uv
    _close(plt.env_le(psd, _t(d)), jlt.env_lookup(jsd, jnp.asarray(puv)))
    u = _uniforms(rng, N, np.asarray(jsd.env_cond_cdf)[1],
                  np.asarray(jsd.env_marg_cdf))
    for got, want in zip(plt._env_sample_li(psd, _t(u)),
                         jlt._env_sample_li(jsd, jnp.asarray(u))):
        _close(got, want)


def test_distributions_sample_exactly():
    rng = np.random.default_rng(50)
    func = rng.uniform(0, 1, (12, 20)).astype(np.float32)
    func[2] = 0.0
    func[5, 3:11] = 0.0
    jd, pd = jsm.Distribution2D.build(func), psm.Distribution2D.build(
        func, device="cpu")
    for name in ("cond_func", "cond_cdf", "cond_int", "marg_func",
                 "marg_cdf", "marg_int"):
        np.testing.assert_array_equal(getattr(pd, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    u = _uniforms(rng, N, np.asarray(jd.cond_cdf)[5],
                  np.asarray(jd.marg_cdf))
    juv, jpdf = jd.sample(jnp.asarray(u))
    puv, ppdf = pd.sample(_t(u))
    np.testing.assert_array_equal(puv.numpy(), np.asarray(juv))
    np.testing.assert_array_equal(ppdf.numpy(), np.asarray(jpdf))
    np.testing.assert_array_equal(pd.pdf(puv).numpy(),
                                  np.asarray(jd.pdf(juv)))
    d1 = psm.Distribution1D.build(func[5], device="cpu")
    j1 = jsm.Distribution1D.build(func[5])
    u1 = np.concatenate([u[:, 0], np.asarray(j1.cdf)[:-1]])
    for got, want in zip(
            psm.sample_distribution_1d(d1.func, d1.cdf, d1.func_int, _t(u1)),
            jsm.sample_distribution_1d(j1.func, j1.cdf, j1.func_int,
                                       jnp.asarray(u1))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = np.asarray(jd.cond_cdf)[rng.integers(0, 12, N)]
    np.testing.assert_array_equal(
        psm.searchsorted_batched(_t(rows), _t(u[:, 0])).numpy(),
        np.asarray(jsm.jax_searchsorted_batched(jnp.asarray(rows),
                                                jnp.asarray(u[:, 0]))))


def test_sphere_and_hemisphere_warps_match():
    rng = np.random.default_rng(60)
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    for name in ("uniform_sample_hemisphere", "uniform_sample_sphere"):
        _close(getattr(psm, name)(_t(u)),
               getattr(jsm, name)(jnp.asarray(u)))
    assert psm.uniform_hemisphere_pdf() == jsm.uniform_hemisphere_pdf()
    assert psm.uniform_sphere_pdf() == jsm.uniform_sphere_pdf()
