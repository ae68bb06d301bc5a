"""The port's BSDFs against the JAX package's and the scalar oracle.

Every material model, the Fresnel and Trowbridge-Reitz functions,
constant and checker ``eval_texture`` and the textured ``gather_params``
get the same inputs in both packages (directions, uniforms and material
ids drawn with numpy from a seed) and must agree to rtol 1e-5 / atol 1e-6:
both run the same f32 formulas, and only the last bits of transcendental
functions differ between XLA's CPU kernels and PyTorch's. Each material is
also held to ``tests/scalar_li.py``, the per-path numpy transcription of
the reference's BSDFs, at its own parity bar (rtol 1e-4 / atol 1e-5, as
``tests/test_scalar_parity.py`` holds the wavefront integrator), since
numpy evaluates some expressions in another order.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pathtracer_tpu.ops import bsdf as jbx
from pathtracer_tpu.scene import meshgen as jmeshgen
from pathtracer_tpu.scene.scene import SceneBuilder as JSceneBuilder
from pathtracer_tpu.scene.scene import pack_mat_attr as jpack_mat_attr
from pathtracer_tpu_torch.ops import bsdf as pbx
from pathtracer_tpu_torch.scene.scene import (MAT_DISNEY, MAT_GLASS,
                                              MAT_MATTE, MAT_METAL,
                                              MAT_MIRROR, MAT_ROUGHGLASS,
                                              MAT_SUBSTRATE)
from pathtracer_tpu_torch.scene.scene import SceneBuilder as PSceneBuilder

import scalar_li as sl

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 4096
ALL = pbx.ALL_MATERIALS


def _close(got, want, rtol=RTOL, atol=ATOL, mask=None):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if mask is not None:
        g, w = g[mask], w[mask]
    if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _t(x):
    return torch.tensor(np.asarray(x))


# material rows: (type, kwargs); texture ids refer to _textures' order
_MATERIALS = [
    (MAT_MATTE, dict(kd=(0.6, 0.5, 0.4))),
    (MAT_MATTE, dict(kd_tx=0)),
    (MAT_MIRROR, dict()),
    (MAT_GLASS, dict(kd=(1, 1, 1), ks=(0.9, 0.95, 1.0), eta=(1.5, 1.5, 1.5))),
    (MAT_METAL, dict(ks=(1, 1, 1), eta=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14),
                     rough=(0.1, 0.25))),
    (MAT_METAL, dict(ks=(0.9, 0.8, 0.7), eta=(1.1, 0.9, 0.3),
                     k=(2.0, 3.0, 4.0), rough=(0.3, 0.5), remap=True,
                     ks_tx=2)),
    (MAT_SUBSTRATE, dict(kd=(0.4, 0.2, 0.55), ks=(0.04, 0.04, 0.04),
                         rough=(0.05, 0.05))),
    (MAT_SUBSTRATE, dict(kd=(0.3, 0.6, 0.2), ks=(0.1, 0.1, 0.1),
                         rough=(0.3, 0.15), kd_tx=1)),
    (MAT_DISNEY, dict(kd=(0.7, 0.25, 0.2), eta=(1.5, 0, 0),
                      misc=(0.4, 0.4, 0.0, 0.0))),
    (MAT_DISNEY, dict(kd=(0.2, 0.5, 0.8), eta=(1.45, 0, 0),
                      misc=(0.9, 0.15, 0.0, 0.0), metallic_tx=2,
                      rough_tx=0)),
    (MAT_ROUGHGLASS, dict(kd=(1, 1, 1), ks=(1, 1, 1), eta=(1.5, 1.5, 1.5),
                          rough=(0.2, 0.3))),
]


def _build(builder_cls, meshgen):
    b = builder_cls()
    b.add_texture_checker((0.725, 0.71, 0.68), (0.25, 0.25, 0.3),
                          uv=(8, 8, 0, 0))
    b.add_texture_checker((0.9, 0.1, 0.2), (0.1, 0.8, 0.3),
                          uv=(3, 5, 0.25, -0.5))
    # a constant descriptor (kind 0), as importers make for scalar params
    b.txds.append(dict(kind=0, rgb0=(0.35, 0.5, 0.65), rgb1=(0, 0, 0),
                       scale=(1, 1, 1), uv=(1, 1, 0, 0), image=0,
                       channel=-1, srgb=False))
    for mtype, kw in _MATERIALS:
        b.add_material(mtype=mtype, **kw)
    pos, idx, nrm, _ = meshgen.gen_rectangle()
    b.add_mesh(pos, idx, nrm, None, 0)
    return b


@pytest.fixture(scope="module")
def scenes():
    from pathtracer_tpu_torch.scene import meshgen as pmeshgen
    jsd = _build(JSceneBuilder, jmeshgen).build()
    psd = _build(PSceneBuilder, pmeshgen).build(device="cpu")
    return jsd, psd


def _unit(rng, n, min_abs_z=0.02):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    # keep away from the exact horizon, where 1/cos amplifies last bits
    v[:, 2] = np.where(np.abs(v[:, 2]) < min_abs_z,
                       np.copysign(min_abs_z, v[:, 2]), v[:, 2])
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v.astype(np.float32)


def _inputs(mat_ids, seed):
    rng = np.random.default_rng(seed)
    n = len(mat_ids)
    return dict(
        mat_id=np.asarray(mat_ids, np.int32),
        uv=rng.uniform(-2, 2, (n, 2)).astype(np.float32),
        wo=_unit(rng, n), wi=_unit(rng, n),
        # a local geometric normal near the shading normal
        ng=(np.array([0, 0, 1.0]) + rng.normal(0, 0.2, (n, 3)))
        .astype(np.float32),
        u=rng.uniform(0, 1, (n, 2)).astype(np.float32))


def _params(scenes, x):
    jsd, psd = scenes
    jmp = jbx.gather_params(jsd, jnp.asarray(x["mat_id"]),
                            jnp.asarray(x["uv"]),
                            mat_attr=jnp.asarray(jpack_mat_attr(jsd)),
                            has_tex=True)
    pmp = pbx.gather_params(psd, _t(x["mat_id"]), _t(x["uv"]))
    return jmp, pmp


def _mats_of(types):
    return [i for i, (m, _) in enumerate(_MATERIALS) if m in types]


_CASES = [(m,) for m in ALL] + [ALL]


def test_gather_params_with_textures_matches(scenes):
    x = _inputs(np.arange(N) % len(_MATERIALS), 1)
    jmp, pmp = _params(scenes, x)
    assert set(pmp) == set(jmp)
    for key in jmp:
        _close(pmp[key], jmp[key])
    # the checker really varies kd over uv, and channels can be left out
    kd = pmp["kd"].numpy()[x["mat_id"] == 1]
    assert len(np.unique(kd, axis=0)) == 2
    off = pbx.gather_params(scenes[1], _t(x["mat_id"]), _t(x["uv"]),
                            tex_channels=(False, True, True, True))
    assert torch.equal(off["ks"], pmp["ks"])
    assert not torch.equal(off["kd"], pmp["kd"])


def test_eval_texture_constant_and_checker(scenes):
    jsd, psd = scenes
    rng = np.random.default_rng(2)
    txd = rng.integers(-1, 3, N).astype(np.int32)
    uv = rng.uniform(-3, 3, (N, 2)).astype(np.float32)
    fb = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    want = jbx.eval_texture(jsd, jnp.asarray(txd), jnp.asarray(uv),
                            jnp.asarray(fb))
    got = pbx.eval_texture(psd, _t(txd), _t(uv), _t(fb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[txd < 0] == fb[txd < 0]).all()


def test_image_texture_raises():
    """Image descriptors build and evaluate as the reference's do (their
    lookup is held in tests/test_torch_textures.py). An image used as an
    alpha mask no longer raises (the alpha path landed): the cut test
    ``_alpha_cut`` reads the mask through ``eval_texture`` at width 0,
    the descriptor's scale included, and cuts the hits whose value is
    exactly 0, as the reference's does."""
    img = np.random.default_rng(3).random((4, 4, 3)).astype(np.float32)
    img[:2] = 0.0  # rows 0-1 zero: v in [0.125, 0.375) reads exactly 0
    builders = {}
    for name, cls in (("jax", JSceneBuilder), ("port", PSceneBuilder)):
        b = cls()
        tx = b.add_texture_image(img, scale=(0.5, 1.0, 2.0))
        b.add_material(mtype=MAT_MATTE, kd_tx=tx)
        b.add_mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                   np.array([[0, 1, 2]]), None, None, 0, alpha_txd=tx)
        builders[name] = b.build() if name == "jax" else \
            b.build(device="cpu")
    uv = np.random.default_rng(4).uniform(0, 1, (8, 2)).astype(np.float32)
    want = jbx.eval_texture(builders["jax"], jnp.zeros(8, jnp.int32),
                            jnp.asarray(uv), jnp.zeros((8, 3)))
    got = pbx.eval_texture(builders["port"], torch.zeros(8, dtype=torch.int32),
                           _t(uv), torch.zeros(8, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    from pathtracer_tpu.integrator import TracedScene as JTracedScene
    from pathtracer_tpu.integrator import _alpha_cut as j_alpha_cut
    from pathtracer_tpu_torch.integrator import TracedScene, _alpha_cut
    ts = TracedScene.create(builders["port"])
    jts = JTracedScene.create(builders["jax"], use_pallas=False)
    assert ts.has_alpha and not ts.use_bvh
    # hits on the triangle at random points
    rng = np.random.default_rng(5)
    b = rng.dirichlet([1, 1, 1], 256).astype(np.float32)
    valid = rng.random(256) < 0.9
    hit = dict(valid=valid, t=np.ones(256, np.float32),
               tri=np.zeros(256, np.int32), b=b)
    cut = _alpha_cut(ts, {k: _t(v) for k, v in hit.items()})
    j_cut = j_alpha_cut(jts, {k: jnp.asarray(v) for k, v in hit.items()})
    for got, want in zip(cut, j_cut):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    sd = ts.data
    uv = (_t(b[:, 0:1]) * sd.uv0[0] + _t(b[:, 1:2]) * sd.uv1[0]
          + _t(b[:, 2:3]) * sd.uv2[0])
    mask = pbx.eval_texture(sd, torch.zeros(256, dtype=torch.int32), uv,
                            torch.ones(256, 3))[:, 0]
    assert torch.equal(cut[0], _t(valid) & (mask == 0.0))
    assert cut[0].any() and not cut[0].all()


@pytest.mark.parametrize("present", _CASES,
                         ids=lambda p: "all" if len(p) > 1 else f"type{p[0]}")
def test_eval_f_pdf_matches_jax(scenes, present):
    mats = _mats_of(present)
    x = _inputs(np.asarray(mats)[np.arange(N) % len(mats)], 3)
    jmp, pmp = _params(scenes, x)
    ref = (x["wi"] @ np.ones(3) > -5.0) & \
        (np.sum(x["wi"] * x["ng"], -1) * np.sum(x["wo"] * x["ng"], -1) > 0)
    jf, jpdf = jbx.eval_f_pdf(jmp, jnp.asarray(x["wo"]), jnp.asarray(x["wi"]),
                              jnp.asarray(ref), present=present)
    pf, ppdf = pbx.eval_f_pdf(pmp, _t(x["wo"]), _t(x["wi"]), _t(ref),
                              present=present)
    _close(pf, jf)
    _close(ppdf, jpdf)
    if set(present) - {MAT_MIRROR, MAT_GLASS}:
        assert (np.asarray(jpdf) > 0).mean() > 0.2


@pytest.mark.parametrize("present", _CASES,
                         ids=lambda p: "all" if len(p) > 1 else f"type{p[0]}")
def test_sample_f_matches_jax(scenes, present):
    mats = _mats_of(present)
    x = _inputs(np.asarray(mats)[np.arange(N) % len(mats)], 4)
    jmp, pmp = _params(scenes, x)
    jng, png = jnp.asarray(x["ng"]), _t(x["ng"])
    jwo, pwo = jnp.asarray(x["wo"]), _t(x["wo"])

    def jfn(wi):
        return jnp.sum(wi * jng, -1) * jnp.sum(jwo * jng, -1) > 0.0

    def pfn(wi):
        return (wi * png).sum(-1) * (pwo * png).sum(-1) > 0.0

    jbs = jbx.sample_f(jmp, jwo, jnp.asarray(x["u"]), jfn, present=present)
    pbs = pbx.sample_f(pmp, pwo, _t(x["u"]), pfn, present=present)
    assert set(pbs) == set(jbs)
    for key in ("wi", "f", "pdf", "specular", "transmission"):
        _close(pbs[key], jbs[key])
    assert (np.asarray(jbs["pdf"]) > 0).mean() > 0.3


def test_fresnel_and_trowbridge_reitz_match():
    rng = np.random.default_rng(6)
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    eta = rng.uniform(1.0, 2.5, N).astype(np.float32)
    eta3 = rng.uniform(0.1, 2.0, (N, 3)).astype(np.float32)
    k3 = rng.uniform(0.0, 5.0, (N, 3)).astype(np.float32)
    c0 = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    met = rng.uniform(0, 1, N).astype(np.float32)
    one = np.ones(N, np.float32)
    j, p = jnp.asarray, _t
    _close(pbx.fr_dielectric(p(cos), p(one), p(eta)),
           jbx.fr_dielectric(j(cos), j(one), j(eta)))
    _close(pbx.fr_conductor(p(np.abs(cos)), p(np.ones((N, 3), np.float32)),
                            p(eta3), p(k3)),
           jbx.fr_conductor(j(np.abs(cos)), j(np.ones((N, 3), np.float32)),
                            j(eta3), j(k3)))
    _close(pbx.schlick_weight(p(cos)), jbx.schlick_weight(j(cos)))
    _close(pbx.fr_schlick_spectrum(p(c0), p(cos)),
           jbx.fr_schlick_spectrum(j(c0), j(cos)))
    _close(pbx.disney_fresnel(p(c0), p(met), p(eta), p(cos)),
           jbx.disney_fresnel(j(c0), j(met), j(eta), j(cos)))
    rough = rng.uniform(0.0005, 1.0, N).astype(np.float32)
    _close(pbx.roughness_to_alpha(p(rough)), jbx.roughness_to_alpha(j(rough)))

    ax = rng.uniform(0.01, 0.8, N).astype(np.float32)
    ay = rng.uniform(0.01, 0.8, N).astype(np.float32)
    wo, wh = _unit(rng, N), _unit(rng, N)
    wh[:, 2] = np.abs(wh[:, 2])
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    sep = rng.uniform(size=N) < 0.5
    for name, args in (("tr_d", (wh, ax, ay)), ("tr_lambda", (wo, ax, ay)),
                       ("tr_g1", (wo, ax, ay)),
                       ("tr_pdf", (wo, wh, ax, ay)),
                       ("tr_sample_wh", (wo, u, ax, ay))):
        _close(getattr(pbx, name)(*map(p, args)),
               getattr(jbx, name)(*map(j, args)))
    _close(pbx.tr_g(p(wo), p(wh), p(ax), p(ay), p(sep)),
           jbx.tr_g(j(wo), j(wh), j(ax), j(ay), j(sep)))
    wt, ok = pbx.refract(p(wo), p(wh), p(1.0 / eta))
    jwt, jok = jbx.refract(j(wo), j(wh), j(1.0 / eta))
    _close(ok, jok)
    _close(wt, jwt, mask=np.asarray(jok))


# --- against the scalar oracle (tests/scalar_li.py)

_ORACLE_RTOL, _ORACLE_ATOL = 1e-4, 1e-5


class _HostMaterials:
    """The attributes of scalar_li.HostScene its BSDFs read."""

    def __init__(self, sd):
        for name in ("mat_type", "mat_kd", "mat_ks", "mat_eta", "mat_k",
                     "mat_rough", "mat_remap", "mat_misc"):
            setattr(self, name, getattr(sd, name).numpy())


@pytest.mark.parametrize("mtype", ALL)
def test_material_matches_scalar_oracle(scenes, mtype):
    """f and pdf of NEE's branch and sample_f, lane by lane, in an
    identity shading frame (ss, ts, ns = x, y, z; ng = z), for the
    untextured materials of each type."""
    psd = scenes[1]
    hs = _HostMaterials(psd)
    mats = [i for i in _mats_of((mtype,))
            if "_tx" not in "".join(_MATERIALS[i][1])]
    n = 256
    x = _inputs(np.asarray(mats)[np.arange(n) % len(mats)], 8)
    pmp = pbx.gather_params(psd, _t(x["mat_id"]), _t(x["uv"]))
    wo, wi, u = x["wo"], x["wi"], x["u"]
    ref = wi[:, 2] * wo[:, 2] > 0.0
    pf, ppdf = pbx.eval_f_pdf(pmp, _t(wo), _t(wi), _t(ref), present=(mtype,))
    pbs = pbx.sample_f(pmp, _t(wo), _t(u),
                       lambda w: w[..., 2] * _t(wo[:, 2]) > 0.0,
                       present=(mtype,))
    ez = np.eye(3, dtype=np.float32)
    for i in range(n):
        it = dict(ss=ez[0], ts=ez[1], ns=ez[2], ng=ez[2],
                  material=int(x["mat_id"][i]))
        np.testing.assert_allclose(pf[i].numpy(),
                                   sl.bsdf_f(hs, it, wo[i], wi[i]),
                                   rtol=_ORACLE_RTOL, atol=_ORACLE_ATOL)
        np.testing.assert_allclose(ppdf[i].item(),
                                   sl.bsdf_pdf(hs, it, wo[i], wi[i]),
                                   rtol=_ORACLE_RTOL, atol=_ORACLE_ATOL)
        f, wi_w, pdf, spec, trans = sl.bsdf_sample_f(hs, it, wo[i], u[i])
        np.testing.assert_allclose(pbs["pdf"][i].item(), pdf,
                                   rtol=_ORACLE_RTOL, atol=_ORACLE_ATOL)
        np.testing.assert_allclose(pbs["f"][i].numpy(), f,
                                   rtol=_ORACLE_RTOL, atol=_ORACLE_ATOL)
        assert bool(pbs["specular"][i]) == spec
        if pdf > 0:
            np.testing.assert_allclose(pbs["wi"][i].numpy(), wi_w,
                                       rtol=_ORACLE_RTOL, atol=_ORACLE_ATOL)
            assert bool(pbs["transmission"][i]) == trans
