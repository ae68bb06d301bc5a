"""The port's shading stages on cornell hits against the JAX package:
make_interaction, matte gather_params / eval_f_pdf / sample_f, area-light
sample_li / pdf_li, and estimate_direct in both MIS modes, to rtol 1e-5.

Every stage gets the same inputs in both packages: the JAX package's hit
records of jittered camera rays, its interaction, numpy uniforms.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pathtracer_tpu import integrator as ji
from pathtracer_tpu.core.camera import generate_rays as jgenerate_rays
from pathtracer_tpu.ops import bsdf as jbx
from pathtracer_tpu.ops import interaction as jia
from pathtracer_tpu.ops import lights as jlt
from pathtracer_tpu.ops.intersect import intersect_brute
from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
from pathtracer_tpu_torch import integrator as pi
from pathtracer_tpu_torch.interop import scene_from_reference
from pathtracer_tpu_torch.ops import bsdf as pbx
from pathtracer_tpu_torch.ops import interaction as pia
from pathtracer_tpu_torch.ops import lights as plt

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


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


@pytest.fixture(scope="module")
def cornell():
    """Both packages' traced cornell scenes, the JAX hits of 32x32
    jittered camera rays, the JAX interaction at them and uniforms."""
    cam, sd, _ = jload_mitsuba("data/cornell-box.xml", resolution=(32, 32))
    jts = ji.TracedScene.create(sd, use_pallas=False)
    pts = pi.TracedScene.create(scene_from_reference(sd, device="cpu"))
    rng = np.random.default_rng(11)
    ys, xs = np.mgrid[0:32, 0:32]
    pf = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    pf += rng.uniform(0, 1, pf.shape).astype(np.float32)
    o, d = jgenerate_rays(*cam.ray_params(), jnp.asarray(pf))
    n = o.shape[0]
    hit = intersect_brute(o, d, jnp.full((n,), jnp.inf), jts.data.p0,
                          jts.data.p1, jts.data.p2)
    it = jia.make_interaction(jts.data, o, d, hit, jts.tri_attr)
    u = [rng.uniform(0, 1, (n, 2)).astype(np.float32) for _ in range(3)]
    light_idx = rng.integers(0, jts.n_lights, n).astype(np.int32)
    return dict(jts=jts, pts=pts, o=o, d=d, hit=hit, it=it, u=u,
                light_idx=light_idx, valid=np.asarray(hit["valid"]))


def _pit(it):
    return {k: _t(v) for k, v in it.items()}


def test_make_interaction_matches(cornell):
    c = cornell
    phit = {k: _t(v) for k, v in c["hit"].items()}
    got = pia.make_interaction(c["pts"].data, _t(c["o"]), _t(c["d"]), phit,
                               c["pts"].tri_attr)
    assert set(got) == set(c["it"])
    for key, want in c["it"].items():
        _close(got[key], want, c["valid"])
    le = pia.emitted_radiance(got, -_t(c["d"]))
    _close(le, jia.emitted_radiance(c["it"], -c["d"]), c["valid"])
    le2, lid = pia.hit_emission(c["pts"].tri_attr, phit, -_t(c["d"]))
    jle2, jlid = jia.hit_emission(c["jts"].tri_attr, c["hit"], -c["d"])
    _close(le2, jle2)
    _close(lid, jlid)
    assert c["valid"].mean() > 0.5


def test_matte_bsdf_matches(cornell):
    c = cornell
    jit, pit = c["it"], _pit(c["it"])
    jmp = jbx.gather_params(c["jts"].data, jit["material"], jit["uv"],
                            mat_attr=c["jts"].mat_attr, has_tex=False)
    pmp = pbx.gather_params(c["pts"].data, pit["material"], pit["uv"],
                            mat_attr=c["pts"].mat_attr)
    for key in pmp:
        _close(pmp[key], jmp[key])
    wo = ji._to_local(jit, -c["d"])
    wi = ji._to_local(jit, jnp.asarray(c["u"][0][:, [0, 1, 1]] - 0.5))
    ref = np.asarray(c["u"][1][:, 0] > 0.3)
    jf, jpdf = jbx.eval_f_pdf(jmp, wo, wi, jnp.asarray(ref),
                              present=c["jts"].mat_set)
    pf_, ppdf = pbx.eval_f_pdf(pmp, _t(wo), _t(wi), _t(ref),
                               present=c["pts"].mat_set)
    _close(pf_, jf)
    _close(ppdf, jpdf)
    jbs = jbx.sample_f(jmp, wo, jnp.asarray(c["u"][2]), lambda w: True,
                       present=c["jts"].mat_set)
    pbs = pbx.sample_f(pmp, _t(wo), _t(c["u"][2]), lambda w: True,
                       present=c["pts"].mat_set)
    for key in ("wi", "f", "pdf", "specular", "transmission"):
        _close(pbs[key], jbs[key])
    _close(pbx.has_nonspecular(pmp["mtype"]),
           jbx.has_nonspecular(jmp["mtype"]))
    # a material type present in the scene but on no lane changes nothing
    pbs2 = pbx.sample_f(pmp, _t(wo), _t(c["u"][2]), lambda w: True,
                        present=(0, 2))
    for key in ("wi", "f", "pdf", "specular", "transmission"):
        assert torch.equal(pbs2[key], pbs[key]), key


def test_area_light_sampling_matches(cornell):
    c = cornell
    jit, pit = c["it"], _pit(c["it"])
    jrows = c["jts"].light_attr[jnp.asarray(c["light_idx"])]
    prows = c["pts"].light_attr[_t(c["light_idx"]).long()]
    jls = jlt.sample_li(c["jts"].data, jrows, jit["p"], jit["p_error"],
                        jit["ng"], jnp.asarray(c["u"][0]),
                        light_set=c["jts"].light_set)
    pls = plt.sample_li(c["pts"].data, prows, pit["p"], pit["p_error"],
                        pit["ng"], _t(c["u"][0]),
                        light_set=c["pts"].light_set)
    assert set(pls) == set(jls)
    for key in jls:
        _close(pls[key], jls[key], c["valid"])
    wi = jls["wi"]
    jpdf = jlt.pdf_li(c["jts"].data, jrows, jit["p"], jit["p_error"],
                      jit["ng"], wi, light_set=c["jts"].light_set)
    ppdf = plt.pdf_li(c["pts"].data, prows, pit["p"], pit["p_error"],
                      pit["ng"], _t(wi), light_set=c["pts"].light_set)
    _close(ppdf, jpdf, c["valid"])
    assert (np.asarray(jpdf)[c["valid"]] > 0).mean() > 0.5


@pytest.mark.parametrize("mis_mode", ["ref", "onesample"])
def test_estimate_direct_matches(cornell, mis_mode):
    c = cornell
    one = mis_mode == "onesample"
    jcfg = ji.PathConfig(mis_mode=mis_mode)
    pcfg = pi.PathConfig(mis_mode=mis_mode)
    jit, pit = c["it"], _pit(c["it"])
    jmp = jbx.gather_params(c["jts"].data, jit["material"], jit["uv"],
                            mat_attr=c["jts"].mat_attr, has_tex=False)
    pmp = pbx.gather_params(c["pts"].data, pit["material"], pit["uv"],
                            mat_attr=c["pts"].mat_attr)
    pick = 1.0 / c["jts"].n_lights if one else 1.0
    jld = ji.estimate_direct(
        c["jts"], jcfg, jit, jmp, jnp.asarray(c["u"][1]),
        jnp.asarray(c["u"][0]), jnp.asarray(c["light_idx"]), -c["d"],
        bsdf_branch=not one, pick_prob=pick)
    pld = pi.estimate_direct(
        c["pts"], pcfg, pit, pmp, _t(c["u"][1]), _t(c["u"][0]),
        _t(c["light_idx"]), -_t(c["d"]), bsdf_branch=not one,
        pick_prob=pick)
    _close(pld, jld, c["valid"])
    assert (np.asarray(jld)[c["valid"]] > 0).any()
