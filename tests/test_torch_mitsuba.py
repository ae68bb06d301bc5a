"""The Mitsuba importer: every arm of the reference's loaded by both
packages and compared leaf for leaf, its errors, and the feature scene
(``tests/torch_mitsuba_scenes.py``, 392 triangles: the BVH route, K2 on
the card, the plain traversal here) rendered against the JAX package.

The reference resolves a bitmap's filename against the working directory
(its ``_material_from_bsdf`` does not pass the scene's directory on); the
port against the scene's directory, as it does OBJ and envmap files. The
leaf comparisons run from the scene's directory, where both agree;
``test_bitmap_resolves_against_the_scene_directory`` shows the difference.

The feature scene's wave is held lane for lane against the JAX bounce
functions run op by op (same live lanes and ray counts after every
bounce, radiance to rtol 1e-3 / atol 1e-5: the two packages' ``acos``
differ in the last bit, and a camera ray that leaves through the open
front exactly level lands on the environment's pdf table row 256 in the
port and 255 in JAX, which moves its MIS weight by 5e-4); its film
against the jitted
JAX film, where XLA's fusion flips a few grazing lanes whose paths end on
the light through glass or the mirror (ROADMAP Queue 3): alpha rtol
1e-5, ray count within 1e-3, and all but 2 % of the pixels within 1e-3.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mitsuba_scenes as ms
from pathtracer_tpu import integrator as ji
from pathtracer_tpu.ops import sobol as jsb
from pathtracer_tpu.scene.mitsuba import load_mitsuba as jload_mitsuba
from pathtracer_tpu_torch import integrator as pi
from pathtracer_tpu_torch.interop import traced_scene_from_reference
from pathtracer_tpu_torch.ops import sobol as psb
from pathtracer_tpu_torch.scene import mitsuba
from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba
from pathtracer_tpu_torch.scene.scene import (MAT_GLASS, MAT_MATTE,
                                              MAT_METAL, MAT_MIRROR,
                                              MAT_ROUGHGLASS, MAT_SUBSTRATE)
from torch_leaves import assert_scene_equal

torch.set_num_threads(1)


def _load_both(tmp_path, monkeypatch, xml, resolution=(24, 20)):
    """Write ``xml`` into tmp_path, load it with both packages from
    there; the leaves, the camera and the settings must agree."""
    path = tmp_path / "scene.xml"
    path.write_text(xml)
    monkeypatch.chdir(tmp_path)
    cam, sd, settings = load_mitsuba(str(path), resolution=resolution,
                                     device="cpu")
    jcam, jsd, jsettings = jload_mitsuba(str(path), resolution=resolution)
    assert_scene_equal(sd, jsd)
    assert settings == jsettings
    np.testing.assert_array_equal(cam.cam_to_world, jcam.cam_to_world)
    np.testing.assert_array_equal(cam.raster_to_camera,
                                  jcam.raster_to_camera)
    return sd


def _shape(ref):
    return ('<shape type="cube"><transform name="toWorld"><matrix '
            'value="0.3 0 0 0 0 0.3 0 0.3 0 0 0.3 0 0 0 0 1"/></transform>'
            f'<ref id="{ref}"/></shape>')


BSDF_ARMS = {
    "diffuse": ('<bsdf type="diffuse" id="X"><rgb name="reflectance" '
                'value="0.2 0.4 0.6"/></bsdf>', MAT_MATTE),
    "diffuse_default": ('<bsdf type="diffuse" id="X"/>', MAT_MATTE),
    "checkerboard": ('<bsdf type="diffuse" id="X"><texture '
                     'type="checkerboard"><rgb name="color0" value="0.1, '
                     '0.2, 0.3"/><float name="uscale" value="4"/><float '
                     'name="voffset" value="0.25"/></texture></bsdf>',
                     MAT_MATTE),
    "bitmap": ('<bsdf type="twosided" id="X"><bsdf type="diffuse"><texture '
               'type="bitmap"><string name="filename" value="picture.png"/>'
               '</texture></bsdf></bsdf>', MAT_MATTE),
    "conductor_none": ('<bsdf type="conductor" id="X"><string '
                       'name="material" value="none"/></bsdf>', MAT_MIRROR),
    "conductor": ('<bsdf type="conductor" id="X"><rgb name="eta" value="0.2 '
                  '0.9 1.1"/><rgb name="k" value="3.9 2.4 2.1"/><rgb '
                  'name="specular_reflectance" value="0.9 0.8 0.7"/></bsdf>',
                  MAT_METAL),
    "roughconductor": ('<bsdf type="roughconductor" id="X"><float '
                       'name="alpha" value="0.3"/></bsdf>', MAT_METAL),
    "dielectric": ('<bsdf type="dielectric" id="X"><float name="int_ior" '
                   'value="1.33"/></bsdf>', MAT_GLASS),
    "roughdielectric": ('<bsdf type="roughdielectric" id="X"/>',
                        MAT_ROUGHGLASS),
    "plastic": ('<bsdf type="plastic" id="X"><rgb '
                'name="diffuse_reflectance" value="0.1 0.5 0.2"/></bsdf>',
                MAT_SUBSTRATE),
    "roughplastic": ('<bsdf type="twosided" id="X"><bsdf '
                     'type="roughplastic"><float name="alpha" value="0.05"/>'
                     '<float name="int_ior" value="1.7"/></bsdf></bsdf>',
                     MAT_SUBSTRATE),
}


@pytest.mark.parametrize("arm", sorted(BSDF_ARMS))
def test_bsdf_arm_matches_jax(arm, tmp_path, monkeypatch):
    bsdf, mtype = BSDF_ARMS[arm]
    ms.write_picture_png(str(tmp_path / "picture.png"))
    sd = _load_both(tmp_path, monkeypatch,
                    ms.scene_xml(bsdf, _shape("X")))
    assert int(sd.mat_type[-1]) == mtype
    if arm in ("checkerboard", "bitmap"):
        assert int(sd.mat_kd_tx[-1]) >= 0
        assert int(sd.txd_kind[-1]) == (2 if arm == "bitmap" else 1)


SHAPES = {
    "sphere": ('<shape type="sphere"><point name="center" x="0.1" y="0.5" '
               'z="-0.2"/><float name="radius" value="0.4"/><transform '
               'name="toWorld"><matrix value="3 0 0 1 0 3 0 1 0 0 3 1 0 0 '
               '0 1"/></transform><ref id="Floor"/></shape>', 180),
    "sphere_default": ('<shape type="sphere"><ref id="Floor"/></shape>',
                       180),
    "obj": ('<shape type="obj"><string name="filename" value="gem.obj"/>'
            '<transform name="toWorld"><matrix value="0.2 0 0 0 0 0.2 0 1 '
            '0 0 0.2 0 0 0 0 1"/></transform><bsdf type="diffuse"/></shape>',
            8),
    "obj_face_normals": ('<shape type="obj"><string name="filename" '
                         'value="gem.obj"/><boolean name="faceNormals" '
                         'value="true"/><ref id="Floor"/></shape>', 8),
    "obj_emitter": ('<shape type="obj"><string name="filename" '
                    'value="gem.obj"/><ref id="Floor"/><emitter type="area">'
                    '<rgb name="radiance" value="1 2 3"/></emitter></shape>',
                    8),
    "point_emitter_ignored": ('<shape type="cube"><ref id="Floor"/><emitter '
                              'type="point"><rgb name="intensity" value="1 1 '
                              '1"/></emitter></shape>', 12),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shape_arm_matches_jax(shape, tmp_path, monkeypatch):
    xml, n_tris = SHAPES[shape]
    ms.write_octahedron_obj(str(tmp_path / "gem.obj"))
    sd = _load_both(tmp_path, monkeypatch, ms.scene_xml(shapes=xml))
    assert sd.p0.shape[0] == 12 + n_tris
    has_n = sd.has_normals[12:].numpy()
    assert has_n.all() == (shape != "obj_face_normals")
    n_lights = 2 + (8 if shape == "obj_emitter" else 0)
    assert int(sd.n_lights) == n_lights


EMITTERS = {
    "envmap": lambda d: ms.feature_emitter(os.path.relpath(ms.HDR, d)),
    "envmap_plain": lambda d: ('<emitter type="envmap"><string '
                               f'name="filename" value="{ms.HDR}"/>'
                               '</emitter>'),
    "sunsky": lambda d: '<emitter type="sunsky"/>',
    "unknown_ignored": lambda d: ('<emitter type="spot"><rgb '
                                  'name="intensity" value="1 1 1"/>'
                                  '</emitter>'),
}


@pytest.mark.parametrize("emitter", sorted(EMITTERS))
def test_scene_emitter_matches_jax(emitter, tmp_path, monkeypatch):
    sd = _load_both(tmp_path, monkeypatch, ms.scene_xml(
        emitters=EMITTERS[emitter](str(tmp_path))))
    assert bool(sd.has_env) == (emitter != "unknown_ignored")
    assert int(sd.n_lights) == 2 + bool(sd.has_env)


def test_sunsky_without_the_map_adds_nothing(tmp_path, monkeypatch):
    """The sunsky stand-in needs the repository's HDR; without it the
    emitter is ignored, as in the reference."""
    monkeypatch.setattr(mitsuba, "SUNSKY_HDR", str(tmp_path / "none.hdr"))
    path = tmp_path / "scene.xml"
    path.write_text(ms.scene_xml(emitters='<emitter type="sunsky"/>'))
    _, sd, _ = load_mitsuba(str(path), device="cpu")
    assert not bool(sd.has_env) and int(sd.n_lights) == 2


@pytest.mark.parametrize("filename", ["missing.png", "picture.jpg"])
def test_missing_or_non_png_bitmap_gives_no_texture(filename, tmp_path,
                                                    monkeypatch):
    (tmp_path / "picture.jpg").write_bytes(b"not read")
    bsdf = ('<bsdf type="diffuse" id="X"><texture type="bitmap"><string '
            f'name="filename" value="{filename}"/></texture></bsdf>')
    sd = _load_both(tmp_path, monkeypatch, ms.scene_xml(bsdf, _shape("X")))
    assert int(sd.mat_kd_tx[-1]) == -1


def test_bitmap_resolves_against_the_scene_directory(tmp_path, monkeypatch):
    scene_dir = tmp_path / "scene"
    scene_dir.mkdir()
    ms.write_picture_png(str(scene_dir / "picture.png"))
    bsdf = BSDF_ARMS["bitmap"][0]
    path = scene_dir / "scene.xml"
    path.write_text(ms.scene_xml(bsdf, _shape("X")))
    monkeypatch.chdir(tmp_path)
    _, sd, _ = load_mitsuba(str(path), device="cpu")
    _, jsd, _ = jload_mitsuba(str(path))
    assert int(sd.mat_kd_tx[-1]) >= 0
    assert int(jsd.mat_kd_tx[-1]) == -1  # the reference looks in "."


@pytest.mark.parametrize("kind,xml", [
    ("bsdf", ms.scene_xml('<bsdf type="hair" id="X"/>', _shape("X"))),
    ("shape", ms.scene_xml(shapes='<shape type="disk"><ref id="Floor"/>'
                                  '</shape>')),
    ("material", ms.scene_xml(shapes='<shape type="cube"/>')),
])
def test_errors_match_jax(kind, xml, tmp_path):
    path = tmp_path / "scene.xml"
    path.write_text(xml)
    msg = {"bsdf": "unsupported bsdf type: hair",
           "shape": "unsupported shape type: disk",
           "material": "material ref or inline bsdf"}[kind]
    with pytest.raises(ValueError, match=msg):
        load_mitsuba(str(path), device="cpu")
    with pytest.raises(ValueError, match=msg):
        jload_mitsuba(str(path))


@pytest.fixture(scope="module")
def feature(tmp_path_factory):
    return ms.write_feature_scene(str(tmp_path_factory.mktemp("feature")))


def test_feature_scene_matches_jax(feature, monkeypatch):
    monkeypatch.chdir(os.path.dirname(feature))
    cam, sd, _ = load_mitsuba(feature, resolution=(32, 32), device="cpu")
    jcam, jsd, _ = jload_mitsuba(feature, resolution=(32, 32))
    assert_scene_equal(sd, jsd)
    assert sd.p0.shape[0] == 392 and int(sd.n_lights) == 3
    assert set(sd.mat_type.tolist()) == {MAT_MATTE, MAT_MIRROR, MAT_GLASS,
                                         MAT_METAL, MAT_ROUGHGLASS,
                                         MAT_SUBSTRATE}
    assert sorted(sd.txd_kind.tolist()) == [1, 2]  # checker, bitmap
    ts = pi.TracedScene.create(sd)
    assert ts.use_bvh and ts.has_env and ts.image_tex


@pytest.mark.parametrize("mis_mode", ["ref", "onesample"])
def test_feature_wave_matches_jax_bounce_loop(feature, mis_mode,
                                              monkeypatch):
    """The feature scene's wave, bounce by bounce, through identical
    trees, against the JAX bounce functions run op by op."""
    monkeypatch.chdir(os.path.dirname(feature))
    res = 20
    jcam, jsd, _ = jload_mitsuba(feature, resolution=(res, res))
    jts = ji.TracedScene.create(jsd)
    pts = traced_scene_from_reference(jts, device="cpu")
    jcfg = ji.PathConfig(max_depth=3, mis_mode=mis_mode)
    pcfg = pi.PathConfig(max_depth=3, mis_mode=mis_mode)
    dom = jsb.SobolDomain.create((-2, -2), (res + 2, res + 2), 1)
    ys, xs = np.mgrid[-2:res + 2, -2:res + 2]
    px, py = xs.ravel(), ys.ravel()
    scr, b_base = jsb.pixel_statics(dom, px, py)
    lo_s, hi_s, delta = jsb.frame_statics(dom, 0)
    jlo, jhi = jsb.sobol_index(jnp.asarray(b_base), jnp.uint32(delta),
                               jnp.uint32(lo_s), jnp.uint32(hi_s),
                               *jsb.vdc_inv_rows(dom))
    plo, phi = psb.sobol_index(torch.as_tensor(b_base.astype(np.int64)),
                               int(delta), int(lo_s), int(hi_s),
                               *psb.vdc_inv_rows(dom, "cpu"))
    jsm, psm = jsb.sm32_device(), psb.sm32_device("cpu")
    jscr = jnp.asarray(scr)
    pscr = torch.as_tensor(scr.astype(np.int64))
    jdraws = (lambda k: jsb.sobol_sample_dim(jlo, jhi, k, jscr, jsm),
              lambda k: jsb.sobol_sample_dim2(jlo, jhi, k, jscr, jsm))
    pdraws = (lambda k: psb.sobol_sample_dim(plo, phi, k, pscr, psm),
              lambda k: psb.sobol_sample_dim2(plo, phi, k, pscr, psm))
    rng = np.random.default_rng(3)
    pf = np.stack([px, py], -1) + rng.uniform(0, 1, (len(px), 2))
    o, d = ji.generate_rays(*jcam.ray_params(),
                            jnp.asarray(pf.astype(np.float32)))
    jst = ji._wave_init(jts, jcfg, o, d)
    pst = pi._wave_init(pts, pcfg, torch.tensor(np.asarray(o)),
                        torch.tensor(np.asarray(d)))
    for bounce in range(jcfg.max_depth + 1):
        jst = ji._wave_bounce(jts, jcfg, bounce, jst, *jdraws)
        pst = pi._wave_bounce(pts, pcfg, bounce, pst, *pdraws)
        np.testing.assert_array_equal(pst["active"].numpy(),
                                      np.asarray(jst["active"]))
        assert float(pst["rays"]) == float(jst["rays"])
        np.testing.assert_allclose(pst["l"].numpy(), np.asarray(jst["l"]),
                                   rtol=1e-3, atol=1e-5)
    assert float(jst["rays"]) > 3 * len(px)


@pytest.mark.slow
def test_feature_film_matches_jax(feature, monkeypatch):
    monkeypatch.chdir(os.path.dirname(feature))
    cfg = dict(max_depth=3)
    jcam, jsd, _ = jload_mitsuba(feature, resolution=(32, 32))
    jinteg = ji.PathIntegrator(ji.PathConfig(**cfg), spp=2)
    jfilm = np.asarray(jinteg.render(jcam, jsd))
    cam, sd, _ = load_mitsuba(feature, resolution=(32, 32), device="cpu")
    integ = pi.PathIntegrator(pi.PathConfig(**cfg), spp=2)
    film = integ.render(cam, sd).numpy()
    assert np.isfinite(film).all() and (film[..., 3] > 0).all()
    np.testing.assert_allclose(film[..., 3], jfilm[..., 3], rtol=1e-5)
    diff = np.abs(film[..., :3] - jfilm[..., :3]).max(-1)
    assert (diff > 1e-3).mean() < 0.02, np.sort(diff.ravel())[-20:]
    assert abs(integ.last_ray_count - jinteg.last_ray_count) \
        <= 1e-3 * jinteg.last_ray_count
