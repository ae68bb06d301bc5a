"""The texture path of the port against the JAX package's.

The mip pyramid and the packed pool are host numpy in both packages and
must be equal leaf for leaf. The lookup (``lookup_width``, the image kind
of ``eval_texture``, the textured ``gather_params``), the ray
differentials (``generate_rays_diff``, ``compute_duv``) and the normal
maps (``apply_normal_mapping``) get the same inputs, drawn with numpy
from a seed, in both packages and must agree to rtol 1e-6 / atol 1e-6:
the same f32 formulas, with only the last bits of log2 / pow differing
between XLA's CPU kernels and PyTorch's. The reference's padding of every
texture's level tables to MAX_LEVELS is kept, and shown in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.core import camera as jcamera
from pathtracer_tpu.ops import bsdf as jbx
from pathtracer_tpu.ops import interaction as jia
from pathtracer_tpu.scene import texture as jtex
from pathtracer_tpu.scene.scene import SceneBuilder as JSceneBuilder
from pathtracer_tpu.scene.scene import pack_mat_attr as jpack_mat_attr
from pathtracer_tpu_torch.core import camera as pcamera
from pathtracer_tpu_torch.ops import bsdf as pbx
from pathtracer_tpu_torch.ops import interaction as pia
from pathtracer_tpu_torch.scene import texture as ptex
from pathtracer_tpu_torch.scene.scene import MAT_DISNEY, MAT_MATTE
from pathtracer_tpu_torch.scene.scene import SceneBuilder as PSceneBuilder
from pathtracer_tpu_torch.scene.scene import pack_mat_attr

TOL = dict(rtol=1e-6, atol=1e-6)
N = 512


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _images():
    """Images of several shapes (pow2, non-pow2, grey, RGBA-sized)."""
    rng = np.random.default_rng(0)
    return [rng.random((8, 8, 3), np.float32),
            rng.random((7, 5, 3), np.float32),
            rng.random((16, 4, 3), np.float32),
            rng.random((3, 6), np.float32),
            rng.random((1, 1, 3), np.float32)]


@pytest.mark.parametrize("wrap", [ptex.WRAP_REPEAT, ptex.WRAP_BLACK,
                                  ptex.WRAP_CLAMP])
@pytest.mark.parametrize("k", range(5))
def test_build_pyramid_matches_reference(k, wrap):
    img = _images()[k]
    got = ptex.build_pyramid(img, wrap)
    want = jtex.build_pyramid(img, wrap)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _pools():
    """The same pool built by both packages: every image under a wrap
    mode of its own."""
    pb, jb = ptex.TexturePoolBuilder(), jtex.TexturePoolBuilder()
    for k, img in enumerate(_images()):
        assert pb.add(img, k % 3) == jb.add(img, k % 3) == k
    return pb.build(device="cpu"), jb.build()


def _assert_pool_equal(pool, jpool):
    for f in dataclasses.fields(ptex.TexturePool):
        got = getattr(pool, f.name).numpy()
        want = np.asarray(getattr(jpool, f.name))
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_pool_leaves_match_reference():
    pool, jpool = _pools()
    _assert_pool_equal(pool, jpool)
    assert pool.data.shape == (pool.level_offset[-1, -1] + 1, 3)


def test_empty_pool_matches_reference():
    _assert_pool_equal(ptex.TexturePoolBuilder().build(device="cpu"),
                       jtex.TexturePoolBuilder().build())


def _lookup_inputs(seed, width_kind, n_tex):
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, n_tex, N).astype(np.int32)
    st = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    if width_kind == "zero":
        width = 0.0
    elif width_kind == "zeros":
        width = np.zeros(N, np.float32)
    else:
        width = np.exp(rng.uniform(np.log(1e-4), np.log(2.0), N)) \
            .astype(np.float32)
    return tex, st, width


@pytest.mark.parametrize("width_kind", ["zero", "zeros", "random"])
def test_lookup_width_matches_reference(width_kind):
    """Random st (negative and above 1 included) over five textures, one
    for each wrap mode at least; a Python 0 (the level-0 path), an all-zero
    tensor and random widths (the trilinear path)."""
    pool, jpool = _pools()
    tex, st, width = _lookup_inputs(1, width_kind, 5)
    got = ptex.lookup_width(pool, _t(tex, torch.int32), _t(st),
                            width if isinstance(width, float) else _t(width))
    want = jtex.lookup_width(jpool, jnp.asarray(tex), jnp.asarray(st),
                             width if isinstance(width, float)
                             else jnp.asarray(width))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lookup_width_zero_paths_differ_only_in_rounding():
    """The Python 0 and the all-zero tensor both read level 0 (the
    tensor's level clips to 0), so they agree to rounding."""
    pool, _ = _pools()
    tex, st, _ = _lookup_inputs(2, "zero", 5)
    a = ptex.lookup_width(pool, _t(tex, torch.int32), _t(st), 0)
    b = ptex.lookup_width(pool, _t(tex, torch.int32), _t(st),
                          torch.zeros(N))
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_level_tables_padded_to_max_levels(pkg):
    """The reference's quirk, kept: a 256x256 texture has a 9-level
    pyramid, but its tables are padded to MAX_LEVELS = 16 before the
    levels are counted, so n_levels is 16 and a width of 1/256 selects
    level 16 - 1 - 8 = 7, the 2x2 level (the pyramid's own count would
    select level 0)."""
    mod = ptex if pkg == "port" else jtex
    img = np.random.default_rng(5).random((256, 256, 3), np.float32)
    assert len(mod.build_pyramid(img)) == 9
    b = mod.TexturePoolBuilder()
    b.add(img)
    pool = b.build(device="cpu") if pkg == "port" else b.build()
    assert mod.MAX_LEVELS == 16
    assert np.asarray(pool.n_levels).tolist() == [16]
    assert np.asarray(pool.level_w)[0].tolist() == \
        [256, 128, 64, 32, 16, 8, 4, 2, 1, 1, 1, 1, 1, 1, 1, 1]
    st = np.random.default_rng(6).uniform(0, 1, (64, 2)).astype(np.float32)
    if pkg == "port":
        tex = torch.zeros(64, dtype=torch.int32)
        got = ptex.lookup_width(pool, tex, _t(st),
                                torch.full((64,), 1 / 256))
        lvl7 = ptex._triangle(pool, tex.long(),
                              torch.full((64,), 7, dtype=torch.long), _t(st))
        lvl0 = ptex._triangle(pool, tex.long(),
                              torch.zeros(64, dtype=torch.long), _t(st))
        got, lvl7, lvl0 = got.numpy(), lvl7.numpy(), lvl0.numpy()
    else:
        tex = jnp.zeros(64, jnp.int32)
        got = np.asarray(jtex.lookup_width(pool, tex, jnp.asarray(st),
                                           jnp.full((64,), 1 / 256)))
        lvl7 = np.asarray(jtex._triangle(pool, tex, jnp.full(64, 7),
                                         jnp.asarray(st)))
        lvl0 = np.asarray(jtex._triangle(pool, tex, jnp.zeros(64, jnp.int32),
                                         jnp.asarray(st)))
    np.testing.assert_allclose(got, lvl7, rtol=1e-5, atol=1e-6)
    assert np.abs(got - lvl0).max() > 0.05


def _image_scene(builder_cls, device=None):
    """Materials binding image descriptors with every option: sRGB with a
    colour scale, a channel split with a scalar scale, a UV map, each wrap
    mode, a normal map; a checker descriptor beside them."""
    rng = np.random.default_rng(7)
    b = builder_cls()
    img = rng.random((8, 8, 3), np.float32)
    nm = np.clip(np.stack([0.5 + 0.3 * rng.standard_normal((4, 4)),
                           0.5 + 0.3 * rng.standard_normal((4, 4)),
                           rng.uniform(0.6, 1.0, (4, 4))], -1), 0, 1)
    kd = b.add_texture_image(img, scale=(0.9, 0.5, 0.7), srgb=True)
    met = b.add_texture_image(img, scale=(0.8,) * 3, channel=2,
                              wrap=ptex.WRAP_CLAMP)
    rough = b.add_texture_image(rng.random((5, 3, 3), np.float32),
                                scale=(0.6,) * 3, channel=1,
                                uv=(2.0, 3.0, 0.25, -0.5),
                                wrap=ptex.WRAP_BLACK)
    normal = b.add_texture_image(nm.astype(np.float32))
    checker = b.add_texture_checker((1, 0, 0), (0, 1, 0), uv=(4, 4, 0, 0))
    b.add_material(mtype=MAT_DISNEY, kd=(0.3, 0.4, 0.5),
                   misc=(0.5, 0.4, 0, 0), kd_tx=kd, metallic_tx=met,
                   rough_tx=rough, normal_tx=normal)
    b.add_material(mtype=MAT_MATTE, kd=(0.2, 0.2, 0.2), kd_tx=checker)
    b.add_material(mtype=MAT_MATTE, kd=(0.7, 0.1, 0.1))
    b.add_mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
               np.array([[0, 1, 2]]), None, None, 0)
    return b.build() if device is None else b.build(device=device)


@pytest.fixture(scope="module")
def scenes():
    return _image_scene(PSceneBuilder, "cpu"), _image_scene(JSceneBuilder)


def _duv(rng, n, scale=0.02):
    return tuple(rng.normal(0, scale, n).astype(np.float32) for _ in range(4))


@pytest.mark.parametrize("with_duv", [False, True])
def test_eval_texture_image_kind_matches_reference(scenes, with_duv):
    sd, jsd = scenes
    rng = np.random.default_rng(8)
    txd = rng.integers(-1, 5, N).astype(np.int32)
    uv = rng.uniform(-0.5, 1.5, (N, 2)).astype(np.float32)
    fb = rng.random((N, 3), np.float32)
    duv = _duv(rng, N) if with_duv else None
    got = pbx.eval_texture(sd, _t(txd, torch.int32), _t(uv), _t(fb),
                           duv=None if duv is None else
                           tuple(_t(x) for x in duv))
    want = jbx.eval_texture(jsd, jnp.asarray(txd), jnp.asarray(uv),
                            jnp.asarray(fb), duv=None if duv is None else
                            tuple(jnp.asarray(x) for x in duv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the channel descriptors broadcast one channel
    ch = np.isin(txd, (1, 2))
    g = got.numpy()[ch]
    assert (g[:, 0] == g[:, 1]).all() and (g[:, 1] == g[:, 2]).all()


def test_eval_texture_without_image_flag_matches_where_no_image(scenes):
    """``image=False`` skips the pool lookup; on descriptors that are not
    images the result is the same."""
    sd, _ = scenes
    rng = np.random.default_rng(9)
    txd = _t(rng.choice([-1, 4], N), torch.int32)
    uv = _t(rng.uniform(-0.5, 1.5, (N, 2)))
    fb = _t(rng.random((N, 3)))
    assert torch.equal(pbx.eval_texture(sd, txd, uv, fb, image=False),
                       pbx.eval_texture(sd, txd, uv, fb))


@pytest.mark.parametrize("with_duv", [False, True])
def test_gather_params_textured_matches_reference(scenes, with_duv):
    sd, jsd = scenes
    rng = np.random.default_rng(10)
    mat = rng.integers(0, 3, N).astype(np.int32)
    uv = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    duv = _duv(rng, N) if with_duv else None
    got = pbx.gather_params(
        sd, _t(mat, torch.int32), _t(uv),
        torch.as_tensor(pack_mat_attr(sd)), has_tex=True,
        duv=None if duv is None else tuple(_t(x) for x in duv),
        tex_channels=(True, False, True, True))
    want = jbx.gather_params(
        jsd, jnp.asarray(mat), jnp.asarray(uv),
        mat_attr=jpack_mat_attr(jsd), has_tex=True,
        duv=None if duv is None else tuple(jnp.asarray(x) for x in duv),
        tex_channels=(True, False, True, True))
    for k in ("kd", "ks", "metallic", "ax", "ay"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _interaction(seed, n=N):
    """A synthetic interaction: orthonormal shading frames about random
    normals, random positions, UV derivatives (a few parallel, so their
    system is singular) and materials."""
    rng = np.random.default_rng(seed)
    ns = _unit(rng, n)
    ss = np.cross(ns, _unit(rng, n))
    ss = (ss / np.linalg.norm(ss, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.cross(ns, ss).astype(np.float32)
    dpdu = rng.normal(size=(n, 3)).astype(np.float32)
    dpdv = rng.normal(size=(n, 3)).astype(np.float32)
    dpdv[:8] = 2.0 * dpdu[:8]
    return dict(p=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
                ng=ns.copy(), ns=ns, ss=ss, ts=ts, dpdu=dpdu, dpdv=dpdv,
                uv=rng.uniform(0, 1, (n, 2)).astype(np.float32),
                material=rng.integers(0, 3, n).astype(np.int32))


def test_compute_duv_matches_reference():
    """Origins off the tangent plane, differential directions toward the
    hit; a few singular systems and a few zero directions (t not finite),
    which give zeros."""
    it = _interaction(11)
    rng = np.random.default_rng(12)
    o = (it["p"] + 2.0 * it["ng"] + rng.normal(0, 0.3, (N, 3))) \
        .astype(np.float32)
    d = it["p"] - o
    rxd = (d + rng.normal(0, 0.01, (N, 3))).astype(np.float32)
    ryd = (d + rng.normal(0, 0.01, (N, 3))).astype(np.float32)
    rxd[8:12] = 0.0  # no plane hit: t is not finite
    got = pia.compute_duv({k: _t(v) for k, v in it.items()}, _t(o),
                          _t(rxd), _t(ryd))
    want = jia.compute_duv({k: jnp.asarray(v) for k, v in it.items()},
                           jnp.asarray(o), jnp.asarray(rxd),
                           jnp.asarray(ryd))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert all((g.numpy()[:12] == 0).all() for g in got)
    assert all((g.numpy()[12:] != 0).mean() > 0.99 for g in got)


@pytest.mark.parametrize("with_duv", [False, True])
def test_apply_normal_mapping_matches_reference(scenes, with_duv):
    """A synthetic normal-map texture (no asset has one) bound to
    material 0; materials 1 and 2 keep their frames."""
    sd, jsd = scenes
    it = _interaction(13)
    duv = _duv(np.random.default_rng(14), N) if with_duv else None
    pit = {k: _t(v, torch.int32 if k == "material" else torch.float32)
           for k, v in it.items()}
    got = pia.apply_normal_mapping(
        sd, pit, duv=None if duv is None else tuple(_t(x) for x in duv))
    want = jia.apply_normal_mapping(
        jsd, {k: jnp.asarray(v) for k, v in it.items()},
        duv=None if duv is None else tuple(jnp.asarray(x) for x in duv))
    for k in ("ns", "ss", "ts", "ng"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=2e-6, err_msg=k)
    mapped = it["material"] == 0
    assert mapped.any() and (~mapped).any()
    assert np.abs(got["ns"].numpy()[mapped] - it["ns"][mapped]).max() > 0.1
    assert np.array_equal(got["ns"].numpy()[~mapped], it["ns"][~mapped])


def test_generate_rays_diff_matches_reference():
    c2w = np.eye(4)
    c2w[:3, 3] = [0.5, 1.0, 4.0]
    cam = pcamera.Camera.create(c2w, 4 / 3, 0.8, (64, 48))
    jcam = jcamera.Camera.create(c2w, 4 / 3, 0.8, (64, 48))
    p_film = np.random.default_rng(15).uniform(0, 64, (N, 2)) \
        .astype(np.float32)
    scale = float(np.float32(1 / np.sqrt(4)))
    got = pcamera.generate_rays_diff(*cam.ray_params("cpu"), _t(p_film),
                                     cam.diff_params("cpu"), scale)
    want = jcamera.generate_rays_diff(*jcam.ray_params(),
                                      jnp.asarray(p_film),
                                      jcam.diff_params(), jnp.float32(scale))
    assert torch.equal(cam.diff_params("cpu"),
                       torch.as_tensor(np.array(jcam.diff_params())))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the main rays are generate_rays' own
    o, d = pcamera.generate_rays(*cam.ray_params("cpu"), _t(p_film))
    assert torch.equal(got[0], o) and torch.equal(got[1], d)
