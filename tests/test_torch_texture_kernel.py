"""Kernels K3 (``texture_cu.texture_eval``) and K4 (``texture_cu.alpha_cut``).

On the CPU each wrapper runs its plain version (``ops/bsdf.
eval_texture_plain``, ``integrator._alpha_cut_plain``); these tests hold
it to the JAX package's ``eval_texture`` and ``_alpha_cut`` on the same
numpy-made inputs (every descriptor kind, all three wraps, both width
modes, sRGB on and off, channels -1 and 0-2, expanded fallbacks,
``image=False``; masked sheets and Sponza's triangles), at the tolerance
of tests/test_torch_textures.py (rtol 1e-6 / atol 1e-6: the same f32
formulas, XLA's and PyTorch's CPU log2 / pow differing in the last
bits), the cut flags exactly. They check the kernels' packed descriptor
rows against the leaves, the source's row layout against the Python
constants, and that a render reaches both wrappers with inputs a kernel
takes. The ``cuda``-marked tests hold each kernel to its plain version
on the card (``torch.equal``) and skip here: a CUDA kernel has no CPU or
interpret mode. The file imports JAX only inside the parity tests, so the
card runs its ``cuda`` tests where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_texture_kernel.py
"""

import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import integrator as pint
from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
from pathtracer_tpu_torch.ops import bsdf as pbx
from pathtracer_tpu_torch.ops.cuda import _build, texture_cu
from pathtracer_tpu_torch.scene import scene as pscene
from pathtracer_tpu_torch.scene import texture as ptex
from pathtracer_tpu_torch.scene.scene import MAT_MATTE, SceneBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_alpha_scenes  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
N = 1000  # ragged: not a multiple of the kernels' block
D = 9  # descriptors of _texture_fill


def _images():
    """Three images (pow2, non-pow2, tall), each with texels below the
    sRGB knee (0.04045) and above it."""
    rng = np.random.default_rng(11)
    imgs = [rng.random((8, 8, 3)), rng.random((7, 5, 3)),
            rng.random((16, 4, 3))]
    for img in imgs:
        img[::3, ::2] *= 0.05
    return [img.astype(np.float32) for img in imgs]


def _texture_fill(b):
    """Descriptors 0-8 for either package's SceneBuilder: images under
    each wrap mode with sRGB on and off and channels -1 and 0-2, other
    scales and UV maps, a checker, a constant; one triangle."""
    a, bb, c = _images()
    b.add_texture_image(a, wrap=ptex.WRAP_REPEAT)
    b.add_texture_image(bb, scale=(0.5, 2.0, 1.5), uv=(2, 3, 0.25, -0.5),
                        wrap=ptex.WRAP_BLACK, srgb=True, channel=1)
    b.add_texture_image(c, scale=(1.25, 0.75, 1.0), wrap=ptex.WRAP_CLAMP,
                        srgb=True)
    b.add_texture_image(a, uv=(-1.5, 0.5, 0.1, 0.3), wrap=ptex.WRAP_CLAMP,
                        channel=0)
    b.add_texture_image(c, wrap=ptex.WRAP_BLACK, channel=2, srgb=True)
    b.add_texture_image(bb, uv=(4, 4, 0, 0), wrap=ptex.WRAP_REPEAT)
    b.add_texture_checker((0.9, 0.1, 0.2), (0.1, 0.3, 0.8),
                          uv=(4, 3, 0.1, 0.2))
    b.txds.append(dict(kind=0, rgb0=(0.3, 0.6, 0.9), rgb1=(0, 0, 0),
                       scale=(1, 1, 1), uv=(1, 1, 0, 0), image=0,
                       channel=-1, srgb=False))
    b.add_texture_checker((0.2, 0.2, 0.2), (0.7, 0.7, 0.7))
    m = b.add_material(mtype=MAT_MATTE, kd_tx=0)
    b.add_mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
               np.array([[0, 1, 2]]), None, None, m)


def _port_scene(device="cpu", fill=_texture_fill):
    b = SceneBuilder()
    fill(b)
    return b.build(device=device)


def _inputs(seed, n, mode, fb_layout, only=None):
    """txd_id in [-1, D) (or all ``only``), uv in [-1.5, 2.5), the four
    UV derivatives (log-uniform magnitudes of both signs, some 0; all 0
    for mode "zeros"; None for "static") and the fallback in
    ``fb_layout``: (N, 3) contiguous, a (3,) row expanded, an (N,) column
    expanded, or every other row of a wider table (as ``gather_params``
    passes them)."""
    rng = np.random.default_rng(seed)
    txd = rng.integers(-1, D, n).astype(np.int32) if only is None else \
        np.full(n, only, np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    duv = None
    if mode != "static":
        duv = [(np.exp(rng.uniform(np.log(1e-5), np.log(3.0), n))
                * rng.choice([-1.0, 1.0], n)
                * (rng.random(n) > 0.1)).astype(np.float32)
               for _ in range(4)]
        if mode == "zeros":
            duv = [np.zeros(n, np.float32) for _ in range(4)]
    table = rng.random((2 * n, 5)).astype(np.float32)
    return txd, uv, duv, table, fb_layout


def _fallback(table, layout, n, device="cpu"):
    """The fallback view of ``layout`` over ``table`` (same values in
    either package's copy)."""
    t = torch.as_tensor(table, device=device)
    if layout == "contiguous":
        return t[:n, :3].contiguous()
    if layout == "row":
        return t[0, 1:4].expand(n, 3)
    if layout == "column":
        return t[:n, 4][:, None].expand(n, 3)
    return t[::2, 1:4]  # "strided": every other row, a (5,)-float stride


def _jax_fallback(table, layout, n):
    return _fallback(table, layout, n).numpy().copy()


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's eval_texture and _alpha_cut and its
    SceneBuilder (imported here, so that the card's cuda tests need no
    JAX)."""
    import jax.numpy as jnp

    from pathtracer_tpu import integrator as jint
    from pathtracer_tpu.ops import bsdf as jbx
    from pathtracer_tpu.scene.gltf import load_gltf as jload_gltf
    from pathtracer_tpu.scene.scene import SceneBuilder as JSceneBuilder
    return types.SimpleNamespace(jnp=jnp, jbx=jbx, jint=jint,
                                 SceneBuilder=JSceneBuilder,
                                 load_gltf=jload_gltf)


@pytest.fixture(scope="module")
def scenes(jax_ref):
    jb = jax_ref.SceneBuilder()
    _texture_fill(jb)
    return _port_scene(), jb.build()


def _eval_both(jax_ref, scenes, inputs, image=True):
    txd, uv, duv, table, layout = inputs
    n = len(txd)
    psd, jsd = scenes
    jnp = jax_ref.jnp
    pduv = None if duv is None else tuple(torch.as_tensor(x) for x in duv)
    before = dict(texture_cu.LAUNCHES)
    got = texture_cu.texture_eval(psd, torch.as_tensor(txd),
                                  torch.as_tensor(uv),
                                  _fallback(table, layout, n), duv=pduv,
                                  image=image)
    assert texture_cu.LAUNCHES == before  # CPU tensors: the plain version
    want = jax_ref.jbx.eval_texture(
        jsd, jnp.asarray(txd), jnp.asarray(uv),
        jnp.asarray(_jax_fallback(table, layout, n)),
        duv=None if duv is None else tuple(jnp.asarray(x) for x in duv))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("layout", ["contiguous", "row", "column",
                                    "strided"])
@pytest.mark.parametrize("mode", ["static", "width", "zeros"])
def test_texture_eval_matches_jax(jax_ref, scenes, mode, layout):
    """Every descriptor and negative ids, in each width mode (a Python 0,
    derivatives, all-zero derivatives) and fallback layout."""
    inputs = _inputs(3, N, mode, layout)
    got, want = _eval_both(jax_ref, scenes, inputs)
    np.testing.assert_allclose(got, want, **TOL)
    txd = inputs[0]
    fb = _jax_fallback(inputs[3], layout, N)
    assert (got[txd < 0] == fb[txd < 0]).all()
    assert set(np.unique(txd)) == set(range(-1, D))


@pytest.mark.parametrize("mode", ["static", "width"])
@pytest.mark.parametrize("txd", range(D))
def test_texture_eval_each_descriptor_matches_jax(jax_ref, scenes, txd,
                                                  mode):
    """One descriptor on every lane: each kind, wrap, sRGB flag and
    channel alone."""
    got, want = _eval_both(jax_ref, scenes,
                           _inputs(20 + txd, 257, mode, "row", only=txd))
    np.testing.assert_allclose(got, want, **TOL)
    if txd < 6 and mode == "static":  # level 0 of an image varies over uv
        assert len(np.unique(got[:, 0])) > 2


def test_texture_eval_without_image_matches_jax(jax_ref, scenes):
    """``image=False``: the checker and constant lanes as the JAX
    package's, an image descriptor's lanes read its rgb0 (the pool is not
    read), as the plain version's."""
    inputs = _inputs(5, N, "width", "contiguous")
    got, want = _eval_both(jax_ref, scenes, inputs, image=False)
    txd = inputs[0]
    image = (txd >= 0) & (txd < 6)
    np.testing.assert_allclose(got[~image], want[~image], **TOL)
    assert (got[image] == 0.0).all()  # the images' rgb0


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's tensor
    values exactly and launches nothing."""
    sd = _port_scene()
    txd, uv, duv, table, _ = _inputs(7, N, "width", "row")
    args = (sd, torch.as_tensor(txd), torch.as_tensor(uv),
            _fallback(table, "row", N))
    kw = dict(duv=tuple(torch.as_tensor(x) for x in duv))
    before = dict(texture_cu.LAUNCHES)
    assert torch.equal(texture_cu.texture_eval(*args, **kw),
                       pbx.eval_texture_plain(*args, **kw))
    assert torch.equal(pbx.eval_texture(*args, **kw),
                       pbx.eval_texture_plain(*args, **kw))
    assert texture_cu.LAUNCHES == before


def test_packed_rows_hold_the_leaves():
    """``SceneData.txd_rows``: each descriptor's UV map, colours, scale,
    kind, sRGB flag and channel, and an image descriptor's level tables
    copied from its texture's; built once a SceneData."""
    sd = _port_scene()
    txf, txi = sd.txd_rows
    assert sd.txd_rows[0] is txf
    assert txf.shape == (D, ptex.TXF_WIDTH) and txf.dtype == torch.float32
    assert txi.shape == (D, ptex.TXI_WIDTH) and txi.dtype == torch.int32
    assert txf.is_contiguous() and txi.is_contiguous()
    assert torch.equal(txf[:, ptex.TXF_UV:ptex.TXF_UV + 4], sd.txd_uv)
    assert torch.equal(txf[:, ptex.TXF_RGB0:ptex.TXF_RGB0 + 3], sd.txd_rgb0)
    assert torch.equal(txf[:, ptex.TXF_RGB1:ptex.TXF_RGB1 + 3], sd.txd_rgb1)
    assert torch.equal(txf[:, ptex.TXF_SCALE:ptex.TXF_SCALE + 3],
                       sd.txd_scale)
    assert torch.equal(txi[:, ptex.TXI_KIND], sd.txd_kind)
    assert torch.equal(txi[:, ptex.TXI_SRGB].bool(), sd.txd_srgb)
    assert torch.equal(txi[:, ptex.TXI_CHANNEL], sd.txd_channel)
    pool = sd.tex
    for d in range(D):
        if int(sd.txd_kind[d]) != 2:
            assert not txi[d, ptex.TXI_NLEVELS:].any()
            continue
        tex = int(sd.txd_image[d])
        assert int(txi[d, ptex.TXI_NLEVELS]) == int(pool.n_levels[tex])
        assert int(txi[d, ptex.TXI_WRAP]) == int(pool.wrap[tex])
        for col, leaf in ((ptex.TXI_OFFSET, pool.level_offset),
                          (ptex.TXI_W, pool.level_w),
                          (ptex.TXI_H, pool.level_h)):
            assert torch.equal(txi[d, col:col + ptex.MAX_LEVELS], leaf[tex])
    # dataclasses.replace builds a new SceneData: its rows anew
    import dataclasses
    assert dataclasses.replace(sd).txd_rows[0] is not txf


def _source_defines() -> dict:
    with open(os.path.join(_build.CSRC_DIR, texture_cu.SOURCE)) as fh:
        return {m.group(1): int(m.group(2)) for m in re.finditer(
            r"^#define (\w+) (-?\d+)$", fh.read(), re.M)}


_LAYOUT = dict(
    TXF_UV=ptex.TXF_UV, TXF_RGB0=ptex.TXF_RGB0, TXF_RGB1=ptex.TXF_RGB1,
    TXF_SCALE=ptex.TXF_SCALE, TXF_WIDTH=ptex.TXF_WIDTH,
    TXI_KIND=ptex.TXI_KIND, TXI_SRGB=ptex.TXI_SRGB,
    TXI_CHANNEL=ptex.TXI_CHANNEL, TXI_NLEVELS=ptex.TXI_NLEVELS,
    TXI_WRAP=ptex.TXI_WRAP, TXI_OFFSET=ptex.TXI_OFFSET, TXI_W=ptex.TXI_W,
    TXI_H=ptex.TXI_H, TXI_WIDTH=ptex.TXI_WIDTH,
    WRAP_REPEAT=ptex.WRAP_REPEAT, WRAP_BLACK=ptex.WRAP_BLACK,
    TA_P0=pscene.TA_P0.start, TA_UV0=pscene.TA_UV0.start,
    TA_NG0=pscene.TA_NG0.start, TA_ALPHA=pscene.TA_ALPHA,
    TA_WIDTH=pscene.TA_WIDTH)


@pytest.mark.parametrize("name", sorted(_LAYOUT))
def test_source_layout_matches_the_python_constants(name):
    """csrc/texture.cu's #defines of the descriptor rows, wrap codes and
    tri_attr columns are the Python's (the kernel also reads P1 / P2 and
    UV1 / UV2 at fixed offsets from P0 and UV0)."""
    assert _source_defines()[name] == _LAYOUT[name]
    assert pscene.TA_P1.start == pscene.TA_P0.start + 3
    assert pscene.TA_P2.start == pscene.TA_P0.start + 6
    assert pscene.TA_UV1.start == pscene.TA_UV0.start + 2
    assert pscene.TA_UV2.start == pscene.TA_UV0.start + 4


# ---------------------------------------------------------------- K4


def _hits(tri_attr, n, seed, n_tri):
    """Hit records over a tri_attr table: 3/4 of the lanes on masked
    triangles, the rest on unmasked ones and misses (tri 0, b 0, not
    valid); barycentrics from a Dirichlet, 10 % of the others not
    valid."""
    rng = np.random.default_rng(seed)
    alpha = tri_attr[:n_tri, pscene.TA_ALPHA]
    masked = np.nonzero(alpha >= 0)[0]
    other = np.nonzero(alpha < 0)[0]
    tri = rng.choice(masked, n)
    if len(other):
        pick = rng.random(n) < 0.15
        tri[pick] = rng.choice(other, int(pick.sum()))
    b = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    valid = rng.random(n) < 0.9
    miss = rng.random(n) < 0.1
    tri[miss], b[miss], valid[miss] = 0, 0.0, False
    return dict(valid=valid, t=np.ones(n, np.float32),
                tri=tri.astype(np.int32), b=b)


def _cut_both(jax_ref, port_scene, jsd, hit):
    jnp = jax_ref.jnp
    before = dict(texture_cu.LAUNCHES)
    got = texture_cu.alpha_cut(port_scene, {k: torch.as_tensor(v)
                                            for k, v in hit.items()})
    assert texture_cu.LAUNCHES == before
    jscene = types.SimpleNamespace(
        tri_attr=jnp.asarray(port_scene.tri_attr.numpy()), data=jsd)
    want = jax_ref.jint._alpha_cut(jscene, {k: jnp.asarray(v)
                                            for k, v in hit.items()})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    return got


@pytest.mark.parametrize("sheets", [1, 2])
def test_alpha_cut_matches_jax_on_masked_sheets(jax_ref, sheets):
    """Masked sheets over a floor (tests/torch_alpha_scenes.py): the cut
    flags exactly, the hit point, its error bound and ng at TOL."""
    fill = torch_alpha_scenes.sheets_fill(
        6, 5, heights=(1.0, 1.55)[:sheets])
    sd = torch_alpha_scenes.build(SceneBuilder, fill)
    jsd = torch_alpha_scenes.build(jax_ref.SceneBuilder, fill)
    ts = pint.TracedScene.create(sd)
    hit = _hits(ts.tri_attr.numpy(), 2048, sheets, ts.tri_attr.shape[0])
    cut = _cut_both(jax_ref, ts, jsd, hit)[0].numpy()
    # exactly 0 needs all four bilinear texels 0: a few % of the lanes
    assert 0.01 < cut.mean() < 0.7
    assert not cut[~hit["valid"]].any()


def test_alpha_cut_matches_jax_on_sponza(jax_ref):
    """Hits on Sponza's triangles (its 1,320 masked ones and others),
    against its own tri_attr rows and mask descriptors."""
    from pathtracer_tpu_torch.scene.gltf import load_gltf
    _, sd, _ = load_gltf("data/sponza_proc.glb", resolution=(32, 18),
                         device="cpu")
    _, jsd, _ = jax_ref.load_gltf("data/sponza_proc.glb",
                                  resolution=(32, 18))
    tri_attr = torch.as_tensor(pscene.pack_tri_attr(sd))
    scene = types.SimpleNamespace(tri_attr=tri_attr, data=sd)
    hit = _hits(tri_attr.numpy(), 4096, 9, tri_attr.shape[0])
    cut = _cut_both(jax_ref, scene, jsd, hit)[0].numpy()
    assert 0.05 < cut.mean() < 0.9


# ---------------------------------------------------------------- routing


def _launchable_texture(scene, txd_id, uv, fallback, duv=None, image=True):
    """The inputs K3's wrapper launches for (but the device)."""
    n = txd_id.shape[0]
    assert txd_id.dtype == torch.int32 and txd_id.is_contiguous()
    assert txd_id.dim() == 1 and uv.dtype == torch.float32
    assert tuple(uv.shape) == (n, 2) and uv.is_contiguous()
    assert fallback.dtype == torch.float32 and tuple(fallback.shape) == (n, 3)
    assert duv is None or all(
        x.dtype == torch.float32 and tuple(x.shape) == (n,)
        and x.is_contiguous() for x in duv)


def _launchable_cut(scene, hit):
    """The inputs K4's wrapper launches for (but the device)."""
    n = hit["tri"].shape[0]
    assert hit["tri"].dtype == torch.int32 and hit["tri"].is_contiguous()
    assert hit["b"].dtype == torch.float32 and hit["b"].is_contiguous()
    assert tuple(hit["b"].shape) == (n, 3)
    assert hit["valid"].dtype == torch.bool and hit["valid"].is_contiguous()
    assert scene.tri_attr.is_contiguous()
    assert scene.tri_attr.shape[1] == pscene.TA_WIDTH


def test_renders_reach_both_wrappers(monkeypatch):
    """A few pixels of classroom (image textures with differentials, then
    without) and of masked sheets go through texture_cu.texture_eval
    (both modes) and texture_cu.alpha_cut, each call with inputs the
    kernels take on the card."""
    calls = {"static": 0, "width": 0, "cut": 0}
    texture_eval, alpha_cut = texture_cu.texture_eval, texture_cu.alpha_cut

    def spy_texture(*args, **kw):
        _launchable_texture(*args, **kw)
        calls["static" if kw.get("duv") is None else "width"] += 1
        return texture_eval(*args, **kw)

    def spy_cut(scene, hit):
        _launchable_cut(scene, hit)
        calls["cut"] += 1
        return alpha_cut(scene, hit)

    monkeypatch.setattr(texture_cu, "texture_eval", spy_texture)
    monkeypatch.setattr(texture_cu, "alpha_cut", spy_cut)
    from pathtracer_tpu_torch.scene.gltf import load_gltf
    cam, sd, _ = load_gltf("data/classroom_proc.glb", resolution=(8, 6),
                           device="cpu")
    film = PathIntegrator(PathConfig(max_depth=2), spp=1).render(cam, sd)
    assert torch.isfinite(film).all()
    assert calls["width"] > 0 and calls["static"] > 0 and calls["cut"] == 0
    from pathtracer_tpu_torch.core.camera import Camera
    sd = torch_alpha_scenes.build(SceneBuilder,
                                  torch_alpha_scenes.sheets_fill(4, 4))
    cam = Camera.look_at([0, 4.0, 4.5], [0, 0, 0], [0, 1, 0], np.pi / 3,
                         (8, 8))
    film = PathIntegrator(PathConfig(max_depth=2), spp=1).render(cam, sd)
    assert torch.isfinite(film).all() and calls["cut"] > 0


# ---------------------------------------------------------------- card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def _card_inputs(n, mode, layout, dev, seed=1):
    txd, uv, duv, table, _ = _inputs(seed, n, mode, layout)
    return (torch.as_tensor(txd, device=dev), torch.as_tensor(uv, device=dev),
            _fallback(table, layout, n, dev),
            None if duv is None else tuple(torch.as_tensor(x, device=dev)
                                           for x in duv))


@pytest.mark.cuda
@pytest.mark.parametrize("image", [True, False])
@pytest.mark.parametrize("layout", ["contiguous", "row", "column",
                                    "strided"])
@pytest.mark.parametrize("mode", ["static", "width", "zeros"])
@pytest.mark.parametrize("n", [1, 255, 257, 131072])
def test_texture_eval_kernel_matches_plain(dev, n, mode, layout, image):
    """K3 ``torch.equal`` to its plain version on the card, one launch a
    call, on ragged N, each mode and fallback layout."""
    sd = _port_scene(dev)
    txd, uv, fb, duv = _card_inputs(n, mode, layout, dev, seed=n)
    before = texture_cu.LAUNCHES["texture_eval"]
    got = texture_cu.texture_eval(sd, txd, uv, fb, duv=duv, image=image)
    torch.cuda.synchronize()
    assert texture_cu.LAUNCHES["texture_eval"] == before + 1
    want = pbx.eval_texture_plain(sd, txd, uv, fb, duv=duv, image=image)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 131072])
def test_alpha_cut_kernel_matches_plain(dev, n):
    """K4 ``torch.equal`` to its plain version on the card (cut, p_hit,
    p_err, ng), one launch a call, on masked sheets."""
    sd = torch_alpha_scenes.build(SceneBuilder,
                                  torch_alpha_scenes.sheets_fill(6, 5),
                                  device=dev)
    ts = pint.TracedScene.create(sd)
    hit = {k: torch.as_tensor(v, device=dev) for k, v in _hits(
        ts.tri_attr.cpu().numpy(), n, n, ts.tri_attr.shape[0]).items()}
    before = texture_cu.LAUNCHES["alpha_cut"]
    got = texture_cu.alpha_cut(ts, hit)
    torch.cuda.synchronize()
    assert texture_cu.LAUNCHES["alpha_cut"] == before + 1
    want = pint._alpha_cut_plain(ts, hit)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernels_handle_empty_and_reject_bad_inputs(dev):
    """N = 0 launches nothing; a strided uv, int64 ids, a CPU scene with
    card inputs, int64 tri ids raise."""
    sd = _port_scene(dev)
    txd, uv, fb, duv = _card_inputs(64, "width", "row", dev)
    before = dict(texture_cu.LAUNCHES)
    out = texture_cu.texture_eval(sd, txd[:0], uv[:0], fb[:0],
                                  duv=tuple(x[:0] for x in duv))
    assert out.shape == (0, 3) and texture_cu.LAUNCHES == before
    wide = torch.zeros((64, 4), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        texture_cu.texture_eval(sd, txd, wide[:, :2], fb)
    with pytest.raises(TypeError, match="int32"):
        texture_cu.texture_eval(sd, txd.long(), uv, fb)
    with pytest.raises(TypeError, match="float32"):
        texture_cu.texture_eval(sd, txd, uv, fb.double())
    with pytest.raises(ValueError):
        texture_cu.texture_eval(_port_scene("cpu"), txd, uv, fb)
    sheets = torch_alpha_scenes.build(SceneBuilder,
                                      torch_alpha_scenes.sheets_fill(2, 2),
                                      device=dev)
    ts = pint.TracedScene.create(sheets)
    hit = {k: torch.as_tensor(v, device=dev) for k, v in _hits(
        ts.tri_attr.cpu().numpy(), 64, 0, ts.tri_attr.shape[0]).items()}
    empty = texture_cu.alpha_cut(ts, {k: v[:0] for k, v in hit.items()})
    assert empty[0].shape == (0,) and empty[1].shape == (0, 3)
    assert texture_cu.LAUNCHES == before
    with pytest.raises(TypeError, match="int32"):
        texture_cu.alpha_cut(ts, dict(hit, tri=hit["tri"].long()))
    with pytest.raises(ValueError, match="contiguous"):
        texture_cu.alpha_cut(ts, dict(hit, b=hit["b"].t().contiguous().t()))
