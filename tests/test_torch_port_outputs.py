"""The port's derived outputs (normal map, heatmap, simple mesh), its
default predictor cache, and the CLI that saves them, against the JAX
package.

The normal map and its filters run in f32 in both packages; they are held
to |d| <= 1 on <= 0.1% of the bytes, the bound the JAX package holds
against the reference (PARITY.md), over the whole option grid.  The
heatmap and the mesh OBJ are restated numpy and held byte-equal.  A small
ViT DPT (type 3's layout) runs the model path of both funnels with all
three outputs.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from depthmap_tpu.ops import filters as jfilters
from depthmap_tpu.ops import heatmap as jheatmap
from depthmap_tpu.ops.normalmap import create_normalmap as j_normalmap
from depthmap_tpu.options import GenerationOptions as JOptions
from depthmap_tpu.pipeline import core as jcore
from depthmap_tpu_torch.ops import filters as tfilters
from depthmap_tpu_torch.ops import heatmap as theatmap
from depthmap_tpu_torch.ops.normalmap import create_normalmap as t_normalmap
from depthmap_tpu_torch.options import GenerationOptions as TOptions
from depthmap_tpu_torch.pipeline import core as tcore
from tests.test_torch_port_funnel import REPO, I16_TOL, _FixedCache, _images, \
    _run

import jax.numpy as jnp


def _maps(rng, h=48, w=64):
    """A random 16-bit map and a smooth one."""
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = 0.5 + 0.5 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    return {"random": (rng.random((h, w)) * 65535).astype(np.uint16),
            "smooth": (smooth * 65535).astype(np.uint16)}


def assert_normals_close(got: np.ndarray, want: np.ndarray,
                         share: float = 1e-3):
    """|d| <= 1 on <= ``share`` of the bytes."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= share, (d > 0).mean()


# -- filters and the normal map ----------------------------------------------

def test_filter_kernels_equal():
    for k in (1, 3, 5, 7):
        for order in (0, 1):
            assert tfilters.deriv_kernel1d(order, k) == \
                jfilters.deriv_kernel1d(order, k)
    for k in (3, 5, 7):
        assert tfilters.gaussian_kernel1d(k, float(k)) == \
            jfilters.gaussian_kernel1d(k, float(k))


@pytest.mark.parametrize("shape", [(24, 31), (20, 27, 3)])
def test_filters_match_jax(rng, shape):
    x = (rng.random(shape) * 255).astype(np.float32)
    tx = torch.from_numpy(x)
    pairs = [(tfilters.gaussian_blur(tx, 5), jfilters.gaussian_blur(
        jnp.asarray(x), 5))]
    for dx, dy, k in ((1, 0, 3), (0, 1, 3), (1, 0, 5), (0, 1, 1)):
        pairs.append((tfilters.sobel(tx, dx, dy, k),
                      jfilters.sobel(jnp.asarray(x), dx, dy, ksize=k)))
    if len(shape) == 2:
        pairs += list(zip(tfilters.np_gradient_2d(tx),
                          jfilters.np_gradient_2d(jnp.asarray(x))))
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("pre_blur", [None, 3, 5])
@pytest.mark.parametrize("sobel_k", [None, 1, 3, 5])
def test_normalmap_matches_jax(rng, pre_blur, sobel_k):
    """Every option: pre-blur 3 / 5 / off, Sobel 1 / 3 / 5 / off
    (np.gradient), post-blur 3 / off, invert, on 480 x 640 maps.  The
    bytes that differ lie on the 2-pixel border, where REFLECT_101 makes
    the derivative (nearly) cancel and f32 rounding (XLA fuses the taps'
    multiply-adds, torch does not) tips a component between two counts,
    127 / 128 most often; so their share falls with the map's size.  A
    pre-blur with Sobel 5 and no post-blur gives the most: 8.4e-4 here,
    7e-3 at 48 x 64."""
    for kind, depth in _maps(rng, 480, 640).items():
        for post_blur in (None, 3):
            for invert in (False, True):
                want = np.asarray(j_normalmap(jnp.asarray(depth), pre_blur,
                                              sobel_k, post_blur, invert))
                got = t_normalmap(depth, pre_blur, sobel_k, post_blur,
                                  invert).numpy()
                assert_normals_close(got, want)


def test_even_blur_kernel_rejected(rng):
    depth = (rng.random((16, 20)) * 65535).astype(np.uint16)
    with pytest.raises(ValueError, match="odd"):
        t_normalmap(depth, pre_blur=2)
    with pytest.raises(ValueError, match="odd"):
        t_normalmap(depth, post_blur=4)
    assert t_normalmap(depth, pre_blur=3, post_blur=1).shape == (16, 20, 3)


# -- heatmap, naming, mesh ---------------------------------------------------

@pytest.mark.parametrize("mpl", [True, False], ids=["mpl", "table"])
def test_heatmap_byte_equal(rng, monkeypatch, mpl):
    if not mpl:
        monkeypatch.setattr(jheatmap, "_HAVE_MPL", False)
        monkeypatch.setattr(theatmap, "_HAVE_MPL", False)
    else:
        pytest.importorskip("matplotlib")
    maps = list(_maps(rng).values())
    maps.append(np.full((8, 9), 1234, np.uint16))          # vmin == vmax
    invalid = rng.random((12, 14)) * 10
    invalid[3:5, 2:9] = -99
    maps.append(invalid)
    for m in maps:
        got = theatmap.colorize(m, cmap="inferno")
        want = jheatmap.colorize(m, cmap="inferno")
        assert got.dtype == np.uint8 and got.shape == m.shape + (4,)
        np.testing.assert_array_equal(got, want)


def test_restated_naming_equal(tmp_path):
    from depthmap_tpu.io import image as jimage
    from depthmap_tpu_torch.io import image as timage
    for fn in ("a-0003-depth.png", "a-0001.png", "0007-x.png", "b-12.png",
               "a-junk.png"):
        (tmp_path / fn).write_bytes(b"")
    for base in ("a", "b", "c", None):
        assert timage.get_next_sequence_number(str(tmp_path), base) == \
            jimage.get_next_sequence_number(str(tmp_path), base)
    for base, ext, suffix in (("a", "png", "depth"), ("b", "obj", "simple"),
                              ("c", "png", "")):
        assert timage.get_unique_filename(str(tmp_path), base, ext, suffix) \
            == jimage.get_unique_filename(str(tmp_path), base, ext, suffix)


@pytest.mark.parametrize("opts", [
    dict(), dict(simple_mesh_occlude=False),
    dict(simple_mesh_spherical=True)], ids=["occlude", "keep_edges",
                                            "spherical"])
def test_custom_depthmap_outputs_byte_equal(rng, tmp_path, opts):
    """A custom depth map through both funnels: normal map, heatmap and
    the simple mesh's OBJ, byte for byte."""
    imgs = _images(rng, [(20, 36), (18, 30)])
    dms = [Image.fromarray((rng.random((20, 36)) * 255).astype(np.uint8)),
           rng.random((18, 30))]
    base = dict(compute_device="CPU", gen_normalmap=True, gen_heatmap=True,
                gen_simple_mesh=True, normalmap_pre_blur=True, **opts)
    out = {}
    for name, funnel, opt in (
            ("jax", jcore.core_generation_funnel, JOptions),
            ("port", tcore.core_generation_funnel, TOptions)):
        d = tmp_path / name
        out[name] = {}
        for idx, typ, res in funnel(str(d), imgs, dms, None, opt(**base)):
            out[name].setdefault(typ, []).append(res)
    want, got = out["jax"], out["port"]
    assert set(got) == set(want) == {"depth", "normalmap", "heatmap",
                                     "simple_mesh"}
    for typ in ("depth", "normalmap", "heatmap"):
        for g, w in zip(got[typ], want[typ]):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=typ)
    for g, w in zip(got["simple_mesh"], want["simple_mesh"]):
        assert os.path.basename(g) == os.path.basename(w)
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()


# -- the default cache --------------------------------------------------------

class _CountingPredictor:
    """Stands in for DepthPredictor: records each construction."""
    made: list = []

    def __init__(self, model_type, tiling_mode=False, **kw):
        _CountingPredictor.made.append((model_type, tiling_mode, kw))
        self.model_type = model_type
        self.raw_prediction_invert = False

    def finalized_batch(self, imgs, net_w, net_h, **kw):
        # uint8 photos in 0-255, as the funnel hands a device forward
        return torch.from_numpy((np.asarray(imgs)[..., 0] / 255.0
                                 * 65535).astype(np.uint16))


@pytest.fixture
def counting(monkeypatch):
    _CountingPredictor.made = []
    monkeypatch.setattr(tcore, "DepthPredictor", _CountingPredictor)
    monkeypatch.setattr(tcore, "_default_cache", tcore.PredictorCache())
    return _CountingPredictor.made


def test_default_cache_keeps_the_model(rng, counting):
    """Two funnel calls without a cache build one predictor; another model
    type or tiling mode builds a new one; keepmodels=False empties the
    cache."""
    imgs = _images(rng, [(16, 16)])
    inp = TOptions(compute_device="CPU", model_type=3)
    for _ in range(2):
        assert set(_run(tcore.core_generation_funnel, imgs, None, inp)) == \
            {"depth"}
    assert len(counting) == 1 and counting[0][0] == 3
    assert counting[0][2] == {"device": torch.device("cpu")}
    for other in (dict(model_type=6), dict(model_type=6, tiling_mode=True)):
        _run(tcore.core_generation_funnel, imgs, None,
             dataclasses.replace(inp, **other))
    assert [(m[0], m[1]) for m in counting] == [(3, False), (6, False),
                                                (6, True)]
    list(tcore.core_generation_funnel(None, imgs, None, None, inp,
                                      ops={"keepmodels": False}))
    assert len(counting) == 4
    assert tcore._default_cache._predictor is None


def test_cache_key_and_unload(counting):
    """A different device or dtype builds a new predictor; unload empties
    the cache as release does."""
    cache = tcore.PredictorCache()
    a = cache.get(5, device=torch.device("cpu"))
    assert cache.get("midas_v21", device=torch.device("cpu")) is a
    b = cache.get(5, device=torch.device("meta"))
    c = cache.get(5, device=torch.device("meta"), compute_dtype="float32")
    assert len({id(a), id(b), id(c)}) == 3 and len(counting) == 3
    cache.unload()
    assert cache._predictor is None
    cache.get(5, device=torch.device("meta"), compute_dtype="float32")
    assert len(counting) == 4


# -- the model path with every output ----------------------------------------

def _vit_predictors(seed: int):
    from depthmap_tpu.pipeline.depth import DepthPredictor as JPred
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.weights import state_dict_from_jax
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor as TPred
    from tests.test_torch_port_midas import jax_model, jax_variables, \
        torch_model
    variables = jax_variables("vit", seed)
    jp = JPred(3, params=variables, compute_dtype="float32")
    jp.bundle = dataclasses.replace(jp.bundle, module=jax_model("vit"))
    with torch.device("meta"):
        bundle = build_model(3)
    tp = TPred(3, state_dict=state_dict_from_jax(variables),
               compute_dtype=torch.float32, device="cpu",
               bundle=dataclasses.replace(bundle, module=torch_model("vit")))
    return jp, tp


def _read_obj(path):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:]])
            elif line.startswith("f "):
                faces.append(tuple(int(t) for t in line.split()[1:]))
    return np.array(verts), set(faces)


def test_vit_funnel_all_outputs_match_jax(rng, tmp_path):
    """Type 3 (a small ViT DPT in its layout) through both funnels: two
    same-shape images ride the port's batched pre-pass for depth, normal
    map and heatmap, a third image the serial path; then the simple mesh,
    which takes the raw map to the host (no pre-pass, no fused path)."""
    jp, tp = _vit_predictors(seed=7)

    class JCache(jcore.PredictorCache):
        def get(self, model_type, tiling_mode=False, **kw):
            return jp

    imgs = _images(rng, [(48, 80), (48, 80), (40, 40)])
    base = dict(compute_device="CPU", model_type=3, net_width=64,
                net_height=64, gen_normalmap=True, gen_heatmap=True)
    want = _run(jcore.core_generation_funnel, imgs, None, JOptions(**base),
                JCache())
    got = _run(tcore.core_generation_funnel, imgs, None, TOptions(**base),
               _FixedCache(tp))
    assert set(got) == set(want) == {"depth", "normalmap", "heatmap"}
    for (_, g), (_, w) in zip(got["depth"], want["depth"]):
        assert g.dtype == np.uint16 and g.max() - g.min() > 1000
        d = np.abs(g.astype(np.int64) - w.astype(np.int64))
        assert d.max() <= I16_TOL, d.max()
    # the derived outputs are those of the port's own depth map
    for (i, depth), (_, nm), (_, hm) in zip(got["depth"], got["normalmap"],
                                            got["heatmap"]):
        assert nm.shape == depth.shape + (3,)
        assert hm.shape == depth.shape + (4,)
        assert_normals_close(nm, np.asarray(j_normalmap(jnp.asarray(depth))))
        np.testing.assert_array_equal(hm, jheatmap.colorize(depth))

    mesh = dict(base, gen_normalmap=False, gen_heatmap=False,
                gen_simple_mesh=True)
    objs = {}
    for name, funnel, opt, cache in (
            ("jax", jcore.core_generation_funnel, JOptions, JCache()),
            ("port", tcore.core_generation_funnel, TOptions,
             _FixedCache(tp))):
        objs[name] = [r for _, typ, r in funnel(str(tmp_path / name),
                                                imgs[2:], None, None,
                                                opt(**mesh),
                                                predictor_cache=cache)
                      if typ == "simple_mesh"]
    (gv, gf), (wv, wf) = (_read_obj(objs["port"][0]),
                          _read_obj(objs["jax"][0]))
    assert gv.shape == wv.shape == (40 * 40, 6)
    np.testing.assert_allclose(gv[:, 3:], wv[:, 3:], atol=1e-6)  # colours
    np.testing.assert_allclose(gv[:, :3], wv[:, :3], rtol=0,
                               atol=1e-3 * np.ptp(wv[:, :3]))
    assert len(gf ^ wf) <= 0.01 * len(wf)


def test_cli_derived_outputs(rng, tmp_path):
    """--normalmap --heatmap --mesh with a custom depth map: no model, no
    card; the OBJ lands in the output directory."""
    img, dm = tmp_path / "img.png", tmp_path / "dm.png"
    Image.fromarray(_images(rng, [(16, 24)])[0]).save(img)
    Image.fromarray((rng.random((16, 24)) * 255).astype(np.uint8)).save(dm)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "depthmap_tpu_torch.cli", str(img),
         "--depthmap", str(dm), "--normalmap", "--heatmap", "--mesh",
         "--compute-device", "CPU", "-o", str(out)], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    files = sorted(os.listdir(out))
    assert len(files) == 4, files
    normal = [f for f in files if f.endswith("-normal.png")]
    heat = [f for f in files if f.endswith("-heatmap.png")]
    obj = [f for f in files if f.endswith("-simple.obj")]
    assert normal and heat and obj
    assert np.asarray(Image.open(out / normal[0])).shape == (16, 24, 3)
    assert np.asarray(Image.open(out / heat[0])).shape == (16, 24, 4)
    assert sum(1 for line in open(out / obj[0])
               if line.startswith("v ")) == 16 * 24
