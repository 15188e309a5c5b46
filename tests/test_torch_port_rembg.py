"""Background removal in the port's funnel against the JAX funnel's, on a
fake ``rembg`` module put in ``sys.modules`` (rembg is not installed).

The fake removes the pixels whose red channel is under 128 (black, alpha
0) and keeps the rest opaque.  With custom depth maps both funnels are
byte-equal on every output: the RGBA image, the foreground mask, the
masked uint16 map and the stereo pair; the map handed to the 3D photo
carries the mask too.  Pre-depth removal feeds the removed image to the
model: on the small DPT-BEiT the maps agree within I16_TOL.
"""
from __future__ import annotations

import sys
import types

import numpy as np
import pytest
from PIL import Image

from depthmap_tpu.options import GenerationOptions as JOptions
from depthmap_tpu.pipeline import core as jcore
from depthmap_tpu_torch.options import GenerationOptions as TOptions
from depthmap_tpu_torch.pipeline import core as tcore
from depthmap_tpu_torch.pipeline import rembg_integration as trembg
from tests.test_torch_port_api import _JCache
from tests.test_torch_port_funnel import (I16_TOL, _FixedCache, _images,
                                          _predictors, _run)


@pytest.fixture
def fake_rembg(monkeypatch):
    sessions = []
    mod = types.ModuleType("rembg")

    def new_session(name):
        sessions.append(name)
        return ("session", name)

    def remove(im, session=None):
        assert session == ("session", sessions[-1])
        arr = np.asarray(im.convert("RGB"))
        fg = arr[..., 0] >= 128
        out = np.zeros(arr.shape[:2] + (4,), np.uint8)
        out[fg, :3] = arr[fg]
        out[fg, 3] = 255
        return Image.fromarray(out)

    mod.new_session, mod.remove = new_session, remove
    monkeypatch.setitem(sys.modules, "rembg", mod)
    return sessions


@pytest.mark.parametrize("opts", [
    dict(),
    dict(pre_depth_background_removal=True,
         save_background_removal_masks=True, rembg_model="u2netp"),
    dict(save_background_removal_masks=True, output_depth_invert=True),
], ids=["post", "pre_masks", "post_masks_invert"])
def test_custom_depthmap_outputs_byte_equal(rng, fake_rembg, opts):
    imgs = _images(rng, [(20, 36), (18, 30)])
    dms = [rng.random((20, 36)), rng.random((18, 30))]
    base = dict(compute_device="CPU", gen_rembg=True, gen_stereo=True,
                **opts)
    want = _run(jcore.core_generation_funnel, imgs, dms, JOptions(**base))
    got = _run(tcore.core_generation_funnel, imgs, dms, TOptions(**base))
    assert fake_rembg == [opts.get("rembg_model", "u2net")] * 2
    assert set(got) == set(want)
    assert "background_removed" in got and "depth" in got
    assert ("foreground_mask" in got) == \
        bool(opts.get("save_background_removal_masks"))
    for typ in want:
        assert [i for i, _ in got[typ]] == [i for i, _ in want[typ]]
        for (_, g), (_, w) in zip(got[typ], want[typ]):
            assert g.dtype == w.dtype and g.shape == w.shape, typ
            np.testing.assert_array_equal(g, w, err_msg=typ)
    # the background reads far: 0, or 65535 inverted
    far = 65535 if opts.get("output_depth_invert") else 0
    for (_, d), (_, rgba) in zip(got["depth"], got["background_removed"]):
        assert (d[rgba[..., 3] == 0] == far).all()


def test_mask_reaches_the_3d_photo(rng, fake_rembg, monkeypatch):
    """The uint16 map kept for the inpainted mesh is masked in place, as
    in the JAX funnel (both funnels' run_3dphoto stubbed to capture it)."""
    from depthmap_tpu.pipeline import inpaint_video as jiv
    from depthmap_tpu_torch.pipeline import inpaint_video as tiv
    seen = {}

    def capture(key):
        def run_3dphoto(dev, imgs, depths, names, outpath, *a, **kw):
            seen[key] = [np.array(d) for d in depths]
            return "mesh.obj"
        return run_3dphoto
    monkeypatch.setattr(jiv, "run_3dphoto", capture("jax"))
    monkeypatch.setattr(tiv, "run_3dphoto", capture("port"))
    imgs = _images(rng, [(16, 24)])
    dms = [rng.random((16, 24))]
    base = dict(compute_device="CPU", gen_rembg=True, gen_inpainted_mesh=True)
    _run(jcore.core_generation_funnel, imgs, dms, JOptions(**base))
    _run(tcore.core_generation_funnel, imgs, dms, TOptions(**base))
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    bg = np.asarray(imgs[0])[..., 0] < 128
    assert bg.any() and (seen["port"][0][bg] == 0).all()


def test_pre_depth_removal_on_the_model(rng, fake_rembg):
    jp, tp = _predictors()
    imgs = _images(rng, [(48, 80), (48, 80)])
    base = dict(compute_device="CPU", model_type=1, net_width=64,
                net_height=64, gen_rembg=True,
                pre_depth_background_removal=True)
    want = _run(jcore.core_generation_funnel, imgs, None, JOptions(**base),
                _JCache(jp))
    got = _run(tcore.core_generation_funnel, imgs, None, TOptions(**base),
               _FixedCache(tp))
    plain = _run(tcore.core_generation_funnel, imgs, None,
                 TOptions(**dict(base, gen_rembg=False)), _FixedCache(tp))
    for (_, g), (_, w), (_, p) in zip(got["depth"], want["depth"],
                                      plain["depth"]):
        d = np.abs(g.astype(np.int64) - w.astype(np.int64))
        assert d.max() <= I16_TOL, d.max()
        assert not np.array_equal(g, p)   # the model saw the removed image


def test_helpers_equal_jax(rng):
    from depthmap_tpu.pipeline import rembg_integration as jrembg
    assert trembg.REMBG_MODELS == jrembg.REMBG_MODELS
    rgba = (rng.random((12, 10, 4)) * 2).astype(np.uint8)
    rgba[:4] = 0               # background: black, alpha 0
    rgba[4:6] = (0, 0, 0, 255)   # black but opaque: foreground
    mask = trembg.background_mask(rgba)
    np.testing.assert_array_equal(
        mask, jrembg.background_mask(Image.fromarray(rgba)))
    np.testing.assert_array_equal(
        trembg.foreground_mask_image(mask),
        np.asarray(jrembg.foreground_mask_image(mask)))
    assert mask.any() and not mask.all()


def test_rembg_absent_is_reported(monkeypatch):
    monkeypatch.setitem(sys.modules, "rembg", None)
    assert trembg.rembg_available() is False
