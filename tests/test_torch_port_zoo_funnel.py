"""LeReS (type 0), the MiDaS zoo's types 2, 4, 5 and 6 and ZoeDepth n / k /
nk (types 7-9) through both funnels on the same weights (type 3 runs in
tests/test_torch_port_outputs.py).

Each type's bundle (preprocess, resize rule, upsample) is the full-width
one; its module is the small stand-in of tests/test_torch_port_midas.py,
tests/test_torch_port_leres.py or tests/test_torch_port_zoedepth.py
(BEiT-384's is a small BEiT with a 3 x 3 training window, ZoeDepth's core
one with a 4 x 4 window, so their relative-position tables are resized;
ZoeDepth's in-model resize takes the 48 x 80 images to a 64 x 96 net
input, the 40 x 40 one to 64 x 64).  Two same-shape images ride the
port's batched pre-pass, a third the serial path, with depth, normal map
and heatmap; the uint16 maps are held to I16_TOL counts, the derived
outputs to the JAX package's own functions on the port's map.  Then the
port's simple mesh of one image: a vertex a pixel.  f32 throughout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu.ops import heatmap as jheatmap
from depthmap_tpu.ops.normalmap import create_normalmap as j_normalmap
from depthmap_tpu.options import GenerationOptions as JOptions
from depthmap_tpu.pipeline import core as jcore
from depthmap_tpu_torch.options import GenerationOptions as TOptions
from depthmap_tpu_torch.pipeline import core as tcore
from tests import test_torch_port_zoedepth as zoe
from tests.test_torch_port_funnel import I16_TOL, _FixedCache, _images, _run
from tests.test_torch_port_leres import small_resnext  # noqa: F401
from tests.test_torch_port_midas import RESNEXT, _draw, jax_model, \
    small_encoders, torch_model  # noqa: F401  (fixtures)
from tests.test_torch_port_outputs import assert_normals_close

# model type -> the small stand-in's kind
KIND = {0: "leres", 2: "beit384", 4: "hybrid", 5: "v21", 6: "small",
        7: "zoe_n", 8: "zoe_k", 9: "zoe_nk"}
BEIT = dict(embed_dim=64, depth=4, num_heads=4, hooks=(0, 1, 2, 3),
            train_img_size=48)
BEIT_CHANNELS = (16, 32, 64, 64)


def _beit(framework: str):
    if framework == "jax":
        from depthmap_tpu.models.beit import BeitBackbone
        from depthmap_tpu.models.dpt import DPTDepthModel
        return DPTDepthModel(backbone=BeitBackbone(**BEIT),
                             reassemble_channels=BEIT_CHANNELS, features=32)
    from depthmap_tpu_torch.models.beit import BeitBackbone
    from depthmap_tpu_torch.models.dpt import DPTDepthModel
    return DPTDepthModel(BeitBackbone(**BEIT), BEIT_CHANNELS, 32)


def _predictors(mt: int, seed: int):
    """The JAX and the port predictors of type ``mt`` around its small
    stand-in, on the same weights."""
    from depthmap_tpu.pipeline.depth import DepthPredictor as JPred
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.weights import state_dict_from_jax
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor as TPred
    from depthmap_tpu.models.leres import RelDepthModel
    from depthmap_tpu_torch.models.leres import build_leres
    kind = KIND[mt]
    if kind.startswith("zoe"):
        jm, tm = zoe.models(kind[4:], beit=True)
    elif kind == "leres":
        jm, tm = RelDepthModel(), build_leres(**RESNEXT)
    elif kind == "beit384":
        jm, tm = _beit("jax"), _beit("torch")
    else:
        jm, tm = jax_model(kind), torch_model(kind)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = _draw(shapes, seed)
    jp = JPred(mt, params=variables, compute_dtype="float32")
    jp.bundle = dataclasses.replace(jp.bundle, module=jm)
    with torch.device("meta"):
        bundle = build_model(mt)
    tp = TPred(mt, state_dict=state_dict_from_jax(variables),
               compute_dtype=torch.float32, device="cpu",
               bundle=dataclasses.replace(bundle, module=tm))
    return jp, tp


@pytest.mark.parametrize("mt", sorted(KIND))
def test_zoo_funnel_matches_jax(small_encoders, small_resnext, rng, tmp_path,
                                mt):
    jp, tp = _predictors(mt, seed=30 + mt)

    class JCache(jcore.PredictorCache):
        def get(self, model_type, tiling_mode=False, **kw):
            return jp

    imgs = _images(rng, [(48, 80), (48, 80), (40, 40)])
    base = dict(compute_device="CPU", model_type=mt, net_width=64,
                net_height=64, gen_normalmap=True, gen_heatmap=True)
    want = _run(jcore.core_generation_funnel, imgs, None, JOptions(**base),
                JCache())
    got = _run(tcore.core_generation_funnel, imgs, None, TOptions(**base),
               _FixedCache(tp))
    assert set(got) == set(want) == {"depth", "normalmap", "heatmap"}
    for (_, g), (_, w) in zip(got["depth"], want["depth"]):
        assert g.dtype == np.uint16 and g.shape == w.shape
        assert g.max() - g.min() > 1000       # a live map
        d = np.abs(g.astype(np.int64) - w.astype(np.int64))
        assert d.max() <= I16_TOL, d.max()
    for (_, depth), (_, nm), (_, hm) in zip(got["depth"], got["normalmap"],
                                            got["heatmap"]):
        assert_normals_close(nm, np.asarray(j_normalmap(jnp.asarray(depth))))
        np.testing.assert_array_equal(hm, jheatmap.colorize(depth))

    mesh = TOptions(compute_device="CPU", model_type=mt, net_width=64,
                    net_height=64, gen_simple_mesh=True)
    out = [(typ, r) for _, typ, r in tcore.core_generation_funnel(
        str(tmp_path), imgs[2:], None, None, mesh,
        predictor_cache=_FixedCache(tp))]
    assert [typ for typ, _ in out] == ["depth", "simple_mesh"]
    with open(out[1][1]) as f:
        assert sum(1 for line in f if line.startswith("v ")) == 40 * 40
