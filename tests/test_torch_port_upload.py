"""The uint8 upload: a photo crosses to the predictor's device as its
bytes and becomes the f32 /255 input there, equal bit for bit to the
host's ``x.astype(np.float32) / 255.0``; the funnel hands a device forward
its uint8 photos and opens one ``upload_u8`` span per forward.

Imports no JAX, so the card's case runs with
``python -m pytest --noconftest tests/test_torch_port_upload.py -m cuda``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from depthmap_tpu_torch.models.build import ModelBundle
from depthmap_tpu_torch.models.weights import init_random_
from depthmap_tpu_torch.options import GenerationOptions
from depthmap_tpu_torch.pipeline import core
from depthmap_tpu_torch.pipeline.depth import DepthPredictor, u8_to_unit
from depthmap_tpu_torch.pipeline.preprocess import PreprocessCfg
from depthmap_tpu_torch.registry import MODELS
from depthmap_tpu_torch.utils import profiling


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_u8_to_unit_equals_the_host_division(device):
    """Every byte value, on the CPU and on a card."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    values = np.arange(256, dtype=np.uint8)
    got = u8_to_unit(torch.from_numpy(values).to(device)).cpu().numpy()
    want = values.astype(np.float32) / 255.0
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _tiny(device):
    """A DPT-BEiT of width 128 (heads of 64, as K1 takes) and depth 4 on
    ``device``, seeded random weights, with the BEiT DPTs'
    preprocessing."""
    from depthmap_tpu_torch.models.beit import BeitBackbone
    from depthmap_tpu_torch.models.dpt import DPTDepthModel
    module = DPTDepthModel(
        BeitBackbone(embed_dim=128, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
                     train_img_size=32),
        reassemble_channels=(8, 16, 32, 32), features=16)
    init_random_(module, 5)
    return DepthPredictor(1, state_dict=module.state_dict(), device=device,
                          compute_dtype=torch.float32,
                          bundle=ModelBundle(MODELS[1], module, PreprocessCfg(
                              resize_mode="minimal", mean=(0.5,) * 3,
                              std=(0.5,) * 3, swap_channels=True)))


@pytest.fixture(scope="module")
def tiny():
    return _tiny("cpu")


def _photos(n, h=24, w=40, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def test_u8_input_gives_the_f32_inputs_map(tiny):
    """predict_finalized and finalized_batch: uint8 photos (a stack and a
    list) give the same uint16 maps, byte for byte, as the host's f32."""
    photos = _photos(2)
    f32 = [p.astype(np.float32) / 255.0 for p in photos]
    one = tiny.predict_finalized(photos[0], 32, 32)
    assert one.dtype == np.uint16 and int(one.max()) - int(one.min()) > 1000
    np.testing.assert_array_equal(one, tiny.predict_finalized(f32[0], 32, 32))
    want = tiny.finalized_batch(np.stack(f32), 32, 32).numpy()
    for imgs in (photos, np.stack(photos)):
        np.testing.assert_array_equal(
            tiny.finalized_batch(imgs, 32, 32).numpy(), want)


@pytest.mark.cuda
def test_u8_upload_on_the_card():
    """On a card the uint8 route (pinned staging, a read-only photo
    among them) gives the f32 stack's maps byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pred = _tiny("cuda")
    photos = _photos(3)
    photos[1].setflags(write=False)
    want = pred.finalized_batch(
        np.stack(photos).astype(np.float32) / 255.0, 32, 32).cpu().numpy()
    got = pred.finalized_batch(photos, 32, 32).cpu().numpy()
    assert int(got.max()) - int(got.min()) > 1000
    np.testing.assert_array_equal(got, want)


class _Fixed(core.PredictorCache):
    def __init__(self, pred):
        super().__init__()
        self.pred = pred

    def get(self, model_type, tiling_mode=False, **kw):
        return self.pred


def _funnel_spans(pred, n, **opts):
    """Span names of one funnel call on ``n`` same-shape uint8 photos."""
    profiling.reset()
    inp = GenerationOptions(compute_device="CPU", model_type=1,
                            net_width=32, net_height=32, **opts)
    out = list(core.core_generation_funnel(None, _photos(n), None, None, inp,
                                           predictor_cache=_Fixed(pred)))
    assert len([o for o in out if o[1] == "depth"]) == n
    return [s.name for s in profiling.spans()]


def test_one_upload_u8_per_device_forward(tiny, monkeypatch):
    """The funnel's chunks (of 2: three photos make two forwards, one photo
    one) open one upload_u8 per forward; the raw map's host path
    (depth_prediction) opens none."""
    monkeypatch.setattr(core, "FUNNEL_CHUNK", 2)
    names = _funnel_spans(tiny, 3)
    assert names.count("upload") == names.count("upload_u8") == 2
    names = _funnel_spans(tiny, 1)
    assert names.count("upload") == names.count("upload_u8") == 1
    names = _funnel_spans(tiny, 2, do_output_depth_prediction=True)
    assert names.count("upload") == 2 and "upload_u8" not in names


def test_a_host_pipeline_gets_the_host_division(tiny, monkeypatch):
    """A host pipeline (Marigold's route) given uint8 photos through the
    funnel takes the device route: one upload_u8 for the funnel's chunk,
    and each photo's (1, 3, H, W) net input equal bit for bit to the
    host's f32 /255 (the processing size here is the photo's own, where
    the cubic resize is the identity)."""
    seen = []

    class Pipeline:
        @staticmethod
        def processing_size(h, w, processing_res):
            return h, w

        def __call__(self, x, **kw):
            seen.append(x)
            return x[:, 0]
    monkeypatch.setattr(tiny, "bundle", dataclasses.replace(
        tiny.bundle, module=Pipeline(), host_pipeline=True))
    names = _funnel_spans(tiny, 2)
    assert names.count("upload") == names.count("upload_u8") == 1
    assert names.count("marigold_resize") == 4
    want = [p.astype(np.float32) / 255.0 for p in _photos(2)]
    assert len(seen) == 2
    for got, w in zip(seen, want):
        assert got.dtype == torch.float32 and got.shape == (1, 3) + \
            w.shape[:2]
        np.testing.assert_array_equal(got[0].permute(1, 2, 0).numpy(), w)
