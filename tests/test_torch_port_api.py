"""The port's REST server (depthmap_tpu_torch/frontends/api.py) against the
JAX package's (depthmap_tpu/frontends/api.py), each on a thread of this
process and each over its own funnel.

Both funnels run the same small DPT-BEiT (tests/test_torch_port_model.py,
f32, the JAX variables carried into the port by state_dict_from_jax),
injected as each package's default predictor cache.  The same request
gives the same status code and JSON body on every route (the version
string names each package); the decoded uint16 maps agree within I16_TOL
(the small BEiT's atol 3e-3 / rtol 1e-3 in 16-bit counts,
tests/test_torch_port_funnel.py).  The request carries no depth map, so
the encoding is also held alone: the port's PNG of a funnel output is
byte-equal to the JAX route's PNG of the same array as a PIL image.
"""
from __future__ import annotations

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from depthmap_tpu.frontends import api as japi
from depthmap_tpu.pipeline import core as jcore
from depthmap_tpu_torch.frontends import api as tapi
from depthmap_tpu_torch.pipeline import core as tcore
from tests.test_torch_port_funnel import I16_TOL, _FixedCache, _predictors


class _JCache(jcore.PredictorCache):
    def __init__(self, pred):
        super().__init__()
        self.pred = pred

    def get(self, model_type, tiling_mode=False, **kw):
        return self.pred


@pytest.fixture(scope="module")
def servers():
    """(JAX url, port url), each server over its package's small BEiT."""
    jp, tp = _predictors()
    mp = pytest.MonkeyPatch()
    mp.setattr(jcore, "_default_cache", _JCache(jp))
    mp.setattr(tcore, "_default_cache", _FixedCache(tp))
    srvs = [japi.make_server("127.0.0.1", 0), tapi.make_server("127.0.0.1", 0)]
    for s in srvs:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    yield [f"http://127.0.0.1:{s.server_address[1]}" for s in srvs]
    for s in srvs:
        s.shutdown()
        s.server_close()
    mp.undo()


def _request(url, payload=None, headers=None, data=None):
    if payload is not None:
        data = json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64_png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_version_names_each_package(servers):
    (js, jb), (ts, tb) = [_request(u + "/depth/version") for u in servers]
    assert js == ts == 200 and set(jb) == set(tb) == {"version"}
    assert tb["version"] == tapi.SCRIPT_VERSION
    assert "torch" in tb["version"] and jb["version"] != tb["version"]


@pytest.mark.parametrize("case", [
    ("GET", "/depth/get_options", None),
    ("GET", "/depth/nope", None),
    ("POST", "/depth/nope", {}),
    ("POST", "/depth/generate", {"depth_input_images": [], "options": {}}),
    ("POST", "/depth/generate/video", {"depth_input_images": []}),
    ("POST", "/depth/generate/video", {"depth_input_images": ["x"],
                                       "options": {"model_type": "nope"}}),
    ("POST", "/depth/generate/video", {"depth_input_images": ["x"],
                                       "options": {"model_type": 1}}),
    ("POST", "/depth/generate/video", {
        "depth_input_images": ["x"], "options": {
            "model_type": 1, "video_parameters": {"vid_fps": 4}}}),
    ("POST", "/depth/generate/video", {
        "depth_input_images": ["x"], "options": {
            "model_type": "dpt_beit_large_512", "video_parameters": {
                "vid_numframes": 2, "vid_fps": 4, "vid_traj": 0,
                "vid_shift": "0, 0, 0", "vid_border": "0, 0, 0, 0",
                "dolly": False, "vid_format": "mp4", "vid_ssaa": 1,
                "output_filename": "out/v.webm"}}}),
], ids=["options", "get_404", "post_404", "generate_422", "video_422",
        "video_bad_model", "video_no_parameters", "video_missing",
        "video_format_mismatch"])
def test_routes_give_the_same_status_and_body(servers, case):
    method, path, payload = case
    got = [_request(u + path, payload if method == "POST" else None)
           for u in servers]
    assert got[0] == got[1]
    assert got[0][0] != 200 or path == "/depth/get_options"


def test_get_options_lists_every_field(servers):
    from depthmap_tpu_torch.options import GenerationOptions
    status, body = _request(servers[1] + "/depth/get_options")
    assert status == 200
    assert body["options"] == sorted(GenerationOptions.field_names())


@pytest.mark.parametrize("headers,data", [
    ({"Content-Length": str((256 << 20) + 1)}, b"{}"),
    ({}, b"{not json"),
], ids=["413", "invalid_json"])
def test_body_errors_match(servers, headers, data):
    got = [_request(u + "/depth/generate", headers=headers, data=data)
           for u in servers]
    assert got[0] == got[1] and got[0][0] in (400, 413)


def test_generate_matches_jax(servers, rng, tmp_path):
    """Two same-shape images (each funnel's batched pre-pass) and one
    other, depth + polylines stereo on the small BEiT: the same number of
    PNGs in the same order, uint16 maps within I16_TOL, stereo images of
    the same shape and dtype."""
    imgs = [(rng.random((h, w, 3)) * 255).astype(np.uint8)
            for h, w in [(48, 80), (48, 80), (40, 40)]]
    payload = {"depth_input_images": [_b64_png(i) for i in imgs],
               "options": {"model_type": 1, "net_width": 64,
                           "net_height": 64, "compute_device": "CPU",
                           "gen_stereo": True},
               "outpath": str(tmp_path)}
    (js, jb), (ts, tb) = [_request(u + "/depth/generate", payload)
                          for u in servers]
    assert js == ts == 200 and jb["info"] == tb["info"] == "Success"
    assert len(jb["images"]) == len(tb["images"]) == 9
    for j64, t64 in zip(jb["images"], tb["images"]):
        j, t = _decode(j64), _decode(t64)
        assert j.dtype == t.dtype and j.shape == t.shape
        if t.dtype == np.uint16:
            assert t.max() - t.min() > 1000
            d = np.abs(j.astype(np.int64) - t.astype(np.int64))
            assert d.max() <= I16_TOL, d.max()


@pytest.mark.parametrize("kind", ["uint16", "rgb", "rgba", "gray8"])
def test_png_encoding_byte_equal_to_jax(rng, kind):
    shape = {"uint16": (20, 30), "rgb": (20, 30, 3), "rgba": (20, 30, 4),
             "gray8": (20, 30)}[kind]
    top = 65536 if kind == "uint16" else 256
    arr = rng.integers(0, top, size=shape).astype(
        np.uint16 if kind == "uint16" else np.uint8)
    got = tapi.encode_array_to_base64(arr)
    assert got == japi.encode_pil_to_base64(Image.fromarray(arr))
    np.testing.assert_array_equal(_decode(got), arr)


def test_only_image_outputs_are_sent():
    """What the JAX route sends (PIL images) is what the port sends:
    uint8 / uint16 arrays; not a raw float map nor a path."""
    assert tapi.is_image_output(np.zeros((2, 2), np.uint16))
    assert tapi.is_image_output(np.zeros((2, 2, 3), np.uint8))
    assert not tapi.is_image_output(np.zeros((2, 2), np.float32))
    assert not tapi.is_image_output("mesh.obj")
