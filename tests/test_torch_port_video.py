"""Video mode on the port against the JAX package's (CPU).

The stdlib Y16 AVI writer byte for byte (fractional fps too) and each
reader on the other's file; ``process_predictions`` ("none" and
"experimental") exactly; ``frames_to_video``'s depth and colour routes
byte for byte; pass 1's uint8 chunks (one ``upload_u8`` each) equal to
``predict_batch`` on the host's f32 /255 stacks bit for bit; pass 1
(``_predict_video_depths``, 10 frames in chunks of 4, a tail of 2 that
the port runs as its own batch where the JAX package pads it) on the
small BEiT of tests/test_torch_port_funnel.py, f32, to 1e-3 of the range;
``gen_video`` end to end on a directory of 6 PNG frames: the
JAX output's file names and depth frames within 1 count of 16 bits; the
CLI's ``--video`` on the CPU.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from depthmap_tpu.io import avi as javi
from depthmap_tpu.options import GenerationOptions as JOptions
from depthmap_tpu.pipeline import core as jcore
from depthmap_tpu.pipeline import video_mode as jvm
from depthmap_tpu_torch.io import avi as tavi
from depthmap_tpu_torch.options import GenerationOptions as TOptions
from depthmap_tpu_torch.pipeline import video_mode as tvm
from tests.test_torch_port_funnel import REPO, _FixedCache, _images, \
    _predictors


@pytest.fixture(scope="module")
def predictors():
    return _predictors()


def _jcache(jp):
    class JCache(jcore.PredictorCache):
        def get(self, model_type, tiling_mode=False, **kw):
            return jp
    return JCache()


def _frames16(rng, n, h, w):
    return [rng.integers(0, 65536, (h, w), dtype=np.uint16)
            for _ in range(n)]


@pytest.mark.parametrize("fps", [24.0, 29.97, 30000 / 1001, 12.5])
def test_avi_bytes_equal_jax(rng, tmp_path, fps):
    frames = _frames16(rng, 3, 9, 13)    # odd width: odd-sized payloads
    javi.write_gray16_avi(frames, fps, str(tmp_path / "j.avi"))
    tavi.write_gray16_avi(frames, fps, str(tmp_path / "t.avi"))
    jb = (tmp_path / "j.avi").read_bytes()
    assert (tmp_path / "t.avi").read_bytes() == jb
    for read, path in ((tavi.read_gray16_avi, "j.avi"),
                       (javi.read_gray16_avi, "t.avi")):
        got_fps, got = read(str(tmp_path / path))
        assert got_fps == pytest.approx(fps, rel=1e-6)
        assert len(got) == 3
        for g, f in zip(got, frames):
            np.testing.assert_array_equal(g, f)
    assert tavi.read_gray16_avi(str(tmp_path / "missing.avi")) is None
    (tmp_path / "bad.avi").write_bytes(jb[:40])
    assert tavi.read_gray16_avi(str(tmp_path / "bad.avi")) is None


@pytest.mark.parametrize("smoothening", ["none", "experimental"])
def test_process_predictions_equal_jax(rng, smoothening):
    preds = [rng.normal(size=(6, 7)).astype(np.float32) * (i + 1)
             for i in range(7)]
    want = jvm.process_predictions([p.copy() for p in preds], smoothening)
    got = tvm.process_predictions([p.copy() for p in preds], smoothening)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_frames_to_video_routes_equal_jax(rng, tmp_path):
    """The 16-bit route (no pyav here: the Y16 AVI) and the colour route
    (a GIF through PIL) write the JAX package's files byte for byte."""
    depth = _frames16(rng, 4, 10, 14)
    want = jvm.frames_to_video(
        25.0, [Image.fromarray(d) for d in depth],
        str(tmp_path / "j"), "d")
    got = tvm.frames_to_video(25.0, depth, str(tmp_path / "t"), "d")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["d.avi"]
    assert open(got[0], "rb").read() == open(want[0], "rb").read()
    color = _images(rng, [(10, 14)] * 4)
    want = jvm.frames_to_video(25.0, [Image.fromarray(c) for c in color],
                               str(tmp_path / "j"), "c")
    got = tvm.frames_to_video(25.0, color, str(tmp_path / "t"), "c")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert open(got[0], "rb").read() == open(want[0], "rb").read()


def test_pass1_sends_uint8_chunks(rng, predictors):
    """10 frames in the default chunks (FUNNEL_CHUNK): one upload_u8 a
    chunk, and the maps equal predict_batch's on the f32 /255 stacks bit
    for bit."""
    from depthmap_tpu_torch.pipeline.core import FUNNEL_CHUNK
    from depthmap_tpu_torch.utils import profiling
    _, tp = predictors
    arrays = _images(rng, [(32, 48)] * 10)
    opts = TOptions(compute_device="CPU", model_type=1, net_width=64,
                    net_height=64)
    profiling.reset()
    got = tvm._predict_video_depths([Image.fromarray(a) for a in arrays],
                                    opts, _FixedCache(tp))
    names = [s.name for s in profiling.spans()]
    chunks = [np.stack(arrays[s:s + FUNNEL_CHUNK]).astype(np.float32) / 255.0
              for s in range(0, len(arrays), FUNNEL_CHUNK)]
    assert len(chunks) == 2
    assert names.count("upload") == names.count("upload_u8") == len(chunks)
    want = np.concatenate([tp.predict_batch(c, 64, 64) for c in chunks])
    if tp.raw_prediction_invert:
        want = -want
    assert len(got) == len(want) == 10
    np.testing.assert_array_equal(np.stack(got), want)


def test_pass1_matches_jax(rng, predictors):
    """10 frames of 32 x 48 in chunks of 4: the port's tail of 2 runs as
    its own batch, the JAX package's is padded to 4."""
    jp, tp = predictors
    frames = [Image.fromarray(a) for a in _images(rng, [(32, 48)] * 10)]
    opts = dict(compute_device="CPU", model_type=1, net_width=64,
                net_height=64)
    want = jvm._predict_video_depths(frames, JOptions(**opts), _jcache(jp),
                                     chunk=4)
    got = tvm._predict_video_depths(frames, TOptions(**opts),
                                    _FixedCache(tp), chunk=4)
    assert len(got) == len(want) == 10
    span = np.ptp(np.stack(want))
    assert span > 0.1
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=1e-3 * span)


def test_gen_video_matches_jax(rng, tmp_path, predictors):
    """6 PNG frames, depth + left-right stereo (polylines_sharp): the JAX
    output's names, depth frames within 1 count, stereo frames of the same
    shape."""
    jp, tp = predictors
    src = tmp_path / "frames"
    src.mkdir()
    for i, a in enumerate(_images(rng, [(24, 40)] * 6)):
        Image.fromarray(a).save(src / f"f{i:02d}.png")
    opts = dict(compute_device="CPU", model_type=1, net_width=64,
                net_height=64, gen_stereo=True, stereo_modes=["left-right"])
    want = jvm.gen_video(str(src), str(tmp_path / "j"), JOptions(**opts),
                         predictor_cache=_jcache(jp))
    got = tvm.gen_video(str(src), str(tmp_path / "t"), TOptions(**opts),
                        predictor_cache=_FixedCache(tp))
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in want]
    assert names == ["depthmap-0-depth_video.avi",
                     "depthmap-0-left-right_video.gif"]
    fps_j, dj = javi.read_gray16_avi(want[0])
    fps_t, dt = tavi.read_gray16_avi(got[0])
    assert fps_t == fps_j == 24.0 and len(dt) == len(dj) == 6
    d = np.abs(np.stack(dt).astype(np.int64) - np.stack(dj))
    assert d.max() <= 1, d.max()
    with Image.open(got[1]) as g, Image.open(want[1]) as w:
        assert g.n_frames == w.n_frames == 6 and g.size == w.size == (80, 24)


def test_cli_video_writes_videos(rng, tmp_path):
    """``--video`` on a directory of frames, depth only, from a depth model
    the funnel builds (midas_v21_small at random init, net 64)."""
    src = tmp_path / "frames"
    src.mkdir()
    for i, a in enumerate(_images(rng, [(20, 28)] * 3)):
        Image.fromarray(a).save(src / f"{i}.png")
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "depthmap_tpu_torch.cli", "--video", str(src),
         "--model", "midas_v21_small", "--net-width", "64",
         "--net-height", "64", "--compute-device", "CPU", "--output",
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert sorted(os.listdir(out)) == ["depthmap-0-depth_video.avi"]
    fps, frames = tavi.read_gray16_avi(str(out / os.listdir(out)[0]))
    assert len(frames) == 3 and frames[0].shape == (20, 28)
    assert "saved" in res.stdout
