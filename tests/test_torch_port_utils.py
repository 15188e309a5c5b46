"""The port's utils/ against the JAX package's: the download tables, pins
and routes (every fetch stubbed: no test touches the network), the
metrics at 1e-6 on seeded maps, and the profiling spans.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from depthmap_tpu.utils import download as JD
from depthmap_tpu.utils import metrics as JM
from depthmap_tpu_torch.utils import download as D
from depthmap_tpu_torch.utils import metrics as M
from depthmap_tpu_torch.utils import profiling as P


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Any fetch that is not stubbed fails the test."""
    def refuse(*a, **kw):
        raise AssertionError("a test tried to open a URL")
    monkeypatch.setattr(urllib.request, "urlopen", refuse)


class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _serve(monkeypatch, payloads):
    """urlopen stub: each URL's bytes from ``payloads`` (an exception
    instance is raised); the URLs asked are returned in order."""
    asked = []

    def urlopen(u, timeout=60):
        asked.append(u)
        got = payloads(u) if callable(payloads) else payloads[u]
        if isinstance(got, Exception):
            raise got
        return _Resp(got)
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return asked


# -- download ---------------------------------------------------------------

def test_tables_equal_jax():
    assert D.CHECKPOINT_URLS == JD.CHECKPOINT_URLS
    assert D.PIX2PIX_URL == JD.PIX2PIX_URL
    assert D.MARIGOLD_URLS == JD.MARIGOLD_URLS
    assert D.INPAINT_URLS == JD.INPAINT_URLS
    assert D.PIN_FILENAME == JD.PIN_FILENAME


def test_every_checkpoint_file_has_urls():
    from depthmap_tpu_torch.models.weights import CHECKPOINT_FILES
    for mt, fn in CHECKPOINT_FILES.items():
        assert D.CHECKPOINT_URLS[mt][0] == fn


def test_sha256_prefix(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"hello world")
    full = hashlib.sha256(b"hello world").hexdigest()
    assert D.sha256_prefix_ok(str(p), full[:16])
    assert not D.sha256_prefix_ok(str(p), "deadbeef")
    assert D.sha256_prefix_ok(str(p), None)


def test_existing_file_is_used_and_pinned(tmp_path):
    p = tmp_path / "w.bin"
    p.write_bytes(b"x" * 10)
    assert D.ensure_file_downloaded(str(p), ["http://mirror.test/x"]) == \
        str(p)
    pins = json.load(open(tmp_path / D.PIN_FILENAME))
    assert pins["w.bin"] == hashlib.sha256(b"x" * 10).hexdigest()


def test_mirrors_in_order_and_all_failing(tmp_path, monkeypatch):
    asked = _serve(monkeypatch, lambda u: OSError("down"))
    with pytest.raises(RuntimeError, match="any mirror"):
        D.ensure_file_downloaded(str(tmp_path / "nope.bin"),
                                 ["http://a.test/1", "http://b.test/2"])
    assert asked == ["http://a.test/1", "http://b.test/2"]
    assert os.listdir(tmp_path) == []


def test_hash_mismatch_goes_to_the_next_mirror(tmp_path, monkeypatch):
    good = b"the right bytes"
    sha = hashlib.sha256(good).hexdigest()
    asked = _serve(monkeypatch, {"http://a.test/1": b"wrong",
                                 "http://b.test/2": good})
    out = D.ensure_file_downloaded(str(tmp_path / "m.pt"),
                                   ["http://a.test/1", "http://b.test/2"],
                                   sha[:8])
    assert open(out, "rb").read() == good and len(asked) == 2


def test_tofu_pin_recorded_and_verified(tmp_path, monkeypatch):
    _serve(monkeypatch, lambda u: b"checkpoint-bytes-v1")
    target = tmp_path / "model.pt"
    D.ensure_file_downloaded(str(target), ["http://mirror.test/a"])
    pins = json.load(open(tmp_path / D.PIN_FILENAME))
    assert pins["model.pt"] == hashlib.sha256(b"checkpoint-bytes-v1") \
        .hexdigest()
    target.write_bytes(b"evil")
    _serve(monkeypatch, lambda u: b"also-evil")
    with pytest.raises(RuntimeError, match="pinned sha256"):
        D.ensure_file_downloaded(str(target), ["http://mirror.test/a"])


def test_ensure_functions_fetch_into_the_weights_dir(tmp_path, monkeypatch):
    asked = _serve(monkeypatch, lambda u: u.encode())
    assert D.ensure_model_downloaded(12, str(tmp_path)) == \
        str(tmp_path / "depth_anything_v2_vits.pth")
    root = D.ensure_model_downloaded(10, str(tmp_path))
    assert root == str(tmp_path / "marigold")
    for rel in D.MARIGOLD_URLS:
        assert (tmp_path / "marigold" / rel).is_file()
    assert len(asked) == 1 + len(D.MARIGOLD_URLS)
    with pytest.raises(RuntimeError, match="any mirror"):
        # the pix2pix file carries a full sha256 that these bytes miss
        D.ensure_pix2pix_downloaded(str(tmp_path))


def test_predictor_fetches_a_missing_checkpoint(tmp_path, monkeypatch):
    """DEPTHMAP_ALLOW_DOWNLOAD=1: a missing checkpoint is fetched into the
    weights dir and loaded strictly; without the switch nothing is
    fetched and the weights are random."""
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    from tests.test_torch_port_model import torch_small_bundle
    src = torch_small_bundle().module
    for p in src.parameters():
        p.data.normal_(generator=torch.Generator().manual_seed(3))
    calls = []

    def fetch(model_type, weights_dir):
        calls.append((model_type, weights_dir))
        path = os.path.join(weights_dir, "dpt_beit_large_512.pt")
        torch.save(src.state_dict(), path)
        return path
    monkeypatch.setattr(D, "ensure_model_downloaded", fetch)
    kw = dict(weights_dir=str(tmp_path), device="cpu",
              compute_dtype=torch.float32)
    pred = DepthPredictor(1, bundle=torch_small_bundle(), **kw)
    assert calls == []
    monkeypatch.setenv("DEPTHMAP_ALLOW_DOWNLOAD", "1")
    pred = DepthPredictor(1, bundle=torch_small_bundle(), **kw)
    assert calls == [(1, str(tmp_path))]
    for a, b in zip(pred.bundle.module.state_dict().values(),
                    src.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_marigold_and_pix2pix_routes(tmp_path, monkeypatch, capsys):
    """A failed Marigold fetch prints and goes on; pix2pix's prints and
    then asks for the weights (or runs random under its switch), as in
    the JAX package."""
    from depthmap_tpu_torch.pipeline import core, depth
    calls = []

    def fail(weights_dir):
        calls.append(weights_dir)
        raise RuntimeError("no mirror")
    monkeypatch.setattr(D, "ensure_marigold_downloaded", fail)
    monkeypatch.setattr(D, "ensure_pix2pix_downloaded", fail)
    depth._fetch_marigold(str(tmp_path))
    assert "Marigold download failed" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="pix2pix"):
        core._load_pix2pix(str(tmp_path))
    assert calls == [str(tmp_path)]      # no switch: no fetch
    monkeypatch.setenv("DEPTHMAP_ALLOW_DOWNLOAD", "1")
    with pytest.raises(FileNotFoundError, match="DEPTHMAP_ALLOW_DOWNLOAD"):
        core._load_pix2pix(str(tmp_path))
    assert "pix2pix download failed" in capsys.readouterr().out
    monkeypatch.setenv("DEPTHMAP_ALLOW_RANDOM_PIX2PIX", "1")
    assert core._load_pix2pix(str(tmp_path)) is None
    assert calls == [str(tmp_path)] * 3


# -- metrics ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_errors_matches_jax(seed):
    rng = np.random.default_rng(seed)
    gt = (rng.random(4000) * 9 + 0.1).astype(np.float32)
    pred = (gt * np.exp(rng.normal(0, 0.2, gt.shape))).astype(np.float32)
    want = JM.compute_errors(gt, pred)
    got = M.compute_errors(torch.from_numpy(gt), torch.from_numpy(pred))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("crop", [None, "garg", "eigen"])
def test_compute_metrics_matches_jax(rng, crop):
    gt = (rng.random((60, 80)) * 12).astype(np.float32)
    pred = gt * (1 + 0.1 * rng.normal(size=gt.shape)).astype(np.float32)
    pred[0, :5] = np.nan
    pred[1, :5] = np.inf
    want = JM.compute_metrics(gt, pred.copy(), crop=crop)
    got = M.compute_metrics(gt, pred.copy(), crop=crop)
    np.testing.assert_array_equal(M.eval_crop_mask(gt.shape, crop),
                                  JM.eval_crop_mask(gt.shape, crop))
    assert set(got) == set(want) and len(got) == 9
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert M.compute_metrics(np.zeros((4, 4)), np.ones((4, 4))) == {}


# -- profiling --------------------------------------------------------------

def test_stage_times_and_reports():
    P.reset()
    with P.stage("a"):
        pass
    with P.stage("a"):
        pass
    P.enable(False)
    with P.stage("b"):
        pass
    P.enable(True)
    assert list(P.timings()) == ["a"] and len(P.timings()["a"]) == 2
    assert P.report().splitlines()[1].startswith("a ")
    P.reset()
    assert P.timings() == {}


def test_stage_opens_a_profiler_span():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.stage("my_span"):
            torch.ones(4).sum()
    assert "my_span" in {e.key for e in prof.key_averages()}


def test_funnel_spans_equal_jax(rng):
    """The funnel's spans: a depth_batch per predicted image of two
    shapes where the JAX funnel has a depth_predict, and a stereo per
    image, as many as the JAX funnel's."""
    from depthmap_tpu.options import GenerationOptions as JOptions
    from depthmap_tpu.pipeline import core as jcore
    from depthmap_tpu.utils import profiling as JP
    from depthmap_tpu_torch.options import GenerationOptions as TOptions
    from depthmap_tpu_torch.pipeline import core as tcore
    from tests.test_torch_port_api import _JCache
    from tests.test_torch_port_funnel import (_FixedCache, _images,
                                              _predictors, _run)
    jp, tp = _predictors()
    imgs = _images(rng, [(40, 40), (48, 80)])
    base = dict(compute_device="CPU", model_type=1, net_width=64,
                net_height=64, gen_stereo=True)
    JP.reset()
    P.reset()
    _run(jcore.core_generation_funnel, imgs, None, JOptions(**base),
         _JCache(jp))
    _run(tcore.core_generation_funnel, imgs, None, TOptions(**base),
         _FixedCache(tp))
    counts = {k: len(v) for k, v in P.timings().items()}
    want = {k: len(v) for k, v in JP.timings().items()}
    assert want == {"depth_predict": 2, "stereo": 2}
    assert (counts.get("depth_batch"), counts.get("stereo")) == \
        (want["depth_predict"], want["stereo"])
    assert "depth_predict" not in counts


def test_stage_enters_no_range_without_a_profiler(monkeypatch):
    """Outside a profiler a span opens no record_function range; inside
    one it does."""
    def refuse(name):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(P, "record_function", refuse)
    P.reset()
    with P.stage("quiet"):
        pass
    assert [s.name for s in P.spans()] == ["quiet"]
    opened = []
    monkeypatch.setattr(P, "record_function", lambda name: opened.append(
        name) or contextlib.nullcontext())
    monkeypatch.setattr(P, "_profiler_enabled", lambda: True)
    with P.stage("ranged"):
        pass
    assert opened == ["ranged"]


def test_span_records_nest_and_report_self_time():
    P.reset()
    call = P.new_call()
    assert P.new_call() != call
    with P.stage("outer", call):
        with P.stage("inner"):
            time.sleep(0.002)
        with P.stage("inner"):
            pass
    with P.stage("loose"):
        pass
    outer, inner1, inner2, loose = P.spans()
    assert [s.name for s in (outer, inner1, inner2, loose)] == \
        ["outer", "inner", "inner", "loose"]
    assert inner1.parent == inner2.parent == outer.id
    assert outer.parent == loose.parent == -1
    assert outer.call == inner1.call == inner2.call == call
    assert loose.call == -1
    assert outer.start_ns <= inner1.start_ns < inner1.end_ns <= \
        inner2.start_ns < inner2.end_ns <= outer.end_ns
    t = P.timings()
    assert t["outer"][0] == pytest.approx(
        (outer.end_ns - outer.start_ns) / 1e9)
    rows = {line.split()[0]: line.split() for line in
            P.report().splitlines()[1:]}
    assert rows["outer"][1] == "1" and rows["inner"][1] == "2"
    self_outer = float(rows["outer"][4])
    want = t["outer"][0] - sum(t["inner"])
    assert self_outer == pytest.approx(want, abs=1.5e-3)
    assert float(rows["inner"][4]) == pytest.approx(sum(t["inner"]),
                                                    abs=1.5e-3)
    assert self_outer < float(rows["outer"][2])


def test_span_records_stay_bounded():
    """The record list keeps the newest MAX_RECORDS spans and counts what
    it drops; reset() clears both (and the timings)."""
    P.reset()
    extra = 5
    for _ in range(P.MAX_RECORDS + extra):
        with P.stage("many"):
            pass
    kept = P.spans()
    assert len(kept) == P.MAX_RECORDS and P.dropped() == extra
    assert len(P.timings()["many"]) == P.MAX_RECORDS + extra
    assert kept[-1].id - kept[0].id == P.MAX_RECORDS - 1
    P.reset()
    assert P.spans() == [] and P.dropped() == 0 and P.timings() == {}


def test_spans_from_many_threads_lose_nothing():
    """Threads record into one list and one timing table: none of their
    spans is lost, and each thread's spans nest only in its own."""
    P.reset()
    threads, per = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for _ in range(per):
            with P.stage(f"outer{k}"):
                with P.stage(f"inner{k}"):
                    pass
    try:
        pool = [threading.Thread(target=work, args=(k,))
                for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    records = P.spans()
    assert len(records) == 2 * threads * per and P.dropped() == 0
    assert sum(len(v) for v in P.timings().values()) == 2 * threads * per
    by_id = {s.id: s for s in records}
    for s in records:
        if s.name.startswith("inner"):
            assert by_id[s.parent].name == "outer" + s.name[5:]
        else:
            assert s.parent == -1


# what each span of a funnel call holds: a chunk holds the predictor's
# four spans, the upload of uint8 photos its upload_u8, a predicted
# photo's stereo its stereo_on_card
FUNNEL_SPANS = {"depth_batch": ["upload", "forward", "finalize", "download"],
                "upload": ["upload_u8"],
                "stereo": ["stereo_on_card"]}
# a photo's stereo_on_card, in photo order: its own photo's upload and
# eyes unless they were queued ahead, the next photo's where it is in a
# chunk already made, then the wait for its own results
EYES = ["stereo_upload", "stereo_eye", "stereo_eye"]
ON_CARD = [EYES + EYES + ["stereo_download"], ["stereo_download"],
           EYES + ["stereo_download"], EYES + ["stereo_download"]]


def _funnel_spans(monkeypatch, rng):
    """Two funnel calls on three same-shape photos (chunks of 2 and 1)
    and one odd-shaped photo (a chunk of 1), with stereo: each call's span
    records."""
    from depthmap_tpu_torch.options import GenerationOptions as TOptions
    from depthmap_tpu_torch.pipeline import core as tcore
    from tests.test_torch_port_funnel import (_FixedCache, _images,
                                              _predictors, _run)
    monkeypatch.setattr(tcore, "FUNNEL_CHUNK", 2)
    _, tp = _predictors()
    imgs = _images(rng, [(48, 80), (48, 80), (48, 80), (40, 40)])
    inp = TOptions(compute_device="CPU", model_type=1, net_width=64,
                   net_height=64, gen_stereo=True)
    calls = []
    for _ in range(2):
        P.reset()
        out = _run(tcore.core_generation_funnel, imgs, None, inp,
                   _FixedCache(tp))
        assert len(out["depth"]) == 4
        calls.append(P.spans())
    return calls


def test_funnel_span_tree(monkeypatch, rng):
    """Per chunk, when the loop reaches its first photo, a prepare and a
    depth_batch over upload (over its upload_u8: the photos are uint8),
    forward, finalize and download; per photo a stereo over its
    stereo_on_card (ON_CARD: photo 1's upload and eyes queued inside
    photo 0's); each child inside its parent; one call identifier a
    funnel call."""
    calls = _funnel_spans(monkeypatch, rng)
    for records in calls:
        by_id = {s.id: s for s in records}
        top = [s.name for s in records if s.parent == -1]
        assert top == ["prepare", "depth_batch",   # photos 0 and 1
                       "stereo", "stereo",
                       "prepare", "depth_batch",   # photo 2
                       "stereo",
                       "prepare", "depth_batch",   # the odd shape
                       "stereo"]
        on_card = iter(ON_CARD)
        for s in records:
            children = [c.name for c in records if c.parent == s.id]
            want = next(on_card) if s.name == "stereo_on_card" else \
                FUNNEL_SPANS.get(s.name, [])
            assert children == want, s.name
            if s.parent != -1:
                p = by_id[s.parent]
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert len({s.call for s in records}) == 1
    assert calls[0][0].call != calls[1][0].call


def test_funnel_spans_are_profiler_annotations(monkeypatch, rng, tmp_path):
    """Under torch.profiler every span of the funnel is a user_annotation
    of the trace, the category the benchmark reads."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _funnel_spans(monkeypatch, rng)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    seen = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    want = {"prepare"} | set(FUNNEL_SPANS) | {
        n for names in FUNNEL_SPANS.values() for n in names} | set(EYES) | \
        {"stereo_download"}
    assert len(want) == 12 and want <= seen, want - seen
