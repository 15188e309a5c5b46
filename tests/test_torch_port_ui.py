"""The port's Gradio UI, WebUI script and the CLI's --serve / --ui.

gradio and the WebUI's ``modules`` are not installed: the UI is built on
tests/fake_gradio.py and the WebUI script runs under fake ``modules.*``,
as tests/test_gradio_ui.py and tests/test_webui_script.py do for the JAX
package.  Models are the small DPT-BEiT of tests/test_torch_port_model.py,
put in as the funnel's default predictor cache.  The --serve test starts
``python -m depthmap_tpu_torch --serve`` and asks it the routes that build
no model.
"""
from __future__ import annotations

import asyncio
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from depthmap_tpu_torch.frontends import gradio_ui, webui_script
from depthmap_tpu_torch.options import GenerationOptions
from depthmap_tpu_torch.pipeline import core as tcore
from depthmap_tpu_torch.pipeline.depth import DepthPredictor
from tests import fake_gradio
from tests.test_torch_port_funnel import REPO, _FixedCache
from tests.test_torch_port_model import torch_small_bundle


@pytest.fixture
def small_cache(monkeypatch):
    """The small BEiT on the CPU as the funnel's default cache."""
    pred = DepthPredictor(1, compute_dtype=torch.float32, device="cpu",
                          bundle=torch_small_bundle())
    cache = _FixedCache(pred)
    monkeypatch.setattr(tcore, "_default_cache", cache)
    return cache


def _recording_gradio(buttons):
    """fake_gradio whose Buttons are kept in ``buttons``."""
    mod = types.ModuleType("fake_gradio_rec")
    mod.__dict__.update({k: v for k, v in vars(fake_gradio).items()
                         if not k.startswith("__")})

    class Button(fake_gradio.Button):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            buttons.append(self)
    mod.Button = Button
    return mod


def test_blocks_graph_covers_every_option():
    demo = gradio_ui.build_ui(gr_module=fake_gradio)
    names = set(demo.depthmap_bundle.names)
    fields = set(GenerationOptions.field_names())
    fields.discard("do_output_depth_prediction")   # video mode's own flag
    assert fields - names == set()
    jax_ui = pytest.importorskip("depthmap_tpu.frontends.gradio_ui")
    assert demo.depthmap_bundle.names == \
        jax_ui.build_ui(gr_module=fake_gradio).depthmap_bundle.names


def test_visibility_and_net_size_rules():
    bundle = gradio_ui.build_ui(gr_module=fake_gradio).depthmap_bundle
    ev = [e for e in bundle["gen_stereo"].events if e["type"] == "change"]
    assert ev[0]["fn"](True)["visible"] is True
    assert ev[0]["fn"](False)["visible"] is False
    ev = [e for e in bundle["model_type"].events if e["type"] == "change"][0]
    w_upd, h_upd = ev["fn"](1)   # dpt_beit_large_512
    assert w_upd["value"] == 512 and h_upd["value"] == 512


def test_unload_button_empties_the_default_cache(small_cache):
    buttons = []
    gradio_ui.build_ui(gr_module=_recording_gradio(buttons))
    unload = [b for b in buttons if b.args == ("Unload models",)]
    assert len(unload) == 1
    small_cache._predictor = object()
    unload[0].events[0]["fn"]()
    assert small_cache._predictor is None


def test_run_generate_single_image(small_cache, rng, tmp_path):
    img = Image.fromarray((rng.random((48, 80, 3)) * 255).astype(np.uint8))
    named = {"depthmap_mode": "0", "depthmap_input_image": img,
             "custom_depthmap": False, "model_type": 1,
             "compute_device": "CPU", "net_width": 64, "net_height": 64,
             "save_outputs": True, "gen_normalmap": True,
             "gen_stereo": True}
    gallery, mesh_fi, _, html = gradio_ui.run_generate(
        named, outpath=str(tmp_path))
    assert "ERROR" not in html and mesh_fi is None
    # depth (as 8-bit), left-right, anaglyph, normal map
    assert len(gallery) == 4
    assert all(g.dtype == np.uint8 for g in gallery)
    saved = sorted(os.listdir(tmp_path))
    assert len(saved) == 4 and "depthmap-0000.png" in saved
    d16 = np.asarray(Image.open(tmp_path / "depthmap-0000.png"))
    assert d16.dtype == np.uint16
    np.testing.assert_array_equal(gallery[0], (d16 / 256).astype(np.uint8))


def test_run_generate_batch_dir_reuses_depthmaps(tmp_path, rng):
    """A depthmap already in the output directory is used: no model."""
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    outdir.mkdir()
    Image.fromarray((rng.random((48, 64, 3)) * 255).astype(np.uint8)).save(
        indir / "a.png")
    dm = (rng.random((48, 64)) * 65535).astype(np.uint16)
    Image.fromarray(dm).save(outdir / "a-0000.png")
    named = {"depthmap_mode": "2", "depthmap_batch_input_dir": str(indir),
             "depthmap_batch_output_dir": str(outdir),
             "depthmap_batch_reuse": True, "compute_device": "CPU",
             "save_outputs": False}
    gallery, _, _, html = gradio_ui.run_generate(named, outpath=str(outdir))
    assert len(gallery) == 1, html
    want = tcore._convert_to_i16_host(dm / 65536.0)
    np.testing.assert_array_equal(gallery[0], (want / 256).astype(np.uint8))


def test_run_generate_error_paths():
    run = gradio_ui.run_generate
    assert "select an input image" in run(
        {"depthmap_mode": "0", "depthmap_input_image": None})[3]
    assert "Custom depthmap" in run(
        {"depthmap_mode": "0", "depthmap_input_image": Image.new("RGB",
                                                                  (8, 8)),
         "custom_depthmap": True, "custom_depthmap_img": None})[3]
    assert "input directory" in run({"depthmap_mode": "2",
                                     "depthmap_batch_input_dir": ""})[3]
    assert "different directories" in run(
        {"depthmap_mode": "2", "depthmap_batch_input_dir": "/tmp/x",
         "depthmap_batch_output_dir": "/tmp/x"})[3]
    # no CUDA here: the default compute device raises, shown as an error
    if not torch.cuda.is_available():
        html = run({"depthmap_mode": "0", "model_type": 1,
                    "depthmap_input_image": Image.new("RGB", (8, 8))})[3]
        assert "ERROR" in html and "CUDA" in html
    path, _, html = gradio_ui.run_makevideo_ui(
        "", 2, 4, 0, "0,0,0", "0,0,0,0", False, "mp4", 1)
    assert path is None and "ERROR" in html


def test_launch_ui_builds_the_blocks(monkeypatch):
    monkeypatch.setattr(gradio_ui, "_gradio", fake_gradio)
    with pytest.raises(RuntimeError, match="fake gradio cannot serve"):
        gradio_ui.launch_ui()
    monkeypatch.setattr(gradio_ui, "_gradio", None)
    with pytest.raises(RuntimeError, match="gradio is not installed"):
        gradio_ui.build_ui()


# -- the CLI --------------------------------------------------------------------

def test_cli_ui_and_serve_start_their_frontends(monkeypatch):
    from depthmap_tpu_torch import cli
    from depthmap_tpu_torch.frontends import api
    calls = []
    monkeypatch.setattr(api, "serve", lambda **kw: calls.append(("serve",
                                                                  kw)))
    monkeypatch.setattr(gradio_ui, "launch_ui",
                        lambda **kw: calls.append(("ui", kw)))
    assert cli.run(["--serve", "--port", "7001"]) == 0
    assert cli.run(["--ui", "--listen", "0.0.0.0"]) == 0
    assert calls == [("serve", {"host": "127.0.0.1", "port": 7001}),
                     ("ui", {"host": "0.0.0.0", "port": 7860})]
    monkeypatch.undo()
    # the real launch_ui on fake gradio builds the whole Blocks graph
    monkeypatch.setattr(gradio_ui, "_gradio", fake_gradio)
    with pytest.raises(RuntimeError, match="fake gradio cannot serve"):
        cli.run(["--ui"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_serve_answers(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "depthmap_tpu_torch", "--serve", "--port",
         str(port)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}/depth"
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/version", timeout=5) as r:
                    body = json.loads(r.read())
                break
            except OSError:
                if time.time() > deadline or proc.poll() is not None:
                    raise
                time.sleep(0.3)
        from depthmap_tpu_torch.frontends.api import SCRIPT_VERSION
        assert body == {"version": SCRIPT_VERSION}
        with urllib.request.urlopen(url + "/get_options", timeout=5) as r:
            assert json.loads(r.read())["options"] == \
                sorted(GenerationOptions.field_names())
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(
                {"depth_input_images": []}).encode(), method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 422
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_python_m_runs_the_cli(tmp_path, rng):
    img, dm = tmp_path / "img.png", tmp_path / "dm.png"
    Image.fromarray((rng.random((16, 24, 3)) * 255).astype(np.uint8)).save(
        img)
    Image.fromarray((rng.random((16, 24)) * 255).astype(np.uint8)).save(dm)
    proc = subprocess.run(
        [sys.executable, "-m", "depthmap_tpu_torch", str(img), "--depthmap",
         str(dm), "--compute-device", "CPU", "-o", str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert os.listdir(tmp_path / "out") == ["img-0000-depth.png"]


# -- the WebUI script -------------------------------------------------------------

class _Opts:
    return_grid = False
    enable_pnginfo = True
    samples_format = "png"


def _fake_modules(saved):
    modules = types.ModuleType("modules")
    processing = types.ModuleType("modules.processing")
    shared = types.ModuleType("modules.shared")
    images_mod = types.ModuleType("modules.images")

    def process_images(p):
        return types.SimpleNamespace(
            images=list(p.images), all_prompts=["a prompt"] * len(p.images),
            all_seeds=[1234] * len(p.images),
            all_subseeds=[0] * len(p.images))

    processing.process_images = process_images
    processing.create_infotext = \
        lambda p, prompts, seeds, subs, extra, pos, i: \
        f"prompt={prompts[i]}, seed={seeds[i]}"
    shared.opts = _Opts()
    images_mod.save_image = lambda img, suffix="", info=None, **kw: \
        saved.append({"suffix": suffix, "info": info, "mode": img.mode})
    modules.processing, modules.shared, modules.images = \
        processing, shared, images_mod
    return modules


def test_script_ui_builds_the_panel():
    s = webui_script.DepthmapScriptLogic()
    comps = s.ui(is_img2img=False, gr_module=fake_gradio)
    assert len(comps) > 30
    assert "gen_inpainted_mesh" not in s._bundle.names
    assert "gen_stereo" in s._bundle.names


def test_script_run_saves_outputs_with_infotext(small_cache, rng):
    saved = []
    s = webui_script.DepthmapScriptLogic()
    s.ui(is_img2img=False, gr_module=fake_gradio)
    override = {"model_type": 1, "compute_device": "CPU", "net_width": 64,
                "net_height": 64, "gen_normalmap": True}
    values = [override.get(n, s._bundle[n].value) for n in s._bundle.names]
    p = types.SimpleNamespace(
        outpath_samples="unused", sampler="Euler", tiling=False,
        images=[Image.fromarray((rng.random((48, 64, 3)) * 255)
                                .astype(np.uint8))])
    processed = s.run(p, *values, modules_ns=_fake_modules(saved))
    assert len(processed.images) == 3
    assert [(d["suffix"], d["mode"]) for d in saved] == [("", "I;16"),
                                                         ("normalmap", "RGB")]
    assert all("seed=1234" in d["info"] for d in saved)


def test_settings_equal_jax_and_register(monkeypatch):
    """SETTINGS_DEFAULTS equal the JAX script's; on_ui_settings registers
    the same options (the reference's marigold_steps 10, not 12)."""
    jws = pytest.importorskip("depthmap_tpu.frontends.webui_script")
    assert webui_script.SETTINGS_DEFAULTS == jws.SETTINGS_DEFAULTS
    regs = {}
    for mod in (webui_script, jws):
        added = []
        shared = types.SimpleNamespace(
            opts=types.SimpleNamespace(
                add_option=lambda name, info, added=added:
                added.append((name, info))),
            OptionInfo=lambda default, desc, section=None:
            (default, desc))
        monkeypatch.setattr(mod, "WEBUI_AVAILABLE", True)
        monkeypatch.setattr(mod, "shared", shared)
        mod.on_ui_settings()
        regs[mod] = added
    assert regs[webui_script] == regs[jws]
    assert dict(regs[webui_script])["depthmap_script_marigold_steps"][0] == 10


def test_script_registers_the_port_routes(monkeypatch):
    """Imported inside a WebUI (fake modules.*), the script mounts the
    port's REST handlers on the WebUI's FastAPI app."""
    callbacks = {}
    fake = {
        "modules": types.ModuleType("modules"),
        "modules.images": types.ModuleType("modules.images"),
        "modules.script_callbacks": types.SimpleNamespace(
            on_app_started=lambda fn: callbacks.setdefault("app", fn),
            on_ui_settings=lambda fn: callbacks.setdefault("settings", fn)),
        "modules.shared": types.ModuleType("modules.shared"),
        "modules.scripts": types.SimpleNamespace(Script=object),
    }
    for name, mod in fake.items():
        monkeypatch.setitem(sys.modules, name, mod)
        if "." in name:
            setattr(fake["modules"], name.split(".")[1], mod)
    spec = importlib.util.spec_from_file_location(
        "webui_script_in_webui", webui_script.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.WEBUI_AVAILABLE and issubclass(mod.Script,
                                              mod.DepthmapScriptLogic)
    routes = {}

    class App:
        def get(self, path):
            return lambda fn: routes.setdefault(("GET", path), fn)

        def post(self, path):
            return lambda fn: routes.setdefault(("POST", path), fn)
    callbacks["app"](None, App())
    assert set(routes) == {("GET", "/depth/version"),
                           ("GET", "/depth/get_options"),
                           ("POST", "/depth/generate"),
                           ("POST", "/depth/generate/video")}
    from depthmap_tpu_torch.frontends.api import ApiError, SCRIPT_VERSION
    assert asyncio.run(routes[("GET", "/depth/version")]()) == \
        {"version": SCRIPT_VERSION}
    assert asyncio.run(routes[("GET", "/depth/get_options")]())["options"] \
        == sorted(GenerationOptions.field_names())
    with pytest.raises(ApiError):
        asyncio.run(routes[("POST", "/depth/generate")]({}))
    assert callbacks["settings"] is mod.on_ui_settings
