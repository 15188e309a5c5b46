"""AUTOMATIC1111 WebUI extension adapter of the port.

The JAX package's ``frontends/webui_script.py`` (the reference's
scripts/depthmap.py) on the port's funnel and REST handlers: when this
package is
dropped into a WebUI `extensions/` folder (or imported by one), `Script`
shows the full option panel in txt2img/img2img (reference :21-27), runs the
generation funnel over the images produced by the SD processing run with
those options, and embeds the generation parameters into saved PNGs via
create_infotext (reference :30-76).  `on_ui_settings` registers the
`depthmap_script_*` settings (reference :81-99).

The funnel's image outputs (numpy arrays) go to the WebUI as PIL images.
Outside the WebUI the module imports cleanly (`WEBUI_AVAILABLE` is False)
and the `DepthmapScriptLogic` mixin stays directly testable with fake
`modules.*` (tests/test_torch_port_ui.py).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

try:
    from modules import images as webui_images          # type: ignore
    from modules import script_callbacks, shared        # type: ignore
    from modules import scripts as webui_scripts        # type: ignore
    WEBUI_AVAILABLE = True
except Exception:
    webui_images = script_callbacks = shared = webui_scripts = None
    WEBUI_AVAILABLE = False

SETTINGS_DEFAULTS = {
    # reference scripts/depthmap.py:81-99 + src/backbone.py:127-137
    "depthmap_script_keepmodels": True,
    "depthmap_script_boost_rmax": 1600,
    "depthmap_script_marigold_ensembles": 5,
    "depthmap_script_marigold_steps": 12,
    "depthmap_script_save_ply": False,
    "depthmap_script_show_3d": True,
    "depthmap_script_show_3d_inpaint": True,
    "depthmap_script_mesh_maxsize": 2048,
    "depthmap_script_gen_heatmap_from_ui": False,
    "depthmap_script_extra_stereomodes": False,
}


def get_opt(name: str, default=None):
    if WEBUI_AVAILABLE and hasattr(shared.opts, name):
        return getattr(shared.opts, name)
    return SETTINGS_DEFAULTS.get(name, default)


class DepthmapScriptLogic:
    """The WebUI Script behavior, independent of the WebUI base class so it
    can run under fake `modules.*` in CI."""

    _bundle = None

    def title(self):
        return "DepthMap (PyTorch)"

    def show(self, is_img2img):
        return True

    def ui(self, is_img2img, gr_module=None):
        """Full option panel (reference scripts/depthmap.py:21-27 wires
        common_ui.main_ui_panel(False)); returns the flat component list the
        WebUI passes back to run()."""
        from depthmap_tpu_torch.frontends.gradio_ui import (UIBundle,
                                                            main_ui_panel)
        if gr_module is None:
            import gradio as gr_module  # WebUI always ships gradio
        gr = gr_module
        gr.HTML()   # reference workaround for a Gradio layout bug
        with gr.Column(variant="panel"):
            gr.HTML()
            bundle = UIBundle(gr)
            main_ui_panel(gr, bundle, is_depth_tab=False)
        self._bundle = bundle
        return bundle.inputs()

    def _rekey(self, args) -> Dict[str, Any]:
        if self._bundle is None or len(args) != len(self._bundle.names):
            # defaults (a WebUI reload can desync ui/run; fail safe)
            return {}
        return self._bundle.rekey(args)

    def run(self, p, *args, modules_ns=None):
        """SD processing -> funnel with the panel's options -> save with
        PNG infotext (reference scripts/depthmap.py:30-76)."""
        if modules_ns is None:
            import modules as modules_ns  # type: ignore
        from PIL import Image

        from depthmap_tpu_torch.frontends.api import is_image_output
        from depthmap_tpu_torch.pipeline.core import core_generation_funnel

        processing = modules_ns.processing
        shared_ = modules_ns.shared
        images_ = modules_ns.images

        named = self._rekey(args)
        processed = processing.process_images(p)
        processed.sampler = getattr(p, "sampler", None)
        processed.tiling = getattr(p, "tiling", None)

        inputimages = []
        for count in range(len(processed.images)):
            # skip the leading grid image
            if count == 0 and len(processed.images) > 1 and \
                    getattr(shared_.opts, "return_grid", False):
                continue
            inputimages.append(processed.images[count])

        # cmd_opts.no_half is WebUI's global precision flag
        # (reference backbone.gather_ops falls back to cmd opts, :39-44)
        no_half = bool(getattr(getattr(shared, "cmd_opts", None),
                               "no_half", False)) if WEBUI_AVAILABLE \
            else False
        ops = {"keepmodels": get_opt("depthmap_script_keepmodels", True),
               "no_half": no_half,
               "boost_rmax": get_opt("depthmap_script_boost_rmax", 1600),
               "marigold_ensembles": get_opt(
                   "depthmap_script_marigold_ensembles", 5),
               "marigold_steps": get_opt("depthmap_script_marigold_steps",
                                         12)}
        gen_obj = core_generation_funnel(p.outpath_samples, inputimages,
                                         None, None, named, ops)

        for input_i, otype, result in gen_obj:
            if not is_image_output(result):
                continue
            result = Image.fromarray(result)
            # embed generation parameters (PNG infotext)
            info = None
            if hasattr(processed, "all_prompts") and \
                    getattr(shared_.opts, "enable_pnginfo", False):
                info = processing.create_infotext(
                    p, processed.all_prompts, processed.all_seeds,
                    processed.all_subseeds, "", 0, input_i)
            processed.images.append(result)
            if named.get("save_outputs", True):
                try:
                    # reference quirk kept: suffix has no separator
                    # (scripts/depthmap.py:65 `f"{type}"`)
                    suffix = "" if otype == "depth" else f"{otype}"
                    images_.save_image(
                        result, path=p.outpath_samples, basename="",
                        seed=processed.all_seeds[input_i],
                        prompt=processed.all_prompts[input_i],
                        extension=getattr(shared_.opts, "samples_format",
                                          "png"),
                        info=info, p=processed, suffix=suffix)
                except Exception as e:
                    if not ("image has wrong mode" in str(e)
                            or "I;16" in str(e)):
                        raise
        return processed


def on_ui_settings():
    """Register depthmap_script_* options (reference :81-99)."""
    if not WEBUI_AVAILABLE:
        return
    section = ("depthmap-script", "Depthmap extension (PyTorch)")

    def add_option(name, default_value, description):
        shared.opts.add_option(
            f"depthmap_script_{name}",
            shared.OptionInfo(default_value, description, section=section))

    add_option("keepmodels", False, "Do not unload depth/pix2pix models.")
    add_option("boost_rmax", 1600, "Maximum wholesize for boost (Rmax)")
    add_option("marigold_ensembles", 5, "Marigold ensemble size")
    # reference quirk kept: the settings panel registers 10
    # (scripts/depthmap.py:91) while the standalone default is 12
    # (src/backbone.py:137)
    add_option("marigold_steps", 10, "Marigold denoising steps")
    add_option("save_ply", False, "Save additional PLY 3D inpainted mesh.")
    add_option("show_3d", True, "Show 3D Meshes in output tab.")
    add_option("show_3d_inpaint", True, "Also show 3D Inpainted Mesh.")
    add_option("mesh_maxsize", 2048, "Max size for generating simple mesh.")
    add_option("gen_heatmap_from_ui", False, "Show HeatMap option in UI")
    add_option("extra_stereomodes", False, "Extra stereoimage modes")


if WEBUI_AVAILABLE:
    class Script(DepthmapScriptLogic,
                 webui_scripts.Script):  # pragma: no cover (needs WebUI)
        pass

    def _register_api(_demo, app):  # FastAPI app provided by WebUI
        # mount the port's handlers onto the WebUI FastAPI app
        from depthmap_tpu_torch.frontends import api as port_api

        @app.get("/depth/version")
        async def version():
            return {"version": port_api.SCRIPT_VERSION}

        @app.get("/depth/get_options")
        async def get_options():
            from depthmap_tpu_torch.options import GenerationOptions
            return {"options": sorted(GenerationOptions.field_names())}

        @app.post("/depth/generate")
        async def generate(payload: dict):
            return port_api.handle_generate(payload)

        @app.post("/depth/generate/video")
        async def generate_video(payload: dict):
            return port_api.handle_generate_video(payload)

    try:
        script_callbacks.on_app_started(_register_api)
        script_callbacks.on_ui_settings(on_ui_settings)
    except Exception:
        pass
