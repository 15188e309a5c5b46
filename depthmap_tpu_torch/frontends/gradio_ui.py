"""Gradio web UI of the port: the JAX package's ``frontends/gradio_ui.py``
(the reference's src/common_ui.py: main_ui_panel :27-223, on_ui_tabs
:276-431, run_generate :454-595) on the port's funnel.

Layout: input tabs Single Image (+custom depthmap) / Batch Process / Batch
from Directory / Single Video; the full option panel with the reference's
declarative visible-if rules; output tabs Depth Output / 3D Mesh / Generate
video (trajectory video from an inpainted mesh).

Arg transport is the by-design replacement for GradioComponentBundle
(gradio_args_transport.py): a ``UIBundle`` records named components in
order, the submit callback re-keys the flat gradio args by that order and
feeds them to ``GenerationOptions.from_dict`` (silent-discard ingest).

The funnel yields numpy arrays: ``run_generate`` saves each image output
as the PNG PIL writes of it and shows it in the gallery (a uint16 map as
8-bit, divided by 256).  gradio is an optional dependency;
``build_ui(gr_module=...)`` accepts an injected module, so the Blocks graph
can be built and driven without gradio (tests/test_torch_port_ui.py runs it
on tests/fake_gradio.py).

    python -m depthmap_tpu_torch --ui --port 7860
"""
from __future__ import annotations

import os
import tempfile
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
from PIL import Image

from depthmap_tpu_torch.frontends.api import is_image_output
from depthmap_tpu_torch.registry import MODELS, get_default_net_size

try:
    import gradio as _gradio
    HAVE_GRADIO = True
except Exception:
    _gradio = None
    HAVE_GRADIO = False


MODEL_CHOICES = [spec.ui_name for spec in MODELS.values()]
STEREO_MODE_CHOICES = ["left-right", "right-left", "top-bottom",
                       "bottom-top", "red-cyan-anaglyph", "left-only",
                       "only-right", "cyan-red-reverseanaglyph"]
REMBG_MODELS = ["u2net", "u2netp", "u2net_human_seg", "silueta",
                "isnet-general-use", "isnet-anime"]


class UIBundle:
    """Ordered, named component registry + declarative visibility rules
    (replaces the reference's enkey-HTML transport)."""

    def __init__(self, gr):
        self.gr = gr
        self.names: List[str] = []
        self.comps: Dict[str, Any] = {}

    def add(self, name: str, comp):
        assert name not in self.comps, name
        self.names.append(name)
        self.comps[name] = comp
        return comp

    def __getitem__(self, name):
        return self.comps[name]

    def inputs(self):
        return [self.comps[n] for n in self.names]

    def rekey(self, values) -> Dict[str, Any]:
        return dict(zip(self.names, values))

    def rule(self, target, kind: str, source_name: str):
        """'visible-if' / 'visible-if-not' (reference
        gradio_args_transport.py:71)."""
        gr = self.gr
        src = self.comps[source_name]
        invert = kind == "visible-if-not"

        def toggle(v):
            return gr.update(visible=(not v) if invert else bool(v))

        src.change(fn=toggle, inputs=[src], outputs=[target])


def main_ui_panel(gr, inp: UIBundle, is_depth_tab: bool = True):
    """All generation options + visibility rules (common_ui.py:27-223)."""
    Box = getattr(gr, "Box", None) or gr.Group
    with gr.Row():
        inp.add("compute_device", gr.Radio(
            label="Compute on", choices=["GPU", "CPU"], value="GPU"))
        inp.add("model_type", gr.Dropdown(
            label="Model", choices=MODEL_CHOICES,
            value="Depth Anything v2 Base", type="index"))
    with Box():
        with gr.Row():
            inp.add("boost", gr.Checkbox(
                label="BOOST", value=False,
                info="Generate depth map parts in a mosaic fashion - "
                     "very slow"))
            inp.add("net_size_match", gr.Checkbox(
                label="Match net size to input size", value=False,
                info="Net size affects quality, performance and memory use"))
        with gr.Row() as options_depend_on_match_size:
            inp.add("net_width", gr.Slider(minimum=64, maximum=2048, step=64,
                                           value=448, label="Net width"))
            inp.add("net_height", gr.Slider(minimum=64, maximum=2048,
                                            step=64, value=448,
                                            label="Net height"))
        with gr.Row():
            inp.add("tiling_mode", gr.Checkbox(
                label="Tiling mode", value=False,
                info="Reduces seams that appear if the depthmap is tiled "
                     "into a grid"))
    with Box():
        with gr.Row():
            inp.add("save_outputs", gr.Checkbox(label="Save Outputs",
                                                value=True))
            inp.add("do_output_depth", gr.Checkbox(label="Output DepthMap",
                                                   value=True))
            inp.add("output_depth_invert", gr.Checkbox(
                label="Invert (black=near, white=far)", value=False))
        with gr.Row() as options_depend_on_output_depth_1:
            inp.add("output_depth_combine", gr.Checkbox(
                label="Combine input and depthmap into one image",
                value=False))
            inp.add("output_depth_combine_axis", gr.Radio(
                label="Combine axis", choices=["Vertical", "Horizontal"],
                value="Horizontal", type="value", visible=False))
    with Box():
        with gr.Row():
            inp.add("clipdepth", gr.Checkbox(
                label="Clip and renormalize DepthMap", value=False))
            inp.add("clipdepth_mode", gr.Dropdown(
                label="Mode", choices=["Range", "Outliers"], value="Range",
                type="value", visible=False))
        with gr.Row(visible=False) as clip_options_row_1:
            inp.add("clipdepth_far", gr.Slider(minimum=0, maximum=1,
                                               step=0.001, value=0.0,
                                               label="Far clip"))
            inp.add("clipdepth_near", gr.Slider(minimum=0, maximum=1,
                                                step=0.001, value=1.0,
                                                label="Near clip"))

    with Box():
        with gr.Row():
            inp.add("gen_stereo", gr.Checkbox(
                label="Generate stereoscopic (3D) image(s)", value=False))
        with gr.Column(visible=False) as stereo_options:
            with gr.Row():
                inp.add("stereo_modes", gr.CheckboxGroup(
                    STEREO_MODE_CHOICES, label="Output",
                    value=["left-right", "red-cyan-anaglyph"]))
            with gr.Row():
                inp.add("stereo_divergence", gr.Slider(
                    minimum=0.05, maximum=15.005, step=0.01, value=2.5,
                    label="Divergence (3D effect)"))
                inp.add("stereo_separation", gr.Slider(
                    minimum=-5.0, maximum=5.0, step=0.01, value=0.0,
                    label="Separation (moves images apart)"))
            with gr.Row():
                inp.add("stereo_fill_algo", gr.Dropdown(
                    label="Gap fill technique", type="value",
                    choices=["none", "naive", "naive_interpolating",
                             "polylines_soft", "polylines_sharp"],
                    value="polylines_sharp"))
                inp.add("stereo_offset_exponent", gr.Slider(
                    label="Magic exponent", minimum=1, maximum=2, step=1,
                    value=1.0))
                inp.add("stereo_balance", gr.Slider(
                    minimum=-1.0, maximum=1.0, step=0.05, value=0.0,
                    label="Balance between eyes"))

    with Box():
        with gr.Row():
            inp.add("gen_normalmap", gr.Checkbox(label="Generate NormalMap",
                                                 value=False))
        with gr.Column(visible=False) as normalmap_options:
            with gr.Row():
                inp.add("normalmap_pre_blur", gr.Checkbox(
                    label="Smooth before calculating normals", value=False))
                pre_k = inp.add("normalmap_pre_blur_kernel", gr.Slider(
                    minimum=1, maximum=31, step=2, value=3,
                    label="Pre-smooth kernel size", visible=False))
                inp.rule(pre_k, "visible-if", "normalmap_pre_blur")
            with gr.Row():
                inp.add("normalmap_sobel", gr.Checkbox(
                    label="Sobel gradient", value=True))
                sob_k = inp.add("normalmap_sobel_kernel", gr.Slider(
                    minimum=1, maximum=31, step=2, value=3,
                    label="Sobel kernel size"))
                inp.rule(sob_k, "visible-if", "normalmap_sobel")
            with gr.Row():
                inp.add("normalmap_post_blur", gr.Checkbox(
                    label="Smooth after calculating normals", value=False))
                post_k = inp.add("normalmap_post_blur_kernel", gr.Slider(
                    minimum=1, maximum=31, step=2, value=3,
                    label="Post-smooth kernel size", visible=False))
                inp.rule(post_k, "visible-if", "normalmap_post_blur")
            with gr.Row():
                inp.add("normalmap_invert", gr.Checkbox(label="Invert",
                                                        value=False))

    with Box():
        with gr.Row():
            inp.add("gen_heatmap", gr.Checkbox(label="Generate HeatMap",
                                               value=False))

    with Box():
        with gr.Column():
            inp.add("gen_simple_mesh", gr.Checkbox(
                label="Generate simple 3D mesh", value=False))
        with gr.Column(visible=False) as mesh_options:
            gr.HTML(value="Generates fast, accurate only with ZoeDepth "
                          "models and no boost, no custom maps.")
            with gr.Row():
                inp.add("simple_mesh_occlude", gr.Checkbox(
                    label="Remove occluded edges", value=True))
                inp.add("simple_mesh_spherical", gr.Checkbox(
                    label="Equirectangular projection", value=False))

    if is_depth_tab:
        with Box():
            with gr.Column():
                inp.add("gen_inpainted_mesh", gr.Checkbox(
                    label="Generate 3D inpainted mesh", value=False))
            with gr.Column(visible=False) as inpaint_options_row_0:
                gr.HTML("Generation is sloooow. Required for generating "
                        "videos from mesh.")
                inp.add("gen_inpainted_mesh_demos", gr.Checkbox(
                    label="Generate 4 demo videos with 3D inpainted mesh.",
                    value=False))
                gr.HTML("More options for generating video can be found in "
                        "the Generate video tab.")

    with Box():
        with gr.Row():
            inp.add("gen_rembg", gr.Checkbox(label="Remove background",
                                             value=False))
        with gr.Column(visible=False) as bgrem_options:
            with gr.Row():
                inp.add("save_background_removal_masks", gr.Checkbox(
                    label="Save the foreground masks", value=False))
                inp.add("pre_depth_background_removal", gr.Checkbox(
                    label="Pre-depth background removal", value=False))
            with gr.Row():
                inp.add("rembg_model", gr.Dropdown(
                    label="Rembg Model", type="value", choices=REMBG_MODELS,
                    value="u2net"))

    # -- dynamic rules (common_ui.py:176-223) -----------------------------
    def update_default_net_size(model_idx):
        w, h = get_default_net_size(int(model_idx)
                                    if model_idx is not None else 13)
        return gr.update(value=w), gr.update(value=h)

    inp["model_type"].change(fn=update_default_net_size,
                             inputs=[inp["model_type"]],
                             outputs=[inp["net_width"], inp["net_height"]])

    inp["boost"].change(
        fn=lambda a, b: (gr.update(visible=not a),
                         gr.update(visible=not a and not b)),
        inputs=[inp["boost"], inp["net_size_match"]],
        outputs=[inp["net_size_match"], options_depend_on_match_size])
    inp.rule(options_depend_on_match_size, "visible-if-not",
             "net_size_match")
    inp["tiling_mode"].change(
        fn=lambda a: ((gr.update(value=False), gr.update(value=True))
                      if a else (gr.update(), gr.update())),
        inputs=[inp["tiling_mode"]],
        outputs=[inp["boost"], inp["net_size_match"]])

    inp.rule(options_depend_on_output_depth_1, "visible-if",
             "do_output_depth")
    inp.rule(inp["output_depth_invert"], "visible-if", "do_output_depth")
    inp.rule(inp["output_depth_combine_axis"], "visible-if",
             "output_depth_combine")
    inp.rule(inp["clipdepth_mode"], "visible-if", "clipdepth")
    inp.rule(clip_options_row_1, "visible-if", "clipdepth")

    # keep far <= near (common_ui.py:205-216)
    inp["clipdepth_far"].change(
        fn=lambda a, b: a if b < a else b,
        inputs=[inp["clipdepth_far"], inp["clipdepth_near"]],
        outputs=[inp["clipdepth_near"]], show_progress=False)
    inp["clipdepth_near"].change(
        fn=lambda a, b: a if b > a else b,
        inputs=[inp["clipdepth_near"], inp["clipdepth_far"]],
        outputs=[inp["clipdepth_far"]], show_progress=False)

    inp.rule(stereo_options, "visible-if", "gen_stereo")
    inp.rule(normalmap_options, "visible-if", "gen_normalmap")
    inp.rule(mesh_options, "visible-if", "gen_simple_mesh")
    if is_depth_tab:
        inp.rule(inpaint_options_row_0, "visible-if", "gen_inpainted_mesh")
    inp.rule(bgrem_options, "visible-if", "gen_rembg")
    return inp


def depthmap_mode_video(gr, inp: UIBundle):
    """Single Video input tab (common_ui.py:246-268)."""
    gr.HTML(value="Single video mode allows generating videos from videos. "
                  "All frames are processed — pick settings so generation "
                  "is not too slow. ZoeDepth models give the best temporal "
                  "coherency.")
    inp.add("depthmap_vm_input", gr.File(
        label="Video or animated file", file_count="single",
        interactive=True))
    inp.add("depthmap_vm_custom_checkbox", gr.Checkbox(
        label="Use custom/pregenerated DepthMap video", value=False))
    inp.add("depthmap_vm_smoothening_mode", gr.Dropdown(
        label="Smoothening", type="value",
        choices=["none", "experimental"], value="experimental"))
    vm_custom = inp.add("depthmap_vm_custom", gr.File(
        file_count="single", interactive=True, visible=False))
    with gr.Row():
        inp.add("depthmap_vm_compress_checkbox", gr.Checkbox(
            label="Compress colorvideos?", value=False))
        vm_bitrate = inp.add("depthmap_vm_compress_bitrate", gr.Slider(
            label="Bitrate (kbit)", visible=False, minimum=1000,
            value=15000, maximum=50000, step=250))
    inp.rule(vm_custom, "visible-if", "depthmap_vm_custom_checkbox")
    inp.rule(inp["depthmap_vm_smoothening_mode"], "visible-if-not",
             "depthmap_vm_custom_checkbox")
    inp.rule(vm_bitrate, "visible-if", "depthmap_vm_compress_checkbox")
    return inp


def format_exception(e: Exception) -> str:
    traceback.print_exc()
    msg = "<h3>ERROR: " + str(e) + "</h3>\n"
    if "out of device memory" not in msg:
        msg += ('<code style="white-space: pre;">' + traceback.format_exc()
                + "</code>")
    return msg


def _file_path(f) -> Optional[str]:
    if f is None:
        return None
    return getattr(f, "name", None) or str(f)


def run_generate(named: Dict[str, Any], outpath: Optional[str] = None):
    """Reference run_generate (common_ui.py:454-595): resolve input mode,
    collect images/depthmaps, run the funnel, return (gallery, mesh_fi,
    mesh_display, html)."""
    from depthmap_tpu_torch.io.image import get_unique_filename
    from depthmap_tpu_torch.pipeline.core import core_generation_funnel

    mode = str(named.get("depthmap_mode", "0"))
    outpath = outpath or named.get("depthmap_batch_output_dir") or "outputs"

    if mode == "3":   # Single Video
        try:
            from depthmap_tpu_torch.pipeline import video_mode
            custom = _file_path(named.get("depthmap_vm_custom")) \
                if named.get("depthmap_vm_custom_checkbox") else None
            bitrate = named.get("depthmap_vm_compress_bitrate") \
                if named.get("depthmap_vm_compress_checkbox") else None
            ret = video_mode.gen_video(
                _file_path(named.get("depthmap_vm_input")), outpath, named,
                custom, bitrate, named.get("depthmap_vm_smoothening_mode"))
            return [], None, None, str(ret)
        except Exception as e:
            return [], None, None, format_exception(e)

    inputimages: List[Any] = []
    inputdepthmaps: List[Any] = []
    inputnames: List[Any] = []

    if mode == "0":   # Single Image
        img = named.get("depthmap_input_image")
        if img is None:
            return [], None, None, "Please select an input image"
        inputimages.append(img)
        inputnames.append(None)
        if named.get("custom_depthmap"):
            cdm = _file_path(named.get("custom_depthmap_img"))
            if cdm is None:
                return [], None, None, \
                    "Custom depthmap is not specified. Please either " \
                    "supply it or disable this option."
            inputdepthmaps.append(Image.open(os.path.abspath(cdm)))
        else:
            inputdepthmaps.append(None)
    elif mode == "1":   # Batch Process
        batch = named.get("image_batch") or []
        if not batch:
            return [], None, None, "Please select input images"
        for f in batch:
            path = _file_path(f)
            inputimages.append(Image.open(os.path.abspath(path)))
            inputnames.append(os.path.splitext(os.path.basename(path))[0])
            inputdepthmaps.append(None)
    elif mode == "2":   # Batch from Directory
        indir = named.get("depthmap_batch_input_dir") or ""
        if indir == "":
            return [], None, None, "Please select an input directory."
        if indir == named.get("depthmap_batch_output_dir"):
            return [], None, None, \
                "Please pick different directories for batch processing."
        exts = {".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tiff", ".tif"}
        try:
            files = sorted(p for p in Path(indir).iterdir()
                           if p.suffix.lower() in exts)
            for p in files:
                inputimages.append(Image.open(p))
                inputnames.append(p.stem)
                dm = None
                if named.get("depthmap_batch_reuse", True):
                    # reuse (edited/custom) depthmaps in the output dir
                    for cand in (f"{p.stem}-0000.png", f"{p.stem}.png",
                                 p.name):
                        cp = os.path.join(outpath, cand)
                        if os.path.isfile(cp):
                            dm = Image.open(cp)
                            print(f"Using custom depthmap {cp} for {p.name}")
                            break
                inputdepthmaps.append(dm)
        except Exception as e:
            # a typo'd directory or unreadable file must surface as the
            # formatted error, not a bare Gradio toast
            return [], None, None, format_exception(e)
        print(f"{len(inputimages)} images will be processed")
    else:
        return [], None, None, f"Unknown mode {mode!r}"

    save = named.get("save_outputs", True)
    gallery: List[Any] = []
    mesh_fi = None
    try:
        os.makedirs(outpath, exist_ok=True)
        gen = core_generation_funnel(outpath, inputimages, inputdepthmaps,
                                     inputnames, named)
        for idx, otype, result in gen:
            if otype == "inpainted_mesh":
                mesh_fi = result
                continue
            if is_image_output(result):
                display = result
                if result.dtype == np.uint16:
                    display = (result / 256).astype(np.uint8)
                gallery.append(display)
                if save:
                    base = inputnames[idx] or "depthmap"
                    # depth saves with NO suffix ({stem}-0000.png) like the
                    # reference (scripts/depthmap.py:65) — that is also the
                    # first reuse-candidate name the batch tab looks for
                    suffix = "" if otype == "depth" else str(otype)
                    fn = get_unique_filename(outpath, base, "png",
                                             suffix=suffix)
                    Image.fromarray(result).save(fn)
            elif isinstance(result, str):
                gallery.append(result) if result.endswith(".png") else None
    except Exception as e:
        return gallery, None, None, format_exception(e)

    html = f"Generated {len(gallery)} output(s) in {outpath}"
    if mesh_fi:
        html += f"<br/>Mesh saved to {mesh_fi}"
    return gallery, mesh_fi, mesh_fi, html


def run_makevideo_ui(fn_mesh, vid_numframes, vid_fps, vid_traj, vid_shift,
                     vid_border, vid_dolly, vid_format, vid_ssaa,
                     outpath: str = "outputs"):
    """Generate-video tab action (reference core.py:614 run_makevideo)."""
    try:
        from depthmap_tpu_torch.pipeline.inpaint_video import run_makevideo
        traj_names = ["straight-line", "double-straight-line", "circle"]
        traj = traj_names[int(vid_traj)] if str(vid_traj).isdigit() \
            else str(vid_traj)
        paths = run_makevideo(fn_mesh, int(vid_numframes), float(vid_fps),
                              traj, vid_shift, vid_border, bool(vid_dolly),
                              str(vid_format), int(vid_ssaa),
                              outpath=outpath)
        path = paths[0] if isinstance(paths, (list, tuple)) else paths
        return path, "", f"Saved to {path}"
    except Exception as e:
        return None, "", format_exception(e)


def build_ui(gr_module=None):
    gr = gr_module or _gradio
    if gr is None:
        raise RuntimeError(
            "gradio is not installed. Use the CLI (python -m "
            "depthmap_tpu_torch ...) or the REST API (python -m "
            "depthmap_tpu_torch --serve) instead; both expose the full "
            "pipeline.")

    inp = UIBundle(gr)
    with gr.Blocks(analytics_enabled=False, title="depthmap_tpu_torch") as demo:
        with gr.Row(equal_height=False):
            with gr.Column(variant="panel"):
                inp.add("depthmap_mode", gr.Textbox(visible=False,
                                                    value="0"))
                with gr.Tabs():
                    with gr.TabItem("Single Image") as mode_0:
                        with gr.Row():
                            inp.add("depthmap_input_image", gr.Image(
                                label="Source", interactive=True,
                                type="pil"))
                            inp.add("custom_depthmap_img", gr.File(
                                label="Custom DepthMap", file_count="single",
                                interactive=True, visible=False))
                        inp.add("custom_depthmap", gr.Checkbox(
                            label="Use custom DepthMap", value=False))
                    with gr.TabItem("Batch Process") as mode_1:
                        inp.add("image_batch", gr.File(
                            label="Batch Process", file_count="multiple",
                            interactive=True))
                    with gr.TabItem("Batch from Directory") as mode_2:
                        inp.add("depthmap_batch_input_dir", gr.Textbox(
                            label="Input directory",
                            placeholder="A directory on the machine where "
                                        "the server is running."))
                        inp.add("depthmap_batch_output_dir", gr.Textbox(
                            label="Output directory",
                            placeholder="Leave blank to save images to the "
                                        "default path."))
                        gr.HTML("Files in the output directory may be "
                                "overwritten.")
                        inp.add("depthmap_batch_reuse", gr.Checkbox(
                            label="Skip generation and use (edited/custom) "
                                  "depthmaps in output directory when a "
                                  "file already exists.", value=True))
                    with gr.TabItem("Single Video") as mode_3:
                        depthmap_mode_video(gr, inp)
                submit = gr.Button("Generate", variant="primary")
                main_ui_panel(gr, inp, is_depth_tab=True)
                unloadmodels = gr.Button("Unload models")

            with gr.Column(variant="panel"):
                with gr.Tabs():
                    with gr.TabItem("Depth Output"):
                        result_images = gr.Gallery(label="Output",
                                                   show_label=False,
                                                   columns=4)
                        html_info = gr.HTML()
                    with gr.TabItem("3D Mesh"):
                        result_depthmesh = gr.Model3D(
                            label="3d Mesh",
                            clear_color=[1.0, 1.0, 1.0, 1.0])
                        clearmesh = gr.Button("Clear")
                    with gr.TabItem("Generate video"):
                        gr.Markdown("Generate video from inpainted(!) mesh.")
                        depth_vid = gr.Video(interactive=False)
                        vid_html_info_x = gr.HTML()
                        vid_html_info = gr.HTML()
                        fn_mesh = gr.Textbox(
                            label="Input Mesh (.ply | .obj)",
                            placeholder="A file on the machine where the "
                                        "server is running.")
                        with gr.Row():
                            vid_numframes = gr.Textbox(
                                label="Number of frames", value="300")
                            vid_fps = gr.Textbox(label="Framerate",
                                                 value="40")
                            vid_format = gr.Dropdown(
                                label="Format", choices=["mp4", "webm"],
                                value="mp4", type="value")
                            vid_ssaa = gr.Dropdown(
                                label="SSAA", choices=["1", "2", "3", "4"],
                                value="3", type="value")
                        with gr.Row():
                            vid_traj = gr.Dropdown(
                                label="Trajectory", type="index",
                                choices=["straight-line",
                                         "double-straight-line", "circle"],
                                value="double-straight-line")
                            vid_shift = gr.Textbox(
                                label="Translate: x, y, z",
                                value="-0.015, 0.0, -0.05")
                            vid_border = gr.Textbox(
                                label="Crop: top, left, bottom, right",
                                value="0.03, 0.03, 0.05, 0.03")
                            vid_dolly = gr.Checkbox(label="Dolly",
                                                    value=False)
                        submit_vid = gr.Button("Generate Video",
                                               variant="primary")

        mode_0.select(lambda: "0", None, inp["depthmap_mode"])
        mode_1.select(lambda: "1", None, inp["depthmap_mode"])
        mode_2.select(lambda: "2", None, inp["depthmap_mode"])
        mode_3.select(lambda: "3", None, inp["depthmap_mode"])

        # custom-depthmap visibility choreography (common_ui.py:377-391)
        def custom_depthmap_change_fn(mode, zero_on, three_on):
            hide = (mode == "0" and zero_on) or (mode == "3" and three_on)
            return gr.update(visible=hide), not hide

        for el in ("depthmap_mode", "custom_depthmap",
                   "depthmap_vm_custom_checkbox"):
            inp[el].change(
                fn=custom_depthmap_change_fn,
                inputs=[inp["depthmap_mode"], inp["custom_depthmap"],
                        inp["depthmap_vm_custom_checkbox"]],
                outputs=[inp["custom_depthmap_img"],
                         inp["do_output_depth"]])

        def unload():
            from depthmap_tpu_torch.pipeline.core import _default_cache
            _default_cache.unload()

        unloadmodels.click(fn=unload, inputs=[], outputs=[])
        clearmesh.click(fn=lambda: None, inputs=[],
                        outputs=[result_depthmesh])

        def _submit(*values):
            return run_generate(inp.rekey(values))

        submit.click(fn=_submit, inputs=inp.inputs(),
                     outputs=[result_images, fn_mesh, result_depthmesh,
                              html_info])
        submit_vid.click(
            fn=run_makevideo_ui,
            inputs=[fn_mesh, vid_numframes, vid_fps, vid_traj, vid_shift,
                    vid_border, vid_dolly, vid_format, vid_ssaa],
            outputs=[depth_vid, vid_html_info_x, vid_html_info])

    demo.depthmap_bundle = inp   # introspection hook (for tests)
    return demo


def launch_ui(host: str = "127.0.0.1", port: int = 7860,
              share: bool = False):
    demo = build_ui()
    demo.launch(server_name=host, server_port=port, share=share)
