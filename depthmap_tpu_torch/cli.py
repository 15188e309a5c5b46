"""Command-line frontend of the port: image/batch depth generation.

    python -m depthmap_tpu_torch img.png --model dpt_beit_large_512 --stereo
    python -m depthmap_tpu_torch --serve --port 7860   # the REST API
    python -m depthmap_tpu_torch --ui --port 7860      # the Gradio UI

Same flags as ``depthmap_tpu/frontends/cli.py``; every yielded artifact is
saved into the output directory with sequence-numbered names (the simple
mesh and the inpainted mesh are written there by the funnel).  ``--video``
runs video mode (``pipeline/video_mode.py gen_video``) on a video file or a
directory of frames; ``--serve`` starts the REST server
(``frontends/api.py``) and ``--ui`` the Gradio UI
(``frontends/gradio_ui.py``, which needs gradio) on ``--listen`` /
``--port``.  PIL is imported only to load and save images.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

from depthmap_tpu_torch.io.image import get_unique_filename
from depthmap_tpu_torch.options import GenerationOptions
from depthmap_tpu_torch.registry import (MODELS_BY_NAME, get_default_net_size,
                                         resolve_model_type)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="depthmap_tpu_torch",
        description="Monocular depth & stereo pipeline (PyTorch + CUDA)")
    p.add_argument("inputs", nargs="*",
                   help="input image file(s) or directory")
    p.add_argument("--output", "-o", default="./outputs",
                   help="output directory (default ./outputs)")
    p.add_argument("--model", default="midas_v21_small",
                   help="model name or id (%s)" % ", ".join(MODELS_BY_NAME))
    p.add_argument("--net-width", type=int, default=None)
    p.add_argument("--net-height", type=int, default=None)
    p.add_argument("--net-size-match", action="store_true",
                   help="match net size to input size (rounded to /32)")
    p.add_argument("--compute-device", default="GPU", choices=["GPU", "CPU"],
                   help="'GPU' = CUDA (fails without it), 'CPU' = host")
    p.add_argument("--boost", action="store_true")
    p.add_argument("--tiling-mode", action="store_true",
                   help="circular conv padding for seamless tiles")
    p.add_argument("--rembg", action="store_true")
    p.add_argument("--rembg-model", default="u2net")
    p.add_argument("--inpainted-mesh", action="store_true")
    p.add_argument("--inpainted-mesh-demos", action="store_true")
    p.add_argument("--ui", action="store_true",
                   help="launch the Gradio web UI (requires gradio)")
    p.add_argument("--invert-depth", action="store_true")
    p.add_argument("--combine-output", action="store_true")
    p.add_argument("--clipdepth", action="store_true")
    p.add_argument("--clipdepth-mode", default="Range",
                   choices=["Range", "Outliers"])
    p.add_argument("--clipdepth-far", type=float, default=0.0)
    p.add_argument("--clipdepth-near", type=float, default=1.0)
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--stereo-modes", nargs="+",
                   default=["left-right", "red-cyan-anaglyph"])
    p.add_argument("--stereo-divergence", type=float, default=2.5)
    p.add_argument("--stereo-separation", type=float, default=0.0)
    p.add_argument("--stereo-fill", default="polylines_sharp")
    p.add_argument("--stereo-offset-exponent", type=float, default=1.0)
    p.add_argument("--stereo-balance", type=float, default=0.0)
    p.add_argument("--normalmap", action="store_true")
    p.add_argument("--heatmap", action="store_true")
    p.add_argument("--mesh", action="store_true", help="simple textured mesh")
    p.add_argument("--mesh-no-occlude", action="store_true")
    p.add_argument("--mesh-spherical", action="store_true")
    p.add_argument("--depthmap", default=None,
                   help="custom depthmap image (skips prediction)")
    p.add_argument("--reuse-depthmaps", default=None, metavar="DIR",
                   help="reuse previously generated '<name>-*-depth.png' "
                        "files from DIR")
    p.add_argument("--video", default=None, help="input video file")
    p.add_argument("--smoothening", default="none",
                   choices=["none", "experimental"])
    p.add_argument("--serve", action="store_true", help="start the REST API")
    p.add_argument("--listen", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    return p


def args_to_options(a: argparse.Namespace) -> GenerationOptions:
    mt = resolve_model_type(a.model)
    dw, dh = get_default_net_size(mt)
    return GenerationOptions(
        compute_device=a.compute_device,
        model_type=mt, boost=a.boost,
        net_size_match=a.net_size_match,
        net_width=a.net_width or dw, net_height=a.net_height or dh,
        output_depth_invert=a.invert_depth,
        output_depth_combine=a.combine_output,
        clipdepth=a.clipdepth, clipdepth_mode=a.clipdepth_mode,
        clipdepth_far=a.clipdepth_far, clipdepth_near=a.clipdepth_near,
        gen_stereo=a.stereo, stereo_modes=list(a.stereo_modes),
        stereo_divergence=a.stereo_divergence,
        stereo_separation=a.stereo_separation,
        stereo_fill_algo=a.stereo_fill,
        stereo_offset_exponent=a.stereo_offset_exponent,
        stereo_balance=a.stereo_balance,
        gen_normalmap=a.normalmap, gen_heatmap=a.heatmap,
        gen_simple_mesh=a.mesh,
        simple_mesh_occlude=not a.mesh_no_occlude,
        simple_mesh_spherical=a.mesh_spherical,
        tiling_mode=a.tiling_mode,
        gen_rembg=a.rembg, rembg_model=a.rembg_model,
        gen_inpainted_mesh=a.inpainted_mesh,
        gen_inpainted_mesh_demos=a.inpainted_mesh_demos,
    )


def collect_inputs(paths: List[str]) -> List[str]:
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff"}
    files = []
    for p in paths:
        if os.path.isdir(p):
            files += sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if os.path.splitext(f)[1].lower() in exts)
        else:
            files.append(p)
    return files


def save_result(outpath: str, basename: str, output_type: str,
                result) -> str:
    """Save one funnel output as PNG (uint16 depth as 16-bit grayscale);
    an output that is already a saved file (the simple mesh's OBJ path)
    is passed through."""
    from PIL import Image
    os.makedirs(outpath, exist_ok=True)
    if isinstance(result, str):
        return result
    suffix = {"depth": "depth", "concat_depth": "concat_depth",
              "normalmap": "normal", "heatmap": "heatmap"}.get(
                  output_type, output_type)
    fn = get_unique_filename(outpath, basename, "png", suffix)
    Image.fromarray(np.asarray(result)).save(fn)   # uint16 -> mode I;16
    return fn


def _load_images(paths):
    from PIL import Image
    return [Image.open(f) for f in paths]


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.ui:
        from depthmap_tpu_torch.frontends.gradio_ui import launch_ui
        launch_ui(host=args.listen, port=args.port)
        return 0
    if args.serve:
        from depthmap_tpu_torch.frontends.api import serve
        serve(host=args.listen, port=args.port)
        return 0
    if args.video is not None:
        from depthmap_tpu_torch.pipeline.video_mode import gen_video
        for fn in gen_video(args.video, args.output, args_to_options(args),
                            smoothening=args.smoothening):
            print(f"saved {fn}")
        return 0
    files = collect_inputs(args.inputs)
    if not files:
        print("No input images given", file=sys.stderr)
        return 2

    from depthmap_tpu_torch.pipeline.core import core_generation_funnel
    images = _load_images(files)
    names = [os.path.splitext(os.path.basename(f))[0] for f in files]
    depthmaps = None
    if args.depthmap:
        depthmaps = _load_images([args.depthmap]) * len(images)
    elif args.reuse_depthmaps:
        import glob
        depthmaps = []
        for name in names:
            cands = sorted(glob.glob(
                os.path.join(args.reuse_depthmaps, f"{name}-*-depth.png")))
            depthmaps.append(_load_images(cands[-1:])[0] if cands else None)
        if all(d is None for d in depthmaps):
            depthmaps = None

    count = 0
    for idx, output_type, result in core_generation_funnel(
            args.output, images, depthmaps, names, args_to_options(args)):
        if output_type == "depth_prediction":
            continue
        fn = save_result(args.output, names[idx], output_type, result)
        print(f"[{idx}] {output_type}: {fn}")
        count += 1
    print(f"Done. {count} output(s) in {args.output}")
    return 0


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()
