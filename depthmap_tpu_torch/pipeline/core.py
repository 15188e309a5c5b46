"""The generation funnel: image(s) -> depth -> derived outputs (torch).

Port of ``depthmap_tpu/pipeline/core.py``: a generator yielding
(input_index, output_type, result) tuples.  Results are numpy arrays where
the JAX funnel yields PIL images: 'depth' is (H, W) uint16, 'concat_depth'
and the stereo modes are uint8 RGB.

Every model of the zoo runs: LeReS (type 0), the MiDaS / DPT zoo (types
1-6), ZoeDepth n / k / nk (types 7-9), Marigold (type 10: its
``marigold_ensembles`` and ``marigold_steps`` ops, 5 and 12 by default,
build its predictor) and Depth Anything v1 / v2 (the default options'
model, Depth Anything v2 Base).  Ported outputs: depth (plain, inverted,
concatenated), depth_prediction, stereo with all five fills, the normal
map ((H, W, 3) uint8, computed on the funnel's device), the heatmap ((H,
W, 4) uint8) and the simple mesh (the path of the OBJ written).  ``boost``
runs the Boost merge (``pipeline/boost.py``) on any model, up to the
``boost_rmax`` op (1600 by default); its pix2pix weights come from
``<weights_dir>/pix2pix/latest_net_G.pth``, and without that file it raises
FileNotFoundError unless DEPTHMAP_ALLOW_RANDOM_PIX2PIX=1.
``gen_inpainted_mesh`` collects every image with its uint16 map and, after
the last one, runs the 3D photo (``pipeline/inpaint_video.py
run_3dphoto``: the filter, the nets and the demo renders on the funnel's
device, the nets from ``./models/3dphoto`` when their checkpoints are
there) and yields ``(0, "inpainted_mesh", path of the OBJ)``; a failure
there raises.  ``gen_rembg`` removes the background through the optional
``rembg`` package (``pipeline/rembg_integration.py``), before the depth or
after it, masks the uint16 map in place (so the mask reaches the 3D photo)
and yields ``background_removed`` (RGBA) and, when asked,
``foreground_mask``; without rembg it prints and skips, as the JAX funnel
does.  An out-of-memory error re-raises as an Exception carrying the JAX
funnel's advice.  ``compute_device`` picks
the device: "GPU" is CUDA (and raises without it), "CPU" is the host.
A call that passes no ``predictor_cache`` uses the module's
``_default_cache``, so the model stays on its device between calls
unless ``ops["keepmodels"]`` is false.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from depthmap_tpu_torch.device import resolve_device
from depthmap_tpu_torch.models.build import is_host_pipeline
from depthmap_tpu_torch.ops import numerics
from depthmap_tpu_torch.ops.heatmap import colorize
from depthmap_tpu_torch.ops.normalmap import create_normalmap
from depthmap_tpu_torch.ops.stereo import create_stereoimages
from depthmap_tpu_torch.options import GenerationOptions
from depthmap_tpu_torch.pipeline.depth import DepthPredictor
from depthmap_tpu_torch.registry import resolve_model_type
from depthmap_tpu_torch.utils.profiling import stage


class PredictorCache:
    """Keeps the last predictor alive across funnel invocations."""

    def __init__(self):
        self._predictor: Optional[DepthPredictor] = None
        self._key: Optional[tuple] = None
        self._boost = None

    def get(self, model_type, tiling_mode: bool = False,
            **kw) -> DepthPredictor:
        mt = resolve_model_type(model_type)
        if not is_host_pipeline(mt):   # Marigold's knobs shape it alone
            kw = {k: v for k, v in kw.items()
                  if not k.startswith("marigold_")}
        key = (mt, tiling_mode, tuple(sorted(kw.items())))
        if self._predictor is None or self._key != key:
            self.release()   # free the old model first
            self._predictor = DepthPredictor(mt, tiling_mode=tiling_mode,
                                             **kw)
            self._key = key
        return self._predictor

    def get_boost(self, model_type, weights_dir: str = "./models", **kw):
        """The Boost engine around the predictor ``get`` gives, its merge
        net loaded once (``_load_pix2pix``)."""
        from depthmap_tpu_torch.pipeline.boost import BoostEngine
        predictor = self.get(model_type, **kw)
        if self._boost is None or self._boost.predictor is not predictor:
            self._boost = BoostEngine(predictor,
                                      merge_net=_load_pix2pix(weights_dir))
        return self._boost

    def release(self):
        """Drop the predictor and the Boost engine, so their device memory
        frees."""
        self._predictor = None
        self._key = None
        self._boost = None

    def unload(self):
        """The frontends' name for ``release``."""
        self.release()


_default_cache = PredictorCache()


def _load_pix2pix(weights_dir: str):
    """The merge net with ``<weights_dir>/pix2pix/latest_net_G.pth`` loaded
    (strictly), fetched first under DEPTHMAP_ALLOW_DOWNLOAD=1 (a failed
    fetch prints and goes on); without the file, FileNotFoundError, or
    with DEPTHMAP_ALLOW_RANDOM_PIX2PIX=1 a warning and ``None`` (seeded
    random weights)."""
    path = os.path.join(weights_dir, "pix2pix", "latest_net_G.pth")
    if not os.path.exists(path) and \
            os.environ.get("DEPTHMAP_ALLOW_DOWNLOAD") == "1":
        try:
            from depthmap_tpu_torch.utils.download import \
                ensure_pix2pix_downloaded
            path = ensure_pix2pix_downloaded(weights_dir)
        except Exception as e:
            print(f"pix2pix download failed ({e}); "
                  "Boost merge quality will be degraded")
    if os.path.exists(path):
        from depthmap_tpu_torch.models.pix2pix import build_pix2pix
        from depthmap_tpu_torch.models.weights import load_pix2pix
        net = build_pix2pix()
        net.load_state_dict(load_pix2pix(path), strict=True)
        return net
    advice = ("pix2pix merge-net weights not found: Boost would merge "
              "through a random-init net and emit plausible-looking but "
              "wrong depth.  Set DEPTHMAP_ALLOW_DOWNLOAD=1 or place "
              f"latest_net_G.pth under {weights_dir}/pix2pix/, or set "
              "DEPTHMAP_ALLOW_RANDOM_PIX2PIX=1 to run anyway (tests and "
              "benchmarks only).")
    if os.environ.get("DEPTHMAP_ALLOW_RANDOM_PIX2PIX") == "1":
        print("warning: " + advice)
        return None
    raise FileNotFoundError(advice)


def ingest_custom_depthmap(dp, target_w: int, target_h: int) -> np.ndarray:
    """Custom-depthmap ingest of the JAX funnel (restated): a PIL image is
    resized with LANCZOS; single-channel maps autodetect 8/16/32 bit, RGB
    maps take channel 0 / 256; arrays must already have the target size."""
    if hasattr(dp, "getbands"):
        from PIL import Image
        if dp.width != target_w or dp.height != target_h:
            dp = dp.resize((target_w, target_h), Image.Resampling.LANCZOS)
        if len(dp.getbands()) == 1:
            out = np.asarray(dp, dtype="float")
            out_max = out.max()
            if out_max < 256:
                bit_depth = 8
            elif out_max < 65536:
                bit_depth = 16
            else:
                bit_depth = 32
            out = out / (2.0 ** bit_depth)
        else:
            out = np.asarray(dp, dtype="float")[:, :, 0] / 256.0
        return out
    out = np.asarray(dp, dtype="float")
    if out.shape[:2] != (target_h, target_w):
        raise ValueError(f"custom depthmap shape {out.shape[:2]} != image "
                         f"shape {(target_h, target_w)}")
    return out


def to_rgb(image) -> np.ndarray:
    """PIL image or array -> (H, W, 3) uint8 (a writable array: torch
    refuses to wrap PIL's read-only buffers)."""
    if hasattr(image, "convert"):
        if image.mode == "I":
            image = image.point(lambda p: p * 0.0039063096)
        return np.array(image.convert("RGB"))
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return arr


def options_device(inp) -> torch.device:
    """The torch device ``inp.compute_device`` names: "CPU" is the host,
    anything else CUDA (which raises without a card)."""
    return resolve_device(
        "cpu" if str(inp.compute_device).upper() == "CPU" else "cuda")


def _funnel_net_size(inp, w: int, h: int):
    if inp.net_size_match:
        return (w + 31) // 32 * 32, (h + 31) // 32 * 32
    return inp.net_width, inp.net_height


def oom_suggestion(inp) -> str:
    """The JAX funnel's out-of-memory advice for these options (the
    reference's, core.py:310-326)."""
    suggestion = "out of device memory, could not generate depthmap! " \
                 "Suggestions:\n"
    if inp.boost:
        suggestion += " * Disable BOOST (faster, less detailed depthmap)\n"
    else:
        suggestion += " * Reduce net size (could reduce quality)\n"
    if resolve_model_type(inp.model_type) != 6:
        suggestion += " * Use a smaller model (e.g. midas_v21_small)\n"
    return suggestion


@contextlib.contextmanager
def _oom_advice(inp):
    """Re-raise torch.OutOfMemoryError, or any error whose text holds "out
    of memory", as an Exception carrying ``oom_suggestion``."""
    try:
        yield
    except Exception as e:
        if isinstance(e, torch.OutOfMemoryError) or \
                "out of memory" in str(e).lower():
            raise Exception(oom_suggestion(inp)) from e
        raise


def _pixels(image) -> int:
    """H x W of a PIL image or an array."""
    if hasattr(image, "getbands"):
        return image.height * image.width
    shape = np.asarray(image).shape
    return shape[0] * shape[1]


def _convert_to_i16_host(out: np.ndarray) -> np.ndarray:
    """numerics.convert_to_i16 of a host map (the JAX funnel's numpy twin:
    clip(out, 0, 1) * 65536 + 0.0001 in f64, clipped, truncated)."""
    x = np.clip(out, 0, 1) * 65536.0 + 0.0001
    return np.clip(x, 0, 65536.0 - 0.1).astype("uint16")


def core_generation_funnel(outpath: Optional[str], inputimages: List,
                           inputdepthmaps: Optional[List] = None,
                           inputnames: Optional[List] = None,
                           inp: Any = None,
                           ops: Optional[Dict] = None,
                           predictor_cache: Optional[PredictorCache] = None):
    """Yields (index, output_type, result)."""
    if len(inputimages) == 0 or inputimages[0] is None:
        return
    if inputdepthmaps is None or len(inputdepthmaps) == 0:
        inputdepthmaps = [None] * len(inputimages)
    inputdepthmaps_complete = all(x is not None for x in inputdepthmaps)
    inp = GenerationOptions.from_dict(inp if inp is not None else {})
    cache = predictor_cache or _default_cache
    ops = ops or {}
    dev = options_device(inp)
    predictor_kw: Dict[str, Any] = {"device": dev}
    if ops.get("no_half"):
        predictor_kw["compute_dtype"] = "float32"
    boost_rmax = int(ops.get("boost_rmax", 1600))
    if not inputdepthmaps_complete and is_host_pipeline(inp.model_type):
        predictor_kw["marigold_ensembles"] = int(
            ops.get("marigold_ensembles", 5))
        predictor_kw["marigold_steps"] = int(ops.get("marigold_steps", 12))

    background_removed: List[np.ndarray] = []
    if inp.gen_rembg:
        from depthmap_tpu_torch.pipeline.rembg_integration import (
            batched_background_removal, rembg_available)
        if not rembg_available():
            print("rembg is not installed; skipping background removal")
            inp = inp.replace(gen_rembg=False)
        else:
            background_removed = batched_background_removal(
                inputimages, inp.rembg_model)
            if inp.pre_depth_background_removal:
                inputimages = background_removed

    predictor = None
    if not inputdepthmaps_complete:
        predictor = cache.get(inp.model_type, tiling_mode=inp.tiling_mode,
                              **predictor_kw)

    # Batched pre-pass: images that share a shape and need no host-side raw
    # map ride one forward + finalize per chunk of DEPTHMAP_FUNNEL_BATCH
    # (Marigold's one image at a time).  It holds every input's RGB array
    # and uint16 map (5 bytes a pixel) until the loop below yields them, so
    # above DEPTHMAP_FUNNEL_BATCH_MAX_BYTES (1 GiB) of inputs it is skipped
    # and the loop streams one image at a time.  A failure raises: it does
    # not fall back to the serial loop.  The raw map goes to the host for
    # depth_prediction and the simple mesh, and Boost makes it there.
    raw_to_host = inp.do_output_depth_prediction or inp.gen_simple_mesh or \
        inp.boost
    fused: Dict[int, np.ndarray] = {}
    rgb_cache: Dict[int, np.ndarray] = {}
    inpaint_imgs: List[np.ndarray] = []
    inpaint_depths: List[np.ndarray] = []
    if predictor is not None and not raw_to_host and len(inputimages) > 1:
        chunk = int(os.environ.get("DEPTHMAP_FUNNEL_BATCH", "8"))
        max_bytes = int(os.environ.get("DEPTHMAP_FUNNEL_BATCH_MAX_BYTES",
                                       str(1 << 30)))
        total = sum(5 * _pixels(im) for im in inputimages)
        groups: Dict[Tuple[int, int], list] = {}
        if chunk >= 2 and total <= max_bytes:
            for count, image in enumerate(inputimages):
                if inputdepthmaps[count] is not None:
                    continue
                arr = to_rgb(image)
                rgb_cache[count] = arr
                groups.setdefault(arr.shape[:2], []).append((count, arr))
        for (h, w), members in groups.items():
            if len(members) < 2:
                continue
            nw, nh = _funnel_net_size(inp, w, h)
            for i in range(0, len(members), chunk):
                part = members[i:i + chunk]
                stack = np.stack([m[1] for m in part]).astype(
                    np.float32) / 255.0
                with _oom_advice(inp):
                    maps = predictor.finalized_batch(
                        stack, nw, nh, clip=inp.clipdepth,
                        clip_mode=inp.clipdepth_mode,
                        clip_far=inp.clipdepth_far,
                        clip_near=inp.clipdepth_near).cpu().numpy()
                for (idx, _), m16 in zip(part, maps):
                    fused[idx] = m16

    for count, image in enumerate(inputimages):
        img = rgb_cache.pop(count, None)
        if img is None:
            img = to_rgb(image)
        h, w = img.shape[:2]

        img_output = None
        depthi = None      # the map the simple mesh is made from
        if inputdepthmaps[count] is not None:
            depthi = ingest_custom_depthmap(inputdepthmaps[count], w, h)
            img_output = _convert_to_i16_host(depthi)
        elif count in fused:
            img_output = fused.pop(count)
        else:
            net_w, net_h = _funnel_net_size(inp, w, h)
            img01 = img.astype(np.float32) / 255.0
            if not raw_to_host:
                with _oom_advice(inp), stage("depth_predict"):
                    img_output = predictor.predict_finalized(
                        img01, net_w, net_h, clip=inp.clipdepth,
                        clip_mode=inp.clipdepth_mode,
                        clip_far=inp.clipdepth_far,
                        clip_near=inp.clipdepth_near)
            else:
                if inp.boost:
                    with _oom_advice(inp):
                        boost = cache.get_boost(
                            inp.model_type, tiling_mode=inp.tiling_mode,
                            **predictor_kw)
                        with stage("boost_estimate"):
                            raw = boost.estimate(
                                img01, whole_size_threshold=boost_rmax)
                else:
                    with _oom_advice(inp), stage("depth_predict"):
                        raw = predictor.predict(img01, net_w, net_h)
                depthi = raw
                invert = predictor.raw_prediction_invert
                if inp.do_output_depth_prediction and \
                        abs(raw.max() - raw.min()) > np.finfo("float").eps:
                    yield count, "depth_prediction", -raw if invert else \
                        np.copy(raw)
                img_output = numerics.finalize_i16(
                    torch.from_numpy(raw), invert=invert,
                    clip=inp.clipdepth, clip_mode=inp.clipdepth_mode,
                    clip_far=inp.clipdepth_far,
                    clip_near=inp.clipdepth_near).numpy()

        if inp.gen_inpainted_mesh:
            inpaint_imgs.append(img)
            inpaint_depths.append(img_output)

        if inp.gen_rembg:
            from depthmap_tpu_torch.pipeline.rembg_integration import (
                background_mask, foreground_mask_image)
            removed = background_removed[count]
            bg_mask = background_mask(removed)
            # in place: the map kept for the 3D photo above is this array,
            # so the mask reaches the mesh, as in the JAX funnel
            img_output[bg_mask] = 0
            yield count, "background_removed", removed
            if inp.save_background_removal_masks:
                yield count, "foreground_mask", foreground_mask_image(bg_mask)

        if inp.do_output_depth:
            img_depth = img_output
            if inp.output_depth_invert:
                img_depth = numerics.invert_i16(
                    torch.from_numpy(img_output)).numpy()
            if inp.output_depth_combine:
                axis = 1 if inp.output_depth_combine_axis == "Horizontal" \
                    else 0
                rgb = numerics.convert_i16_to_rgb(
                    torch.from_numpy(img_depth)).numpy()
                yield count, "concat_depth", np.concatenate((img, rgb),
                                                            axis=axis)
            else:
                yield count, "depth", img_depth

        if inp.gen_stereo:
            with stage("stereo"):
                stereoimages = create_stereoimages(
                    img, img_output, inp.stereo_divergence,
                    inp.stereo_separation, inp.stereo_modes,
                    inp.stereo_balance, inp.stereo_offset_exponent,
                    inp.stereo_fill_algo, device=dev)
            for c, simg in enumerate(stereoimages):
                yield count, inp.stereo_modes[c], simg

        if inp.gen_normalmap:
            yield count, "normalmap", create_normalmap(
                img_output,
                inp.normalmap_pre_blur_kernel if inp.normalmap_pre_blur
                else None,
                inp.normalmap_sobel_kernel if inp.normalmap_sobel else None,
                inp.normalmap_post_blur_kernel if inp.normalmap_post_blur
                else None,
                inp.normalmap_invert, device=dev).cpu().numpy()

        if inp.gen_heatmap:
            yield count, "heatmap", colorize(img_output, cmap="inferno")

        if inp.gen_simple_mesh:
            from depthmap_tpu_torch.pipeline.mesh import \
                create_simple_mesh_output
            yield count, "simple_mesh", create_simple_mesh_output(
                img, depthi, outpath,
                model_type=resolve_model_type(inp.model_type)
                if not inputdepthmaps_complete else -1,
                boost=inp.boost,
                custom_depthmap=inputdepthmaps[count] is not None,
                occlude=inp.simple_mesh_occlude,
                spherical=inp.simple_mesh_spherical)

    if inp.gen_inpainted_mesh and inpaint_imgs:
        from depthmap_tpu_torch.pipeline.inpaint_video import run_3dphoto
        yield 0, "inpainted_mesh", run_3dphoto(
            dev, inpaint_imgs, inpaint_depths, inputnames, outpath or ".",
            inp.gen_inpainted_mesh_demos, 1, "mp4")

    if not bool(ops.get("keepmodels", True)):
        cache.release()
