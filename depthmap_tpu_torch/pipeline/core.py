"""The generation funnel: image(s) -> depth -> derived outputs (torch).

Port of ``depthmap_tpu/pipeline/core.py``: a generator yielding
(input_index, output_type, result) tuples.  Results are numpy arrays where
the JAX funnel yields PIL images: 'depth' is (H, W) uint16, 'concat_depth'
and the stereo modes are uint8 RGB.

Every model of the zoo runs: LeReS (type 0), the MiDaS / DPT zoo (types
1-6), ZoeDepth n / k / nk (types 7-9), Marigold (type 10: its
``marigold_ensembles`` and ``marigold_steps`` ops, 5 and 12 by default,
set its predictor's members and steps; an ``inp`` given as a mapping may
carry them too, ``ops`` winning) and Depth Anything v1 / v2 (the default
options' model, Depth Anything v2 Base).  Ported outputs: depth (plain,
inverted, concatenated), depth_prediction, stereo with all five fills, the
normal map ((H, W, 3) uint8, computed on the funnel's device), the heatmap
((H, W, 4) uint8) and the simple mesh (the path of the OBJ written).
``boost`` runs the Boost merge (``pipeline/boost.py``) on any model, up to
the ``boost_rmax`` op (1600 by default); its pix2pix weights come from
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
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from depthmap_tpu_torch.device import resolve_device
from depthmap_tpu_torch.models.build import is_host_pipeline
from depthmap_tpu_torch.ops import numerics
from depthmap_tpu_torch.ops.heatmap import colorize
from depthmap_tpu_torch.ops.normalmap import create_normalmap
from depthmap_tpu_torch.ops.stereo import (create_stereoimages,
                                           stereoimages_to_host)
from depthmap_tpu_torch.options import GenerationOptions
from depthmap_tpu_torch.pipeline.depth import DepthPredictor, to_host
from depthmap_tpu_torch.registry import resolve_model_type
from depthmap_tpu_torch.utils.profiling import new_call, stage


MARIGOLD_OPS = ("marigold_ensembles", "marigold_steps")


class PredictorCache:
    """Keeps the last predictor alive across funnel invocations."""

    def __init__(self):
        self._predictor: Optional[DepthPredictor] = None
        self._key: Optional[tuple] = None
        self._boost = None

    def get(self, model_type, tiling_mode: bool = False,
            **kw) -> DepthPredictor:
        """The kept predictor where the model and its build arguments
        match, else a new one.  Marigold's knobs (``marigold_*``) are
        settings of each call, not of the build: given, they are set on the
        predictor of type 10; any other model ignores them."""
        mt = resolve_model_type(model_type)
        knobs = {k: kw.pop(k) for k in list(kw) if k.startswith("marigold_")}
        key = (mt, tiling_mode, tuple(sorted(kw.items())))
        if self._predictor is None or self._key != key:
            self.release()   # free the old model first
            self._predictor = DepthPredictor(mt, tiling_mode=tiling_mode,
                                             **kw)
            self._key = key
        if is_host_pipeline(mt):
            for k, v in knobs.items():
                setattr(self._predictor, k, v)
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


# photos of one shape ride one forward + finalize per run of up to this many
FUNNEL_CHUNK = 8


def _hw(image) -> Tuple[int, int]:
    """(H, W) of a PIL image or an array, read without converting it."""
    if hasattr(image, "getbands"):
        return image.height, image.width
    return tuple(np.shape(image)[:2])


def _chunk_plan(images, depthmaps) -> Dict[int, List[int]]:
    """Each photo without a custom depth map -> the input indices of its
    chunk: the photos grouped by (H, W) in input order, each group cut
    into runs of FUNNEL_CHUNK (a photo alone in its group is a chunk of
    one)."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, (image, dm) in enumerate(zip(images, depthmaps)):
        if dm is None:
            groups.setdefault(_hw(image), []).append(i)
    plan: Dict[int, List[int]] = {}
    for members in groups.values():
        for s in range(0, len(members), FUNNEL_CHUNK):
            chunk = members[s:s + FUNNEL_CHUNK]
            plan.update(dict.fromkeys(chunk, chunk))
    return plan


def _depth_chunk(predictor, inp, call, images, members, on_card: bool
                 ) -> Dict[int, tuple]:
    """One chunk's photos as RGB arrays and their uint16 maps, finalized on
    the predictor's device in one forward: input index -> (RGB, map,
    card).  With ``on_card``, card is (the photo on the host, its map on
    the device) for stereo: a uint8 photo's view of the buffer it crossed
    from (pinned on a card), any other photo as it is; else None."""
    with stage("prepare", call):
        rgbs = [to_rgb(images[i]) for i in members]
        # uint8 photos go as they are: the predictor sends their bytes and
        # divides by 255 on its device
        photos = rgbs if all(p.dtype == np.uint8 for p in rgbs) else \
            np.stack(rgbs).astype(np.float32) / 255.0
    h, w = rgbs[0].shape[:2]
    net_w, net_h = _funnel_net_size(inp, w, h)
    sent: Optional[list] = [] if on_card else None
    with _oom_advice(inp), stage("depth_batch", call):
        on_device = predictor.finalized_batch(
            photos, net_w, net_h, clip=inp.clipdepth,
            clip_mode=inp.clipdepth_mode, clip_far=inp.clipdepth_far,
            clip_near=inp.clipdepth_near, keep=sent)
        maps = to_host(on_device)
    # ``sent`` stays empty where the photos crossed as f32
    cards = zip(sent or map(torch.as_tensor, rgbs), on_device) if on_card \
        else [None] * len(rgbs)
    return dict(zip(members, zip(rgbs, maps, cards)))


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
    # a mapping's Marigold knobs (the REST API's options) count as ops,
    # their keys read as GenerationOptions.from_dict reads a field's
    given = {}
    if isinstance(inp, Mapping):
        for k, v in inp.items():
            name = str(getattr(k, "name", k)).lower()
            if name in MARIGOLD_OPS:
                given[name] = v
    inp = GenerationOptions.from_dict(inp if inp is not None else {})
    cache = predictor_cache or _default_cache
    call = new_call()
    ops = {**given, **(ops or {})}
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

    # The raw map goes to the host for depth_prediction and the simple
    # mesh, and Boost makes it there; every other predicted photo's map is
    # finalized on the device with its chunk's, made when the loop first
    # reaches one of its photos and held until each photo is yielded.
    # Stereo takes such a photo's map where it is, on the device (unless
    # rembg masks the host's copy), and its photo from the buffer it
    # crossed from; photo i + 1's stereo is queued before photo i's
    # results are waited for (``pending``).
    raw_to_host = inp.do_output_depth_prediction or inp.gen_simple_mesh or \
        inp.boost
    plan = {} if raw_to_host else _chunk_plan(inputimages, inputdepthmaps)
    on_card = inp.gen_stereo and not inp.gen_rembg
    made: Dict[int, tuple] = {}
    pending: Dict[int, Any] = {}
    inpaint_imgs: List[np.ndarray] = []
    inpaint_depths: List[np.ndarray] = []
    for count, image in enumerate(inputimages):
        depthi = None      # the map the simple mesh is made from
        card = None        # (photo on the host, map on the device)
        if count in plan:
            if count not in made:
                made.update(_depth_chunk(predictor, inp, call, inputimages,
                                         plan[count], on_card))
            img, img_output, card = made.pop(count)
        elif inputdepthmaps[count] is not None:
            img = to_rgb(image)
            h, w = img.shape[:2]
            depthi = ingest_custom_depthmap(inputdepthmaps[count], w, h)
            img_output = _convert_to_i16_host(depthi)
        else:
            with stage("prepare", call):
                img = to_rgb(image)
                net_in = img.astype(np.float32) / 255.0
            h, w = img.shape[:2]
            if inp.boost:
                with _oom_advice(inp):
                    boost = cache.get_boost(
                        inp.model_type, tiling_mode=inp.tiling_mode,
                        **predictor_kw)
                    with stage("boost_estimate", call):
                        raw = boost.estimate(
                            net_in, whole_size_threshold=boost_rmax)
            else:
                with _oom_advice(inp), stage("depth_batch", call):
                    raw = predictor.predict(net_in,
                                            *_funnel_net_size(inp, w, h))
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
            stereo_args = (inp.stereo_divergence, inp.stereo_separation,
                           inp.stereo_modes, inp.stereo_balance,
                           inp.stereo_offset_exponent, inp.stereo_fill_algo)
            with stage("stereo", call):
                if card is None:
                    stereoimages = create_stereoimages(
                        img, img_output, *stereo_args, device=dev)
                else:
                    with stage("stereo_on_card", call):
                        copies = pending.pop(count, None) or \
                            stereoimages_to_host(*card, *stereo_args)
                        ahead = made.get(count + 1)
                        if ahead is not None and ahead[2] is not None:
                            pending[count + 1] = stereoimages_to_host(
                                *ahead[2], *stereo_args)
                        stereoimages = copies.arrays()
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
