"""Video mode: two-pass depth video with temporal consistency (torch).

Port of ``depthmap_tpu/pipeline/video_mode.py``:

* pass 1 (``_predict_video_depths``): the raw, un-normalized prediction of
  every frame.  Frames of one size run as uint8 chunks of ``chunk``
  (the funnel's ``FUNNEL_CHUNK`` by default) through
  ``DepthPredictor.predict_batch``; the last chunk runs as its own
  smaller batch.  Boost, Marigold and frames of mixed sizes go through the
  funnel frame by frame;
* ``process_predictions``: global scaling over the whole video, with the
  optional "experimental" 5-tap temporal smoothing and 0.5 / 99.5
  percentile clamp (numpy, as in the JAX package);
* pass 2: ``core_generation_funnel`` with the processed maps injected, so
  every derived output (stereo, normal map, heatmap) is made per frame;
* ``frames_to_video``: the JAX package's writers.  A uint16 frame list is
  a depth video: FFV1 gray16le through pyav where it imports, else the
  uncompressed Y16 AVI (``io/avi.py``).  Colour frames go through pyav's
  codec chain (png / rawvideo AVI, libx264 mp4, libvpx webm), else a GIF
  through PIL.

Input frames are what PIL opens (``open_path_as_images``); the funnel's
outputs, and so the frames written, are numpy arrays.  PIL and pyav are
imported where they are used.
"""
from __future__ import annotations

import os
import pathlib
from typing import List, Optional, Tuple

import numpy as np

from depthmap_tpu_torch.io.image import get_next_sequence_number
from depthmap_tpu_torch.options import GenerationOptions
from depthmap_tpu_torch.pipeline.core import FUNNEL_CHUNK


def read_depth_video_16(path: str):
    """(fps, [I;16 PIL frames]) of a 16-bit grayscale depth video: the Y16
    AVI this package writes, or an FFV1 gray16le AVI through pyav where it
    imports; None when the file is neither."""
    from PIL import Image

    from depthmap_tpu_torch.io.avi import read_gray16_avi
    raw = read_gray16_avi(path)
    if raw is not None:
        fps, arrs = raw
        return fps, [Image.fromarray(a) for a in arrs]
    try:
        import av
    except ImportError:
        return None
    with av.open(path) as container:
        stream = container.streams.video[0]
        if "gray16" not in str(stream.codec_context.format.name):
            return None
        fps = float(stream.average_rate or 24)
        frames = [Image.fromarray(f.to_ndarray(format="gray16le").astype(
            np.uint16)) for f in container.decode(video=0)]
    return fps, frames


def _remove(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)


def write_depth_video_16(frames: List[np.ndarray], fps: float,
                         out_path: str) -> None:
    """A 16-bit depth video: FFV1 gray16le through pyav where it imports
    and its ffmpeg encodes FFV1, else the uncompressed Y16 AVI
    (``io/avi.py``), which any ffmpeg-based tool plays."""
    from depthmap_tpu_torch.io.avi import write_gray16_avi
    frames = [np.asarray(f, dtype=np.uint16) for f in frames]
    try:
        import av
    except ImportError:
        av = None
    if av is not None:
        from fractions import Fraction
        try:
            with av.open(out_path, "w", format="avi") as container:
                stream = container.add_stream(
                    "ffv1", rate=Fraction(fps).limit_denominator())
                stream.height, stream.width = frames[0].shape
                stream.pix_fmt = "gray16le"
                for f in frames:
                    for pkt in stream.encode(av.VideoFrame.from_ndarray(
                            f, format="gray16le")):
                        container.mux(pkt)
                for pkt in stream.encode():
                    container.mux(pkt)
            return
        except (av.error.FFmpegError, ValueError):
            # this ffmpeg build lacks the encoder: the Y16 AVI below
            _remove(out_path)
    write_gray16_avi(frames, fps, out_path)


def _write_color_video(arrs: List[np.ndarray], fps: float, path: str,
                       name: str, colorvids_bitrate: Optional[int] = None
                       ) -> Optional[str]:
    """The codec priority chain of the JAX package (png / rawvideo AVI ->
    libx264 mp4 -> libvpx webm; smallest first when a bitrate is asked
    for).  Returns the written path, or None without pyav or when no codec
    of the chain encodes."""
    try:
        import av
    except ImportError:
        return None
    from fractions import Fraction
    priority = [("avi", "png"), ("avi", "rawvideo"), ("mp4", "libx264"),
                ("webm", "libvpx")]
    if colorvids_bitrate:
        priority = list(reversed(priority))
    for v_format, codec in priority:
        out = os.path.join(path, f"{name}.{v_format}")
        try:
            with av.open(out, "w", format=v_format) as container:
                stream = container.add_stream(
                    codec, rate=Fraction(fps).limit_denominator())
                stream.height, stream.width = arrs[0].shape[:2]
                stream.pix_fmt = "rgb24" if codec in ("png", "rawvideo") \
                    else "yuv420p"
                if colorvids_bitrate and codec not in ("png", "rawvideo"):
                    stream.bit_rate = int(colorvids_bitrate) * 1000
                for a in arrs:
                    for pkt in stream.encode(
                            av.VideoFrame.from_ndarray(a, format="rgb24")):
                        container.mux(pkt)
                for pkt in stream.encode():
                    container.mux(pkt)
            return out
        except (av.error.FFmpegError, ValueError) as e:
            print(f"{codec} in {v_format}: {e}; trying the next codec")
            _remove(out)
    return None


def open_path_as_images(path: str, maybe_depthvideo: bool = False
                        ) -> Tuple[float, list]:
    """(fps, PIL frames) of a video file, a GIF / webp, a directory of
    frames (24 fps) or one image."""
    from PIL import Image
    p = pathlib.Path(path)
    suffix = p.suffix.lower()
    if suffix == ".avi" and maybe_depthvideo:
        got = read_depth_video_16(path)
        if got is not None:
            return got
    if p.is_dir():
        files = sorted(f for f in p.iterdir()
                       if f.suffix.lower() in (".png", ".jpg", ".jpeg",
                                               ".webp", ".tif", ".tiff"))
        if not files:
            raise FileNotFoundError(f"No frames found in directory {path}")
        return 24.0, [Image.open(str(f)) for f in files]
    if suffix in (".gif", ".webp"):
        frames = []
        img = Image.open(path)
        for i in range(getattr(img, "n_frames", 1)):
            img.seek(i)
            frames.append(img.convert("RGB"))
        duration = img.info.get("duration", 100) or 100
        return 1000 / duration, frames
    if suffix in (".webm", ".mp4", ".avi", ".mts"):
        try:
            import imageio.v3 as iio
            meta = iio.immeta(path, plugin="pyav")
            fps = float(meta.get("fps", 24))
            return fps, [Image.fromarray(f) for f in iio.imiter(path)]
        except ImportError as e:
            raise RuntimeError(
                f"Decoding {suffix} needs imageio with pyav. Extract the "
                "video into a directory of frames and pass the directory "
                "instead.") from e
    return 1, [Image.open(path)]


def frames_to_video(fps: float, frames: List[np.ndarray], path: str,
                    name: str, colorvids_bitrate: Optional[int] = None
                    ) -> List[str]:
    """Encode the frames (numpy arrays, as the funnel yields them) into
    ``path``; returns the written paths.  uint16 frames make a depth video,
    anything else a colour video (alpha dropped, gray expanded)."""
    os.makedirs(path, exist_ok=True)
    if np.asarray(frames[0]).dtype == np.uint16:
        avi_path = os.path.join(path, f"{name}.avi")
        write_depth_video_16(frames, fps, avi_path)
        return [avi_path]

    from depthmap_tpu_torch.pipeline.core import to_rgb
    arrs = [np.ascontiguousarray(to_rgb(f)) for f in frames]
    vid_path = _write_color_video(arrs, fps, path, name, colorvids_bitrate)
    if vid_path is not None:
        return [vid_path]
    # no pyav: a GIF keeps the output viewable everywhere.  Each frame's
    # adaptive palette (what PIL's GIF writer makes of an RGB frame, and
    # most of its time) is made on a thread pool (PIL releases the GIL
    # there); the file is the same byte for byte.
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def to_palette(a):
        return Image.fromarray(a).convert("P",
                                          palette=Image.Palette.ADAPTIVE)
    with ThreadPoolExecutor(min(len(arrs), os.cpu_count() or 1)) as pool:
        pil = list(pool.map(to_palette, arrs))
    gif_path = os.path.join(path, f"{name}.gif")
    pil[0].save(gif_path, save_all=True, append_images=pil[1:],
                duration=max(int(round(1000 / fps)), 1), loop=0)
    return [gif_path]


def process_predictions(predictions: List[np.ndarray],
                        smoothening: str = "none") -> List[np.ndarray]:
    """Global scaling + optional temporal smoothing (the JAX package's,
    numpy)."""
    def global_scaling(objs, a=None, b=None):
        min_value = a if a is not None else min(o.min() for o in objs)
        max_value = b if b is not None else max(o.max() for o in objs)
        return [(o - min_value) / (max_value - min_value) for o in objs]

    if smoothening == "none":
        return global_scaling(predictions)
    if smoothening == "experimental":
        n = len(predictions)
        processed = []
        for i in range(n):
            f = np.zeros_like(predictions[i])
            for u, mul in enumerate([0.10, 0.20, 0.40, 0.20, 0.10]):
                f += mul * predictions[min(max(0, i + u - 2), n - 1)]
            processed.append(f)
        a, b = np.percentile(np.stack(processed), [0.5, 99.5])
        return global_scaling(predictions, a, b)
    return predictions


def _predict_video_depths(input_images, inp, predictor_cache=None,
                          chunk: int = FUNNEL_CHUNK) -> List[np.ndarray]:
    """Pass 1: the raw prediction of every frame.  Frames of one size
    without Boost or a host pipeline (Marigold) run as uint8 chunks of
    ``chunk`` through ``predict_batch``, which divides by 255 on its
    device; otherwise the funnel runs frame by frame with only
    ``depth_prediction`` asked for."""
    from depthmap_tpu_torch.models.build import is_host_pipeline
    from depthmap_tpu_torch.pipeline.core import (_default_cache,
                                                  _funnel_net_size,
                                                  core_generation_funnel,
                                                  options_device, to_rgb)
    inp_ = GenerationOptions.from_dict(inp)
    frames = [to_rgb(im) for im in input_images]
    sizes = {f.shape[:2] for f in frames}
    if len(sizes) == 1 and not inp_.boost and \
            not is_host_pipeline(inp_.model_type):
        cache = predictor_cache or _default_cache
        predictor = cache.get(inp_.model_type, tiling_mode=inp_.tiling_mode,
                              device=options_device(inp_))
        h, w = frames[0].shape[:2]
        net_w, net_h = _funnel_net_size(inp_, w, h)
        preds = np.concatenate([predictor.predict_batch(
            np.stack(frames[s:s + chunk]), net_w, net_h)
            for s in range(0, len(frames), chunk)])
        if predictor.raw_prediction_invert:
            preds = -preds
        return list(preds)

    first_pass = inp_.replace(do_output_depth_prediction=True,
                              do_output_depth=False, gen_stereo=False,
                              gen_normalmap=False, gen_heatmap=False,
                              gen_simple_mesh=False, gen_inpainted_mesh=False)
    gen_obj = core_generation_funnel(None, input_images, None, None,
                                     first_pass,
                                     predictor_cache=predictor_cache)
    return [x[2] for x in gen_obj if x[1] == "depth_prediction"]


def gen_video(video_path: str, outpath: str, inp,
              custom_depthmap: Optional[str] = None,
              colorvids_bitrate: Optional[int] = None,
              smoothening: str = "none",
              predictor_cache=None) -> List[str]:
    """The whole video flow; returns the written video paths, one per
    output type (``depthmap-NNNN-<type>_video``)."""
    from depthmap_tpu_torch.pipeline.core import core_generation_funnel

    inp = GenerationOptions.from_dict(inp)
    if inp.gen_simple_mesh or inp.gen_inpainted_mesh:
        raise ValueError("Creating mesh-videos is not supported. Please "
                         "split video into frames and use batch processing.")

    fps, input_images = open_path_as_images(os.path.abspath(video_path))
    os.makedirs(outpath, exist_ok=True)

    if custom_depthmap is None:
        input_depths = _predict_video_depths(input_images, inp,
                                             predictor_cache)
        input_depths = process_predictions(input_depths, smoothening)
    else:
        _cdm_fps, input_depths = open_path_as_images(
            os.path.abspath(custom_depthmap), maybe_depthvideo=True)
        if len(input_depths) != len(input_images):
            raise ValueError("Custom depthmap video length does not match "
                             "input video length")

    img_results = list(core_generation_funnel(
        None, input_images, input_depths, None, inp,
        predictor_cache=predictor_cache))
    gens = sorted(set(x[1] for x in img_results))

    written = []
    for gen in gens:
        if gen == "depth" and custom_depthmap is not None:
            continue
        imgs = [x[2] for x in img_results if x[1] == gen]
        if not imgs or not isinstance(imgs[0], np.ndarray):
            continue
        seq = get_next_sequence_number(outpath, None)
        written += frames_to_video(fps, imgs, outpath,
                                   f"depthmap-{seq}-{gen}_video",
                                   colorvids_bitrate)
    return written
