"""REST API of the port: the stdlib-http routes of the JAX package's
``frontends/api.py`` (the reference's FastAPI surface,
scripts/depthmap_api.py:43-186) on the port's funnel.

Routes (same paths, status codes and JSON bodies):
 * GET  /depth/version          -> {"version": ...}
 * GET  /depth/get_options      -> {"options": [lowercase option names]}
 * POST /depth/generate         {depth_input_images: [b64], options: {...}}
                                -> {"images": [b64 PNG], "info": "Success"}
 * POST /depth/generate/video   {depth_input_images, options:
                                 {video_parameters: {...}}} -> {"info": ...}

The funnel yields numpy arrays where the JAX funnel yields PIL images;
``encode_array_to_base64`` makes the PNG the JAX route sends for the same
array (a uint16 map as a 16-bit PNG, RGB / RGBA as 8-bit).  Other results
(a raw float map, a mesh's path) are not sent, as in JAX.  One request at
a time: generation serializes on the card anyway.

    python -m depthmap_tpu_torch --serve --port 7860
"""
from __future__ import annotations

import base64
import io
import json
import os
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import List

import numpy as np
from PIL import Image

from depthmap_tpu_torch import __version__
from depthmap_tpu_torch.options import GenerationOptions
from depthmap_tpu_torch.registry import MODELS_BY_NAME, resolve_model_type

SCRIPT_VERSION = f"v0.4.8-torch-{__version__}"


def decode_base64_to_image(encoding: str) -> Image.Image:
    if encoding.startswith("data:image/"):
        encoding = encoding.split(";", 1)[1].split(",", 1)[1]
    return Image.open(io.BytesIO(base64.b64decode(encoding)))


def encode_array_to_base64(arr: np.ndarray) -> str:
    """The PNG of a funnel output, as PIL writes ``Image.fromarray(arr)``:
    uint16 (H, W) as mode I;16, uint8 RGB / RGBA as they are."""
    with io.BytesIO() as buf:
        Image.fromarray(np.asarray(arr)).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()


def is_image_output(result) -> bool:
    """The funnel outputs the JAX funnel yields as PIL images: uint8 and
    uint16 arrays (a raw float map and a path are not)."""
    return isinstance(result, np.ndarray) and \
        result.dtype in (np.uint8, np.uint16)


class ApiError(Exception):
    def __init__(self, status: int, detail):
        super().__init__(str(detail))
        self.status = status
        self.detail = detail


def handle_generate(payload: dict) -> dict:
    from depthmap_tpu_torch.pipeline.core import core_generation_funnel

    images_b64: List[str] = payload.get("depth_input_images", [])
    options = payload.get("options", {}) or {}
    if len(images_b64) == 0:
        raise ApiError(422, "No images supplied")
    pil_images = [decode_base64_to_image(i) for i in images_b64]
    outpath = payload.get("outpath", "./outputs")
    os.makedirs(outpath, exist_ok=True)

    results = []
    for _count, _type, result in core_generation_funnel(
            outpath, pil_images, None, None, options):
        if is_image_output(result):
            results.append(encode_array_to_base64(result))
    return {"images": results, "info": "Success"}


def handle_generate_video(payload: dict) -> dict:
    from depthmap_tpu_torch.pipeline.core import (core_generation_funnel,
                                                  options_device)

    images_b64 = payload.get("depth_input_images", [])
    options = dict(payload.get("options", {}) or {})
    if len(images_b64) == 0:
        raise ApiError(422, "No images supplied")

    model_type = options.get("model_type")
    try:
        options["model_type"] = resolve_model_type(model_type)
    except KeyError:
        raise ApiError(400, {"error": "Invalid model string",
                             "available_models": sorted(MODELS_BY_NAME)})

    video_parameters = options.get("video_parameters")
    if not isinstance(video_parameters, dict):
        raise ApiError(400, {"error": "Missing required parameter(s): "
                                      "video_parameters"})
    required = ["vid_numframes", "vid_fps", "vid_traj", "vid_shift",
                "vid_border", "dolly", "vid_format", "vid_ssaa",
                "output_filename"]
    missing = [p for p in required if p not in video_parameters]
    if missing:
        raise ApiError(400, {"error": "Missing required parameter(s): "
                                      + ", ".join(missing)})

    vp = video_parameters
    output_filename = vp["output_filename"]
    output_path = os.path.dirname(output_filename)
    basename, extension = os.path.splitext(os.path.basename(output_filename))
    if vp["vid_format"] != extension[1:]:
        raise ApiError(400, {"error": f"Video format '{vp['vid_format']}' does"
                                      f" not match with the extension "
                                      f"'{extension}'."})

    pil_images = [decode_base64_to_image(i) for i in images_b64]
    outpath = payload.get("outpath", "./outputs")
    os.makedirs(outpath, exist_ok=True)

    mesh_fi = vp.get("mesh_fi_filename")
    if not (mesh_fi and os.path.exists(mesh_fi)):
        options["GEN_INPAINTED_MESH"] = True
        mesh_fi = None
        for _c, typ, result in core_generation_funnel(
                outpath, pil_images, None, None, options):
            if typ == "inpainted_mesh":
                mesh_fi = result
                break
        if not mesh_fi:
            raise ApiError(400, {"error": "The mesh has not been created"})

    from depthmap_tpu_torch.pipeline.inpaint_video import run_makevideo
    run_makevideo(mesh_fi, vp["vid_numframes"], vp["vid_fps"], vp["vid_traj"],
                  vp["vid_shift"], vp["vid_border"], vp["dolly"],
                  vp["vid_format"], int(vp["vid_ssaa"]), output_path, basename,
                  device=options_device(GenerationOptions.from_dict(options)))
    return {"info": "Success"}


class Handler(BaseHTTPRequestHandler):
    server_version = "depthmap_tpu_torch"

    def _send(self, status: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet
        pass

    def do_GET(self):
        if self.path == "/depth/version":
            self._send(200, {"version": SCRIPT_VERSION})
        elif self.path == "/depth/get_options":
            self._send(200, {"options":
                             sorted(GenerationOptions.field_names())})
        else:
            self._send(404, {"detail": "Not Found"})

    # Largest accepted request body: the server handles one request at a
    # time, so an unbounded Content-Length would let one malformed POST pin
    # it on a multi-GB read.  256 MB covers base64 batches of many 4K
    # frames.
    MAX_BODY_BYTES = 256 << 20

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._send(400, {"detail": "Invalid Content-Length"})
            return
        if length < 0:
            self._send(400, {"detail": "Invalid Content-Length"})
            return
        if length > self.MAX_BODY_BYTES:
            self._send(413, {"detail":
                             f"Request body over {self.MAX_BODY_BYTES} "
                             "bytes"})
            return
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self._send(400, {"detail": "Invalid JSON"})
            return
        try:
            if self.path == "/depth/generate":
                self._send(200, handle_generate(payload))
            elif self.path == "/depth/generate/video":
                self._send(200, handle_generate_video(payload))
            else:
                self._send(404, {"detail": "Not Found"})
        except ApiError as e:
            self._send(e.status, {"detail": e.detail})
        except Exception as e:
            self._send(500, {"detail": f"{type(e).__name__}: {e}"})


def make_server(host: str = "127.0.0.1", port: int = 7860) -> HTTPServer:
    return HTTPServer((host, port), Handler)


def serve(host: str = "127.0.0.1", port: int = 7860):
    # the funnel's imports (torch, the models: seconds on a busy host)
    # before the server listens, so that no request waits for them
    import depthmap_tpu_torch.pipeline.core  # noqa: F401
    srv = make_server(host, port)
    print(f"depthmap_tpu_torch API on http://{host}:{port} "
          f"(DO NOT HOST PUBLICLY)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
