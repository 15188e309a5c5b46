"""Depth prediction engine (torch).

Port of ``depthmap_tpu/pipeline/depth.py``'s DepthPredictor for every
model of the zoo (LeReS, the MiDaS / DPT zoo, ZoeDepth, Marigold, Depth
Anything):
preprocessing, the forward and the upsample back to the input size run on
the predictor's device; ``predict_finalized*`` also finalize to uint16
there, so only the uint16 map goes to the host.  ZoeDepth resizes and
normalizes inside its module and returns the map at the input size; its
relative-depth core runs in ``core_dtype``, its metric head in f32.  What
a backbone computes per grid from its parameters alone (BEiT's
relative-position biases, DINOv2's resized position embeddings) is
computed once per net input size and kept.  A host-pipeline bundle
(Marigold) runs its pipeline per image (``_pipeline_raw``: the diffusion
on the device, its resizes and ensemble alignment on the host) in the
pipeline's own dtype; a batch runs serially.  ``forward_net`` is the forward
on an input already at net size that Boost calls.

Weights: ``weights_dir``'s checkpoint of the model (Marigold: its
diffusers tree) where it is there, fetched first under
DEPTHMAP_ALLOW_DOWNLOAD=1 (``utils/download.py``), else seeded random
weights.

Device: "cuda" (or a cuda:N) needs CUDA and raises without it; "cpu" runs
everything on the host, attention through K1's plain version.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from depthmap_tpu_torch.device import resolve_device
from depthmap_tpu_torch.models.build import ModelBundle, build_model
from depthmap_tpu_torch.ops import numerics
from depthmap_tpu_torch.ops.resize import interpolate
from depthmap_tpu_torch.pipeline.preprocess import preprocess_images
from depthmap_tpu_torch.registry import MODELS, resolve_model_type

# Per-model reduced-precision policy of the JAX package (the reference's
# fp16 table): bf16 compute for these types, the final head in f32.
BF16_MODEL_TYPES = frozenset({1, 2, 3, 4, 5, 6, 8, 9, 11, 12, 13, 14})


def set_fp32_precision(dev: torch.device) -> None:
    """Full f32 matmuls and convolutions on the card: cuDNN would run f32
    convolutions in TF32 (about three decimal digits), which bands the
    16-bit depth map that the f32 head exists to keep smooth."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def default_compute_dtype(model_type: int) -> torch.dtype:
    """bf16 for BF16_MODEL_TYPES, else f32; DEPTHMAP_COMPUTE_DTYPE (a
    dtype name, e.g. "float32") overrides it for every model."""
    env = os.environ.get("DEPTHMAP_COMPUTE_DTYPE")
    if env:
        return _dtype(env)
    return torch.bfloat16 if model_type in BF16_MODEL_TYPES else torch.float32


def _dtype(name) -> torch.dtype:
    """A torch dtype from a dtype or its name ("bfloat16", "float32")."""
    return getattr(torch, name) if isinstance(name, str) else name


def precision(model_type: int, compute_dtype=None,
              selective_core: Optional[str] = None
              ) -> Tuple[torch.dtype, torch.dtype]:
    """(compute dtype, core dtype) of a predictor, the JAX package's
    policy: the given ``compute_dtype`` or the default, and the same for
    the core, except under a bundle's ``selective_core`` when neither an
    explicit ``compute_dtype`` (the funnel's no_half) nor
    DEPTHMAP_COMPUTE_DTYPE is given: "zoe_core_env" runs the core in
    DEPTHMAP_ZOE_CORE_DTYPE (bf16 by default) beside the head;
    "knk_head_f32" runs the core in bf16 and the head in f32 unless
    DEPTHMAP_ZOE_KNK_HEAD_F32=0 (then bf16 throughout, the reference's
    whole-model half)."""
    explicit = compute_dtype is not None
    compute = _dtype(compute_dtype) if explicit else \
        default_compute_dtype(model_type)
    core = compute
    if explicit or "DEPTHMAP_COMPUTE_DTYPE" in os.environ:
        return compute, core
    if selective_core == "zoe_core_env":
        core = _dtype(os.environ.get("DEPTHMAP_ZOE_CORE_DTYPE", "bfloat16"))
    elif selective_core == "knk_head_f32" and \
            os.environ.get("DEPTHMAP_ZOE_KNK_HEAD_F32") != "0":
        compute, core = torch.float32, torch.bfloat16
    return compute, core


def _fetch_marigold(weights_dir: str) -> None:
    """Marigold's diffusers tree into ``weights_dir/marigold``; a failed
    fetch prints and the pipeline goes on as it would without the tree,
    as in the JAX predictor."""
    from depthmap_tpu_torch.utils.download import ensure_marigold_downloaded
    try:
        ensure_marigold_downloaded(weights_dir)
    except Exception as e:
        print(f"Marigold download failed ({e})")


class DepthPredictor:
    """One depth model on one device."""

    def __init__(self, model_type, state_dict: Optional[Dict] = None,
                 weights_dir: str = "./models", seed: int = 0,
                 compute_dtype=None, tiling_mode: bool = False,
                 device="cuda", bundle: Optional[ModelBundle] = None,
                 marigold_ensembles: int = 5, marigold_steps: int = 12):
        self.device = resolve_device(device)
        set_fp32_precision(self.device)
        self.model_type = resolve_model_type(model_type)
        self.spec = MODELS[self.model_type]
        self.tiling_mode = tiling_mode
        self.marigold_ensembles = marigold_ensembles
        self.marigold_steps = marigold_steps
        self.bundle = bundle if bundle is not None else \
            build_model(self.model_type)
        module = self.bundle.module
        pipeline = self.bundle.host_pipeline
        if pipeline:   # the pipeline's own dtype, as in the JAX package
            self.compute_dtype = self.core_dtype = module.pipeline_dtype()
        else:
            self.compute_dtype, self.core_dtype = precision(
                self.model_type, compute_dtype, self.bundle.selective_core)
        from depthmap_tpu_torch.models import weights
        download = os.environ.get("DEPTHMAP_ALLOW_DOWNLOAD") == "1"
        if state_dict is not None:
            module.load_state_dict(state_dict, strict=True)
        elif pipeline:
            if download and not os.path.isdir(
                    os.path.join(weights_dir, "marigold")):
                _fetch_marigold(weights_dir)
            module.load_weights(weights_dir, seed)
        else:
            path = weights.find_checkpoint(self.model_type, weights_dir)
            if path is None and download and \
                    self.model_type in weights.CHECKPOINT_FILES:
                from depthmap_tpu_torch.utils.download import \
                    ensure_model_downloaded
                path = ensure_model_downloaded(self.model_type, weights_dir)
            if path is not None:
                weights.load_checkpoint(module, path)
            else:
                weights.init_random_(module, seed)
        if not pipeline:   # as the JAX Marigold's, a pipeline's never tile
            from depthmap_tpu_torch.models.layers import set_tiling_mode
            set_tiling_mode(module, tiling_mode)
        module.to(device=self.device, dtype=self.compute_dtype)
        module.head_to_f32()
        if self.core_dtype != self.compute_dtype:
            module.core_to(self.core_dtype)
        module.eval()
        # net input (H, W) -> the module's forward inputs (grid_inputs)
        self._grid_inputs: Dict[Tuple[int, int], Dict[str, Any]] = {}

    # -- inference ---------------------------------------------------------
    def grid_inputs(self, input_hw: Tuple[int, int]) -> Dict[str, Any]:
        """The module's keyword inputs for a net input of ``input_hw``
        (what it computes from its parameters per grid, in the core's
        dtype; the conv models have none), computed on the first forward
        at that size and kept."""
        if input_hw not in self._grid_inputs:
            self._grid_inputs[input_hw] = self.bundle.module.grid_inputs(
                input_hw, self.core_dtype)
        return self._grid_inputs[input_hw]

    @torch.no_grad()
    def forward_net(self, x: torch.Tensor, out_hw=None,
                    net_size: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
        """The JAX predictor's ``_apply``: x is the NCHW net input on the
        device (already resized and normalized) -> (N, out_h, out_w) f32,
        upsampled as the bundle says.  A ``prep_in_model`` module
        (ZoeDepth) takes the NCHW image in [0, 1] instead, channels in its
        order, resizes it to fit ``net_size`` (h, w) itself and returns the
        input's size."""
        module = self.bundle.module
        x = x.to(self.compute_dtype)
        if self.bundle.prep_in_model:
            h, w = x.shape[2:]
            input_hw = module.net_input_size(h, w, net_size, module.img_size)
            pred = module(x, net_size=net_size, **self.grid_inputs(input_hw))
            return pred.to(torch.float32)
        pred = module(x, **self.grid_inputs(tuple(x.shape[2:])))
        return interpolate(pred[:, None].to(torch.float32), out_hw,
                           self.bundle.upsample_mode,
                           self.bundle.upsample_align_corners)[:, 0]

    def _forward(self, imgs01: torch.Tensor, net_w: int, net_h: int,
                 resize_mode: Optional[str] = None) -> torch.Tensor:
        """(N, H, W, 3) float RGB in [0, 1] on the device -> (N, H, W) f32
        raw prediction at the input size."""
        if self.bundle.prep_in_model:
            x = imgs01.to(torch.float32)
            if self.bundle.preprocess.swap_channels:
                x = x.flip(-1)
            return self.forward_net(x.permute(0, 3, 1, 2).contiguous(),
                                    net_size=(net_h, net_w))
        x = preprocess_images(imgs01, net_w, net_h, self.bundle.preprocess,
                              resize_mode)
        return self.forward_net(x, imgs01.shape[1:3])

    def _pipeline_raw(self, img01: np.ndarray, net_w: int) -> np.ndarray:
        """A host pipeline's (Marigold's) (H, W) raw map of one image: the
        pipeline at processing resolution ``net_w``, resized back
        (INTER_CUBIC)."""
        from depthmap_tpu_torch.ops.resize import cv2_resize_cubic
        img01 = np.asarray(img01, np.float32)
        depth = self.bundle.module(
            img01, processing_res=net_w,
            ensemble_size=self.marigold_ensembles,
            denoising_steps=self.marigold_steps, match_input_res=False)
        return cv2_resize_cubic(depth, (img01.shape[1], img01.shape[0]))

    def _raw_batch(self, imgs01, net_w: int, net_h: int,
                   resize_mode: Optional[str] = None) -> torch.Tensor:
        """(N, H, W) raw maps on the device; a host pipeline one image at
        a time."""
        if self.bundle.host_pipeline:
            return torch.from_numpy(np.stack([
                self._pipeline_raw(f, net_w) for f in np.asarray(imgs01)
            ])).to(self.device)
        return self._forward(self._to_device(imgs01), net_w, net_h,
                             resize_mode)

    def _to_device(self, imgs01) -> torch.Tensor:
        return torch.as_tensor(np.asarray(imgs01, np.float32)).to(
            self.device, non_blocking=True)

    def _default_size(self, net_w, net_h):
        if net_w is None or net_h is None:
            return self.spec.default_net_size
        return net_w, net_h

    def predict(self, img01: np.ndarray, net_w: Optional[int] = None,
                net_h: Optional[int] = None,
                resize_mode: Optional[str] = None) -> np.ndarray:
        """img01: (H, W, 3) float RGB in [0,1] -> raw prediction (H, W)."""
        net_w, net_h = self._default_size(net_w, net_h)
        if self.bundle.host_pipeline:
            return self._pipeline_raw(img01, net_w)
        x = self._to_device(img01)[None]
        return self._forward(x, net_w, net_h, resize_mode)[0].cpu().numpy()

    def predict_batch(self, imgs01: np.ndarray, net_w: Optional[int] = None,
                      net_h: Optional[int] = None,
                      resize_mode: Optional[str] = None) -> np.ndarray:
        """(N, H, W, 3) same-shape stack -> (N, H, W) raw predictions, one
        forward over the batch."""
        net_w, net_h = self._default_size(net_w, net_h)
        return self._raw_batch(imgs01, net_w, net_h,
                               resize_mode).cpu().numpy()

    def predict_batch_stream(self, stacks, net_w: Optional[int] = None,
                             net_h: Optional[int] = None,
                             resize_mode: Optional[str] = None):
        """``predict_batch`` over an iterable of same-shape (N, H, W, 3)
        stacks, yielding each chunk's (N, H, W) f32 maps in order, with one
        chunk in flight: on the card, chunk i + 1's forward is launched
        before chunk i is copied to pinned memory (on a side stream that
        waits on chunk i's event) and waited for.  A host pipeline
        (Marigold) goes chunk by chunk."""
        net_w, net_h = self._default_size(net_w, net_h)
        if self.bundle.host_pipeline or self.device.type != "cuda":
            for stack in stacks:
                yield self.predict_batch(stack, net_w, net_h, resize_mode)
            return
        side = torch.cuda.Stream(self.device)
        pending = None   # (raw maps on the card, their forward's event)
        for stack in stacks:
            raw = self._raw_batch(stack, net_w, net_h, resize_mode)
            done = torch.cuda.Event()
            done.record()
            if pending is not None:
                yield self._download(pending, side)
            pending = (raw, done)
        if pending is not None:
            yield self._download(pending, side)

    @staticmethod
    def _download(pending, side) -> np.ndarray:
        """Copy a chunk's maps to pinned memory on ``side`` once its
        forward's event fires, and wait for the copy."""
        raw, done = pending
        host = torch.empty(raw.shape, dtype=raw.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            side.wait_event(done)
            host.copy_(raw, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        copied.synchronize()
        return host.numpy()

    def finalized_batch(self, imgs01, net_w: int, net_h: int, *,
                        clip: bool = False, clip_mode: str = "Range",
                        clip_far: float = 0.0, clip_near: float = 1.0,
                        resize_mode: Optional[str] = None) -> torch.Tensor:
        """The device half of predict_finalized_batch: (N, H, W) uint16 on
        the device, each frame finalized against its own range."""
        raw = self._raw_batch(imgs01, net_w, net_h, resize_mode)
        return numerics.finalize_i16(raw, invert=self.raw_prediction_invert,
                                     clip=bool(clip), clip_mode=clip_mode,
                                     clip_far=float(clip_far),
                                     clip_near=float(clip_near))

    def predict_finalized(self, img01: np.ndarray,
                          net_w: Optional[int] = None,
                          net_h: Optional[int] = None, *,
                          clip: bool = False, clip_mode: str = "Range",
                          clip_far: float = 0.0, clip_near: float = 1.0,
                          resize_mode: Optional[str] = None) -> np.ndarray:
        """Forward -> finalize_depth -> convert_to_i16 on the device; only
        the (H, W) uint16 map comes back."""
        net_w, net_h = self._default_size(net_w, net_h)
        out = self.finalized_batch(np.asarray(img01)[None], net_w, net_h,
                                   clip=clip, clip_mode=clip_mode,
                                   clip_far=clip_far, clip_near=clip_near,
                                   resize_mode=resize_mode)
        return out[0].cpu().numpy()

    def predict_finalized_batch(self, imgs01: np.ndarray,
                                net_w: Optional[int] = None,
                                net_h: Optional[int] = None, *,
                                clip: bool = False, clip_mode: str = "Range",
                                clip_far: float = 0.0, clip_near: float = 1.0,
                                resize_mode: Optional[str] = None
                                ) -> np.ndarray:
        """(N, H, W, 3) same-shape stack -> (N, H, W) uint16, one forward,
        each frame normalized against its own min/max."""
        net_w, net_h = self._default_size(net_w, net_h)
        return self.finalized_batch(
            imgs01, net_w, net_h, clip=clip, clip_mode=clip_mode,
            clip_far=clip_far, clip_near=clip_near,
            resize_mode=resize_mode).cpu().numpy()

    @property
    def raw_prediction_invert(self) -> bool:
        """True when near objects have *small* raw values."""
        return self.spec.predicts_depth
