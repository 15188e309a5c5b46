"""Depth prediction engine (torch).

Port of ``depthmap_tpu/pipeline/depth.py``'s DepthPredictor for the BEiT
DPT and Depth Anything models: preprocessing, the forward and the upsample
back to the input size run on the predictor's device;
``predict_finalized*`` also finalize to uint16 there, so only the uint16
map goes to the host.  What a backbone computes per grid from its
parameters alone (BEiT's relative-position biases, DINOv2's resized
position embeddings) is computed once per grid and kept.

Device: "cuda" (or a cuda:N) needs CUDA and raises without it; "cpu" runs
everything on the host, attention through K1's plain version.
"""
from __future__ import annotations

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
    return torch.bfloat16 if model_type in BF16_MODEL_TYPES else torch.float32


class DepthPredictor:
    """One depth model on one device."""

    def __init__(self, model_type, state_dict: Optional[Dict] = None,
                 weights_dir: str = "./models", seed: int = 0,
                 compute_dtype=None, tiling_mode: bool = False,
                 device="cuda", bundle: Optional[ModelBundle] = None):
        self.device = resolve_device(device)
        set_fp32_precision(self.device)
        self.model_type = resolve_model_type(model_type)
        self.spec = MODELS[self.model_type]
        self.tiling_mode = tiling_mode
        self.bundle = bundle if bundle is not None else \
            build_model(self.model_type)
        if compute_dtype is None:
            compute_dtype = default_compute_dtype(self.model_type)
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        self.compute_dtype = compute_dtype
        module = self.bundle.module
        from depthmap_tpu_torch.models import weights
        if state_dict is not None:
            module.load_state_dict(state_dict, strict=True)
        else:
            path = weights.find_checkpoint(self.model_type, weights_dir)
            if path is not None:
                weights.load_checkpoint(module, path)
            else:
                weights.init_random_(module, seed)
        from depthmap_tpu_torch.models.layers import set_tiling_mode
        set_tiling_mode(module, tiling_mode)
        module.to(device=self.device, dtype=self.compute_dtype)
        module.head_to_f32()
        module.eval()
        # net input (H, W) -> the module's forward inputs (grid_inputs)
        self._grid_inputs: Dict[Tuple[int, int], Dict[str, Any]] = {}

    # -- inference ---------------------------------------------------------
    def grid_inputs(self, input_hw: Tuple[int, int]) -> Dict[str, Any]:
        """The module's keyword inputs for a net input of ``input_hw``
        (what it computes from its parameters per grid; the conv models
        have none), computed on the first forward at that size and
        kept."""
        if input_hw not in self._grid_inputs:
            self._grid_inputs[input_hw] = self.bundle.module.grid_inputs(
                input_hw, self.compute_dtype)
        return self._grid_inputs[input_hw]

    @torch.no_grad()
    def _forward(self, imgs01: torch.Tensor, net_w: int, net_h: int,
                 resize_mode: Optional[str] = None) -> torch.Tensor:
        """(N, H, W, 3) float RGB in [0, 1] on the device -> (N, H, W) f32
        raw prediction at the input size."""
        x = preprocess_images(imgs01, net_w, net_h, self.bundle.preprocess,
                              resize_mode)
        pred = self.bundle.module(x.to(self.compute_dtype),
                                  **self.grid_inputs(tuple(x.shape[2:])))
        pred = pred[:, None].to(torch.float32)
        out_h, out_w = imgs01.shape[1:3]
        return interpolate(pred, (out_h, out_w), self.bundle.upsample_mode,
                           self.bundle.upsample_align_corners)[:, 0]

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
        x = self._to_device(img01)[None]
        return self._forward(x, net_w, net_h, resize_mode)[0].cpu().numpy()

    def predict_batch(self, imgs01: np.ndarray, net_w: Optional[int] = None,
                      net_h: Optional[int] = None,
                      resize_mode: Optional[str] = None) -> np.ndarray:
        """(N, H, W, 3) same-shape stack -> (N, H, W) raw predictions, one
        forward over the batch."""
        net_w, net_h = self._default_size(net_w, net_h)
        x = self._to_device(imgs01)
        return self._forward(x, net_w, net_h, resize_mode).cpu().numpy()

    def finalized_batch(self, imgs01, net_w: int, net_h: int, *,
                        clip: bool = False, clip_mode: str = "Range",
                        clip_far: float = 0.0, clip_near: float = 1.0,
                        resize_mode: Optional[str] = None) -> torch.Tensor:
        """The device half of predict_finalized_batch: (N, H, W) uint16 on
        the device, each frame finalized against its own range."""
        raw = self._forward(self._to_device(imgs01), net_w, net_h,
                            resize_mode)
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
