"""Depth prediction engine (torch).

Port of ``depthmap_tpu/pipeline/depth.py``'s DepthPredictor for every
model of the zoo (LeReS, the MiDaS / DPT zoo, ZoeDepth, Marigold, Depth
Anything):
preprocessing, the forward and the upsample back to the input size run on
the predictor's device; ``finalized_batch`` also finalizes to uint16
there, so only the uint16 map goes to the host.  ZoeDepth resizes and
normalizes inside its module and returns the map at the input size; its
relative-depth core runs in ``core_dtype``, its metric head in f32.  What
a backbone computes per grid from its parameters alone (BEiT's
relative-position biases, DINOv2's resized position embeddings) is
computed once per net input size and kept.  A host-pipeline bundle
(Marigold) runs its pipeline per image (``_pipeline_maps``: the resizes to
the processing size and back, cv2's INTER_CUBIC restated, and the
diffusion on the device; an ensemble of more than one member is aligned on
the host) in the pipeline's own dtype; a batch runs serially.
``forward_net`` is the forward on an input already at net size that Boost
calls.

Inputs: a photo, or a same-shape stack or list of them, is (H, W, 3) RGB,
floating in [0, 1] or uint8 in 0-255.  A floating input crosses to the
device as f32; a uint8 one crosses as its bytes (from pinned memory on a
card) and is divided by 255 there (``u8_to_unit``), equal bit for bit to
the host's ``x.astype(np.float32) / 255.0``; a host pipeline's too.

Weights: ``weights_dir``'s checkpoint of the model (Marigold: its
diffusers tree) where it is there, fetched first under
DEPTHMAP_ALLOW_DOWNLOAD=1 (``utils/download.py``), else seeded random
weights.

Device: "cuda" (or a cuda:N) needs CUDA and raises without it; "cpu" runs
everything on the host, attention through K1's plain version.  Devices: a
batch whose size the number of ``devices`` divides (more than one) is
split into that many equal shards, shard i's forward on ``devices[i]``
(a copy of the module there, ``parallel/mesh.py replica``), the maps
gathered in order on the predictor's device, as the JAX package's
``_shard_batch`` puts the frames on the mesh's data axis.  The list
defaults to every visible card for "cuda" and may repeat a device; a
Marigold predictor gives it to its pipeline, which splits the ensemble
members over it.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from depthmap_tpu_torch.device import resolve_device
from depthmap_tpu_torch.models.build import ModelBundle, build_model
from depthmap_tpu_torch.ops import numerics
from depthmap_tpu_torch.ops.resize import cv2_resize_cubic_t, interpolate
from depthmap_tpu_torch.parallel.mesh import (canonical, local_devices,
                                              replica, split_run)
from depthmap_tpu_torch.pipeline.preprocess import preprocess_images
from depthmap_tpu_torch.registry import MODELS, resolve_model_type
from depthmap_tpu_torch.utils.profiling import stage

# Per-model reduced-precision policy of the JAX package (the reference's
# fp16 table): bf16 compute for these types, the final head in f32.
BF16_MODEL_TYPES = frozenset({1, 2, 3, 4, 5, 6, 8, 9, 11, 12, 13, 14})


def to_host(maps: torch.Tensor) -> np.ndarray:
    """Maps on the host, in a ``download`` span: the host waits there for
    the device's queue to finish the forward, then copies."""
    with stage("download"):
        return maps.cpu().numpy()


def u8_to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint8 values -> f32 in [0, 1] on ``x``'s device, equal bit for bit
    to numpy's ``x.astype(np.float32) / 255.0``: a true division by a
    device tensor (a CUDA divide by a host scalar multiplies by the
    reciprocal, which differs on 126 of the 256 values)."""
    return torch.div(x, torch.full((), 255.0, dtype=torch.float32,
                                   device=x.device))


def is_u8(imgs) -> bool:
    """Whether a photo, or every photo of a stack or list, is uint8."""
    arrays = imgs if isinstance(imgs, (list, tuple)) else [imgs]
    return all(np.asarray(a).dtype == np.uint8 for a in arrays)


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
    DEPTHMAP_ZOE_KNK_HEAD_F32=0, which makes the compute dtype bf16 too:
    the image, the pad and the resize into the net run in bf16, while the
    metric head stays in f32 (the predictor runs every module's
    ``head_to_f32()``), unlike the JAX package's whole-model half."""
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
    """One depth model on ``device``, its batches split over
    ``devices``."""

    def __init__(self, model_type, state_dict: Optional[Dict] = None,
                 weights_dir: str = "./models", seed: int = 0,
                 compute_dtype=None, tiling_mode: bool = False,
                 device="cuda", bundle: Optional[ModelBundle] = None,
                 marigold_ensembles: int = 5, marigold_steps: int = 12,
                 devices=None):
        self.device = resolve_device(device)
        if devices is None:   # every card for "cuda", else the one device
            devices = local_devices(self.device) if self.device == \
                torch.device("cuda") else [self.device]
        self.devices = [canonical(resolve_device(d)) for d in devices]
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
        # (device, net input (H, W)) -> the forward inputs of the module
        # (or of its copy) there (grid_inputs)
        self._grid_inputs: Dict[Tuple[torch.device, Tuple[int, int]],
                                Dict[str, Any]] = {}

    # -- inference ---------------------------------------------------------
    def module_on(self, device) -> torch.nn.Module:
        """The module on ``device``: its own, or its copy there."""
        return replica(self.bundle.module, device)

    def grid_inputs(self, input_hw: Tuple[int, int],
                    device=None) -> Dict[str, Any]:
        """The module's keyword inputs for a net input of ``input_hw`` on
        ``device`` (default: the predictor's; what it computes from its
        parameters per grid, in the core's dtype; the conv models have
        none), computed on the first forward at that size and kept."""
        key = (canonical(device or self.device), input_hw)
        if key not in self._grid_inputs:
            self._grid_inputs[key] = self.module_on(key[0]).grid_inputs(
                input_hw, self.core_dtype)
        return self._grid_inputs[key]

    @torch.no_grad()
    def forward_net(self, x: torch.Tensor, out_hw=None,
                    net_size: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
        """The JAX predictor's ``_apply``: x is the NCHW net input on one
        of the devices (already resized and normalized) -> (N, out_h,
        out_w) f32 there, upsampled as the bundle says, by the module's
        copy on x's device.  A ``prep_in_model`` module (ZoeDepth) takes
        the NCHW image in [0, 1] instead, channels in its order, resizes it
        to fit ``net_size`` (h, w) itself and returns the input's size."""
        module = self.module_on(x.device)
        x = x.to(self.compute_dtype)
        if self.bundle.prep_in_model:
            h, w = x.shape[2:]
            input_hw = module.net_input_size(h, w, net_size, module.img_size)
            pred = module(x, net_size=net_size,
                          **self.grid_inputs(input_hw, x.device))
            return pred.to(torch.float32)
        pred = module(x, **self.grid_inputs(tuple(x.shape[2:]), x.device))
        return interpolate(pred[:, None].to(torch.float32), out_hw,
                           self.bundle.upsample_mode,
                           self.bundle.upsample_align_corners)[:, 0]

    def _forward(self, imgs01: torch.Tensor, net_w: int,
                 net_h: int) -> torch.Tensor:
        """(N, H, W, 3) float RGB in [0, 1] on the device -> (N, H, W) f32
        raw prediction at the input size."""
        if self.bundle.prep_in_model:
            x = imgs01.to(torch.float32)
            if self.bundle.preprocess.swap_channels:
                x = x.flip(-1)
            return self.forward_net(x.permute(0, 3, 1, 2).contiguous(),
                                    net_size=(net_h, net_w))
        x = preprocess_images(imgs01, net_w, net_h, self.bundle.preprocess)
        return self.forward_net(x, imgs01.shape[1:3])

    def _pipeline_maps(self, batch: torch.Tensor,
                       net_w: int) -> torch.Tensor:
        """A host pipeline's (Marigold's) (N, H, W) raw maps of an (N, H,
        W, 3) f32 stack on the device, one photo at a time: resized to the
        processing size for ``net_w`` (cv2's INTER_CUBIC restated on the
        device, then clipped to [0, 1]), the pipeline's forward on the
        (1, 3, h', w') net input, its map resized back the same way; both
        resizes in ``marigold_resize`` spans."""
        module = self.bundle.module
        h, w = batch.shape[1:3]
        nh, nw = module.processing_size(h, w, net_w)
        maps = []
        for img in batch:
            with stage("marigold_resize"):
                x = cv2_resize_cubic_t(img.permute(2, 0, 1), (nw, nh))
                x = x.clamp(0.0, 1.0)[None]
            depth = module(x, ensemble_size=self.marigold_ensembles,
                           denoising_steps=self.marigold_steps,
                           devices=self.devices)
            with stage("marigold_resize"):
                maps.append(cv2_resize_cubic_t(depth, (w, h)))
        return torch.cat(maps)

    def _raw_batch(self, imgs01, net_w: int, net_h: int,
                   keep: Optional[list] = None) -> torch.Tensor:
        """(N, H, W) raw maps on the device, the stack split over the
        devices where their number divides it; a host pipeline's one
        photo at a time, its members split over them instead."""
        batch = self._to_device(imgs01, keep)
        with stage("forward"):
            if self.bundle.host_pipeline:
                return self._pipeline_maps(batch, net_w)
            return split_run(lambda x: self._forward(x, net_w, net_h),
                             self.devices, batch)

    def _to_device(self, imgs, keep: Optional[list] = None
                   ) -> torch.Tensor:
        """A same-shape (N, H, W, 3) stack, or a list of (H, W, 3) photos,
        -> (N, H, W, 3) f32 RGB in [0, 1] on the predictor's device.  The
        route follows the dtype: floating input (in [0, 1]) crosses as
        f32; uint8 (0-255) in an ``upload_u8`` span crosses as its bytes,
        on a card copied once into pinned memory and sent without
        blocking, and becomes ``u8_to_unit``'s f32 there, the uint8 copy
        dropped before the forward.  ``keep``, a list, receives each uint8
        photo's host copy (a view of the pinned buffer on a card), for a
        caller that sends the photos again."""
        with stage("upload"):
            if not is_u8(imgs):
                return torch.as_tensor(np.asarray(imgs, np.float32)).to(
                    self.device, non_blocking=True)
            with stage("upload_u8"):
                if self.device.type != "cuda":
                    host = torch.from_numpy(np.array(imgs))
                else:
                    host = torch.empty((len(imgs),) + np.shape(imgs[0]),
                                       dtype=torch.uint8, pin_memory=True)
                    for i, img in enumerate(imgs):
                        # torch's copy runs on its intra-op threads (4x
                        # numpy's one core); a read-only array is copied
                        # first, as torch warns on one
                        host[i].copy_(torch.from_numpy(
                            np.require(img, requirements="W")))
                if keep is not None:
                    keep.extend(host)
                return u8_to_unit(host.to(self.device, non_blocking=True))

    def _default_size(self, net_w, net_h):
        if net_w is None or net_h is None:
            return self.spec.default_net_size
        return net_w, net_h

    def predict(self, img01: np.ndarray, net_w: Optional[int] = None,
                net_h: Optional[int] = None) -> np.ndarray:
        """img01: (H, W, 3) RGB, float in [0, 1] or uint8 -> raw
        prediction (H, W)."""
        net_w, net_h = self._default_size(net_w, net_h)
        return to_host(self._raw_batch(np.asarray(img01)[None], net_w,
                                       net_h)[0])

    def predict_batch(self, imgs01: np.ndarray, net_w: Optional[int] = None,
                      net_h: Optional[int] = None) -> np.ndarray:
        """(N, H, W, 3) same-shape stack (float in [0, 1] or uint8) -> (N,
        H, W) raw predictions, one forward over the batch."""
        net_w, net_h = self._default_size(net_w, net_h)
        return to_host(self._raw_batch(imgs01, net_w, net_h))

    def finalized_batch(self, imgs01, net_w: int, net_h: int, *,
                        clip: bool = False, clip_mode: str = "Range",
                        clip_far: float = 0.0, clip_near: float = 1.0,
                        keep: Optional[list] = None) -> torch.Tensor:
        """A same-shape (N, H, W, 3) stack or list of photos (float in [0,
        1] or uint8) -> (N, H, W) uint16 on the device, one forward, each
        frame finalized against its own range; ``keep`` as
        ``_to_device``'s."""
        raw = self._raw_batch(imgs01, net_w, net_h, keep)
        with stage("finalize"):
            return numerics.finalize_i16(
                raw, invert=self.raw_prediction_invert, clip=bool(clip),
                clip_mode=clip_mode, clip_far=float(clip_far),
                clip_near=float(clip_near))

    def predict_finalized(self, img01: np.ndarray,
                          net_w: Optional[int] = None,
                          net_h: Optional[int] = None, *,
                          clip: bool = False, clip_mode: str = "Range",
                          clip_far: float = 0.0,
                          clip_near: float = 1.0) -> np.ndarray:
        """(H, W, 3) RGB, float in [0, 1] or uint8: forward ->
        finalize_depth -> convert_to_i16 on the device; only the (H, W)
        uint16 map comes back."""
        net_w, net_h = self._default_size(net_w, net_h)
        out = self.finalized_batch(np.asarray(img01)[None], net_w, net_h,
                                   clip=clip, clip_mode=clip_mode,
                                   clip_far=clip_far, clip_near=clip_near)
        return to_host(out[0])

    @property
    def raw_prediction_invert(self) -> bool:
        """True when near objects have *small* raw values."""
        return self.spec.predicts_depth
