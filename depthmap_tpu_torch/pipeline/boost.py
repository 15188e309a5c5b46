"""BoostingMonocularDepth: the multi-resolution merge (torch).

Port of ``depthmap_tpu/pipeline/boost.py``.  The host half is numpy, as in
the JAX package: the R_x search from Sobel gradients and dilations, and the
adaptive patch selection from a gradient integral image, on the restated
cv2 resizes and dilation of ``ops/resize.py`` (they give the JAX package's
R_x, ``patch_scale`` and rect list exactly).  The device half keeps every
intermediate on the predictor's device: the crops (JAX's
``scale_and_translate``, restated in ``ops/resize.py``), the two forwards
of each chunk of patches, both pix2pix merges, the deg-1 polyfit to the
base and the sequential big-to-small mask blend; only the final (H, W) map
goes to the host.  A host pipeline (Marigold) runs per crop.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from depthmap_tpu_torch.ops.filters import gaussian_kernel1d, sobel
from depthmap_tpu_torch.ops.resize import (cv2_dilate, cv2_resize_cubic,
                                           cv2_resize_linear, interpolate,
                                           scale_and_translate)

PIX2PIX_SIZE = 1024
MASK_SIZE = (3000, 3000)

RECEPTIVE_FIELDS = {0: 448, 1: 512, 11: 518, 12: 518, 13: 518, 14: 518}


def receptive_field(model_type: int) -> int:
    return RECEPTIVE_FIELDS.get(model_type, 384)


def rgb2gray(rgb: np.ndarray) -> np.ndarray:
    return np.dot(rgb[..., :3], [0.2989, 0.5870, 0.1140])


def _sobel_grad(gray: np.ndarray) -> np.ndarray:
    """|d/dy| + |d/dx| of cv2.Sobel(gray, CV_64F, ..., ksize=3)."""
    g = torch.from_numpy(np.ascontiguousarray(gray, np.float64))
    return (sobel(g, 0, 1, 3).abs() + sobel(g, 1, 0, 3).abs()).numpy()


def _blur_profile(n: int, lo: int, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur along one axis of a box that is 1 on [lo, n - lo)
    (REFLECT_101 border), f64."""
    box = np.zeros(n)
    box[lo:n - lo] = 1.0
    r = ksize // 2
    padded = np.pad(box, r, mode="reflect")
    return np.correlate(padded, np.asarray(gaussian_kernel1d(ksize, sigma)),
                        mode="valid")


@functools.lru_cache(maxsize=4)
def _mask_profiles(size: Tuple[int, int]):
    sigma = int(size[0] / 16)
    k = int(2 * np.ceil(2 * int(size[0] / 16)) + 1)
    return tuple(_blur_profile(n, int(0.15 * n), k, float(sigma))
                 for n in size)


def generate_mask(size: Tuple[int, int] = MASK_SIZE,
                  device="cpu") -> torch.Tensor:
    """The Gaussian blend mask of the JAX package's ``generate_mask`` (a box
    over the middle 70%, cv2.GaussianBlur with sigma size / 16, min-max
    normalized), (H, W) f32 on ``device``: the box is an outer product, so
    its blur is the outer product of the two blurred 1-D profiles (computed
    in f64 on the host); the product and the normalization run on the
    device."""
    py, px = (torch.from_numpy(p).to(device) for p in _mask_profiles(
        tuple(size)))
    mask = py[:, None] * px[None, :]
    mask = (mask - mask.min()) / (mask.max() - mask.min())
    return mask.to(torch.float32)


def _block_reduce_max(img: np.ndarray, n: int) -> np.ndarray:
    """skimage.measure.block_reduce(img, (n, n), np.max) equivalent."""
    h, w = img.shape
    ph, pw = (-h) % n, (-w) % n
    img = np.pad(img, ((0, ph), (0, pw)), constant_values=0)
    return img.reshape(img.shape[0] // n, n, img.shape[1] // n, n).max((1, 3))


def calculate_processing_res(img: np.ndarray, basesize: int,
                             confidence: float = 0.2,
                             scale_threshold: float = 3,
                             whole_size_threshold: int = 3000):
    """R_x search (reference calculateprocessingres): -> (R_x, patch
    scale)."""
    speed_scale = 32
    image_dim = int(min(img.shape[:2]))
    grad = cv2_resize_linear(_sobel_grad(rgb2gray(img)),
                             (image_dim, image_dim))
    m, big = grad.min(), grad.max()
    middle = m + (0.4 * (big - m))
    grad = np.where(grad < middle, 0.0, 1.0)

    k1 = int(basesize / speed_scale)
    k2 = int(basesize / (4 * speed_scale))
    threshold = min(whole_size_threshold, scale_threshold * max(img.shape[:2]))
    outputsize_scale = basesize / speed_scale
    grad_resized = grad
    for p_size in range(int(basesize / speed_scale),
                        int(threshold / speed_scale),
                        int(basesize / (2 * speed_scale))):
        n = int(np.floor(grad.shape[0] / p_size))
        grad_resized = _block_reduce_max(grad, max(n, 1))
        grad_resized = cv2_resize_linear(grad_resized, (p_size, p_size))
        grad_resized = np.where(grad_resized >= 0.5, 1.0, 0.0)
        dilated = cv2_dilate(grad_resized, k1)
        if (1 - dilated).mean() > confidence:
            break
        outputsize_scale = p_size

    patch_scale = cv2_dilate(grad_resized, k2).mean()
    return int(outputsize_scale * speed_scale), patch_scale


def apply_grid_patch(blsize: int, stride: int, img: np.ndarray) -> List[dict]:
    """Initial patch grid (reference applyGridpatch)."""
    out = []
    for k in range(blsize, img.shape[1] - blsize, stride):
        for j in range(blsize, img.shape[0] - blsize, stride):
            out.append({"rect": [k - blsize, j - blsize, 2 * blsize,
                                 2 * blsize], "size": 2 * blsize})
    return out


def _integral(img: np.ndarray) -> np.ndarray:
    """cv2.integral equivalent: (h+1, w+1) with zero first row/col."""
    out = np.zeros((img.shape[0] + 1, img.shape[1] + 1), np.float64)
    out[1:, 1:] = np.cumsum(np.cumsum(img, axis=0), axis=1)
    return out


def _gf_from_integral(ii: np.ndarray, rect) -> float:
    x1, x2 = rect[1], rect[1] + rect[3]
    y1, y2 = rect[0], rect[0] + rect[2]
    return ii[x2, y2] - ii[x1, y2] - ii[x2, y1] + ii[x1, y1]


def adaptive_selection(ii: np.ndarray, patches: List[dict], gf: float,
                       factor: float) -> List[dict]:
    """Grow patches until their gradient density matches the image's
    (reference adaptiveselection)."""
    out = []
    height, width = ii.shape
    search_step = int(32 / factor)
    for p in patches:
        bbox = list(p["rect"])
        cgf = _gf_from_integral(ii, bbox) / (bbox[2] * bbox[3])
        if cgf >= gf:
            test = bbox.copy()
            while True:
                test[0] -= int(search_step / 2)
                test[1] -= int(search_step / 2)
                test[2] += search_step
                test[3] += search_step
                if test[0] < 0 or test[1] < 0 or \
                        test[1] + test[3] >= height or \
                        test[0] + test[2] >= width:
                    break
                cgf = _gf_from_integral(ii, test) / (test[2] * test[3])
                if cgf < gf:
                    break
                bbox = test.copy()
            out.append({"rect": bbox, "size": bbox[2]})
    return out


def generate_patches(img: np.ndarray, base_size: int,
                     factor: float) -> List[dict]:
    """reference generatepatchs (sorted big -> small)."""
    grad = _sobel_grad(rgb2gray(img))
    threshold = grad[grad > 0].mean() if (grad > 0).any() else 0.0
    grad = np.where(grad < threshold, 0.0, grad)
    gf = grad.sum() / grad.size
    ii = _integral(grad)
    blsize = int(round(base_size / 2))
    stride = int(round(blsize * 0.75))
    patches = apply_grid_patch(blsize, stride, img)
    patches = adaptive_selection(ii, patches, gf, factor)
    return sorted(patches, key=lambda x: x["size"], reverse=True)


def select_whole_size(img: np.ndarray, rf: int,
                      whole_size_threshold: int) -> Tuple[int, float]:
    """(R_x on the receptive-field ladder, patch scale): the search's R_x
    rounded up to a multiple of ``rf`` (which changes outputs; the JAX
    package keeps its compiled programs to a ladder of sizes so), capped at
    the search threshold."""
    h, w = img.shape[:2]
    size, patch_scale = calculate_processing_res(img, rf, 0.2, 3,
                                                 whole_size_threshold)
    size = min(int(-(-size // rf) * rf),
               int(min(whole_size_threshold, 3 * max(h, w))))
    return size, patch_scale


def select_patches(img: np.ndarray, rf: int, whole_size: int,
                   patch_scale: float,
                   whole_size_threshold: int) -> List[Tuple[int, ...]]:
    """The patch rects [x, y, w, h] in image pixels, big to small: chosen
    on the image resized (INTER_CUBIC) to twice R_x over the patch
    factor, scaled back, empty ones dropped."""
    h, w = img.shape[:2]
    factor = max(min(1.0, 4 * patch_scale * whole_size /
                     whole_size_threshold), 0.2)
    if h > w:
        a = 2 * whole_size
        b = round(2 * whole_size * w / h)
    else:
        a = round(2 * whole_size * h / w)
        b = 2 * whole_size
    b = int(round(b / factor))
    a = int(round(a / factor))
    img_big = cv2_resize_cubic(img, (b, a))
    patchset = generate_patches(img_big, rf * 2, factor)
    sy, sx = h / img_big.shape[0], w / img_big.shape[1]
    rects = []
    for p in patchset:
        r = p["rect"]
        rect = (int(round(r[0] * sx)), int(round(r[1] * sy)),
                int(round(r[2] * sx)), int(round(r[3] * sy)))
        if rect[2] > 0 and rect[3] > 0:
            rects.append(rect)
    return rects


# -- the device chain -----------------------------------------------------
# Each resample's inverse scale and shift are computed in numpy f32 as the
# JAX package's jitted programs compute them (XLA folds 1 / (c / v) into
# v * (1 / c) and keeps c / v a division).

_F32 = np.float32


def _crop_params(rects: np.ndarray, out_h: int, out_w: int):
    r = np.asarray(rects, np.int32).astype(_F32)
    out = np.asarray([out_h, out_w], _F32)
    m = np.maximum(r[:, [3, 2]], _F32(1))                 # (h, w)
    inv = m * (_F32(1) / out)
    shift = (-r[:, [1, 0]] * (out / m)) * inv
    return inv, shift


def crop_resize_batch(src: torch.Tensor, rects: np.ndarray, out_h: int,
                      out_w: int, method: str = "cubic") -> torch.Tensor:
    """Crop each rect [x, y, w, h] of ``src`` (H, W[, C]) and resize it to
    (out_h, out_w) with JAX's resampler (which samples real neighbours
    across the crop's border): -> (n, out_h, out_w[, C]) f32."""
    inv, shift = _crop_params(rects, out_h, out_w)
    dev = src.device
    chw = src if src.dim() == 2 else src.permute(2, 0, 1)
    out = scale_and_translate(chw, (out_h, out_w),
                              torch.from_numpy(inv).to(dev),
                              torch.from_numpy(shift).to(dev), method)
    return out if src.dim() == 2 else out.permute(0, 2, 3, 1)


def minmax_norm_batch(x: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max normalize (reference doubleestimate)."""
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    return torch.where(hi > lo, (x - lo) / span, torch.zeros_like(x))


def fit_to_base(mapped: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Closed-form deg-1 polyfit of mapped -> base applied to mapped,
    batched over patches."""
    mm = mapped.mean(dim=(1, 2), keepdim=True)
    bm = base.mean(dim=(1, 2), keepdim=True)
    cov = (mapped * base).mean(dim=(1, 2), keepdim=True) - mm * bm
    var = (mapped * mapped).mean(dim=(1, 2), keepdim=True) - mm * mm
    slope = torch.where(var > 1e-12, cov / torch.clamp(var, min=1e-12),
                        torch.zeros_like(var))
    return slope * mapped + (bm - slope * mm)


def upsample_p(x: torch.Tensor) -> torch.Tensor:
    """(c, h, w) estimates -> (c, P, P), torch's bicubic."""
    return interpolate(x[:, None], (PIX2PIX_SIZE, PIX2PIX_SIZE), "bicubic",
                       False)[:, 0]


def to_frame(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(P, P) whole estimate -> (h, w) merge frame."""
    return interpolate(x[None, None], (h, w), "bicubic", False)[0, 0]


def _place_params(rect, p: int, mask_hw):
    """The inverse scales and shifts that place a (p, p) patch and the
    (mh, mw) mask at ``rect`` of the frame."""
    x, y, w, h = (_F32(v) for v in rect)
    mh, mw = (_F32(v) for v in mask_hw)
    hw = np.asarray([h, w], _F32)
    inv_p = _F32(1) / (hw * (_F32(1) / _F32(p)))
    inv_m = _F32(1) / (hw * (_F32(1) / np.asarray([mh, mw], _F32)))
    yx = np.asarray([y, x], _F32)
    return inv_p, yx * inv_p, inv_m, yx * inv_m


def blend_patches(updated: torch.Tensor, merged: torch.Tensor,
                  rects: np.ndarray, mask_src: torch.Tensor) -> torch.Tensor:
    """Sequential big -> small Gaussian-mask blend (reference :907-941).
    merged: (N, P, P) polyfit-mapped patch estimates; rects: (N, 4) [x, y,
    w, h] on the host, zero-size rows no-ops.  Each step places the patch
    (cubic) and the mask (linear) at its rect in the frame and
    alpha-blends."""
    h_frame, w_frame = updated.shape
    dev = updated.device
    rows = torch.arange(h_frame, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(w_frame, dtype=torch.float32, device=dev)[None, :]
    p = merged.shape[1]
    for i, rect in enumerate(np.asarray(rects)):
        x, y, w, h = (int(v) for v in rect)
        if w <= 0 or h <= 0:
            continue
        inv_p, sh_p, inv_m, sh_m = (torch.from_numpy(a[None]).to(dev) for a
                                    in _place_params(rect, p, mask_src.shape))
        merged_f = scale_and_translate(merged[i], (h_frame, w_frame), inv_p,
                                       sh_p, "cubic")[0]
        mask_f = scale_and_translate(mask_src, (h_frame, w_frame), inv_m,
                                     sh_m, "linear")[0]
        inside = (rows >= y) & (rows < y + h) & (cols >= x) & (cols < x + w)
        mask_f = torch.where(inside, mask_f, torch.zeros_like(mask_f))
        updated = updated * (1.0 - mask_f) + merged_f * mask_f
    return updated


class BoostEngine:
    """The Boost merge around a DepthPredictor and the pix2pix merge net,
    on the predictor's device."""

    def __init__(self, predictor, merge_net: Optional[torch.nn.Module] = None,
                 seed: int = 0, merge_batch: int = 4):
        from depthmap_tpu_torch.models.pix2pix import build_pix2pix
        from depthmap_tpu_torch.models.weights import init_random_
        self.predictor = predictor
        self.device = predictor.device
        self.rf = receptive_field(predictor.model_type)
        self.merge_batch = merge_batch
        if merge_net is None:
            merge_net = init_random_(build_pix2pix(), seed)
        self.merge_net = merge_net.to(self.device, torch.float32).eval()
        bundle = predictor.bundle
        self.boost_cfg = bundle.boost_preprocess or bundle.preprocess
        self._mask = None      # the 3000^2 blend mask, built on first use
        self.last_run = {}     # R_x, patches and chunks of the last image

    @torch.no_grad()
    def merge(self, outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
        return self.merge_net(outer, inner)

    def _upsample_to_p(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[-2:]) == (PIX2PIX_SIZE, PIX2PIX_SIZE):
            return x
        return upsample_p(x)

    def single_estimate(self, imgs: torch.Tensor,
                        msize: int) -> torch.Tensor:
        """The reference singleestimate: (c, h, w, 3) device RGB in [0, 1]
        (a whole image, or crops already at s = msize) -> (c, P, P)
        estimates at net size ``msize``, through the model's route: a host
        pipeline (Marigold) image by image, a ``prep_in_model`` module
        (ZoeDepth) on the image as it is, any other net on the image
        resized and normalized by ``boost_cfg``."""
        pred = self.predictor
        bundle = pred.bundle
        if bundle.host_pipeline:
            outs = [pred.predict(img, msize, msize)
                    for img in imgs.cpu().numpy()]
            out = torch.from_numpy(np.stack(outs)).to(self.device)
        elif bundle.prep_in_model:
            x = imgs.flip(-1) if bundle.preprocess.swap_channels else imgs
            out = pred.forward_net(x.permute(0, 3, 1, 2).contiguous(),
                                   net_size=(msize, msize))
        else:
            from depthmap_tpu_torch.pipeline.preprocess import \
                preprocess_images
            x = preprocess_images(imgs, msize, msize, self.boost_cfg)
            out = pred.forward_net(x, (PIX2PIX_SIZE, PIX2PIX_SIZE))
        return self._upsample_to_p(out)

    @torch.no_grad()
    def _double_estimate_dev(self, img_dev: torch.Tensor, size1: int,
                             size2: int) -> torch.Tensor:
        """doubleestimate: the estimates at two net sizes merged, min-max
        normalized, (P, P) on the device."""
        e1 = self.single_estimate(img_dev[None], size1)
        e2 = self.single_estimate(img_dev[None], size2)
        return minmax_norm_batch(self.merge(e1, e2))[0]

    def _upload(self, img: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
            self.device)

    def double_estimate(self, img: np.ndarray, size1: int,
                        size2: int) -> np.ndarray:
        """Host API of ``_double_estimate_dev``: (H, W, 3) in [0, 1] ->
        (P, P) numpy."""
        return self._double_estimate_dev(self._upload(img), size1,
                                         size2).cpu().numpy()

    @torch.no_grad()
    def estimate(self, img: np.ndarray,
                 whole_size_threshold: int = 1600) -> np.ndarray:
        """img: (H, W, 3) float RGB in [0, 1] -> boosted depth (H, W)."""
        rf = self.rf
        h, w = img.shape[:2]
        img = np.asarray(img, np.float32)
        whole_size, patch_scale = select_whole_size(img, rf,
                                                    whole_size_threshold)
        img_dev = self._upload(img)
        whole = self._double_estimate_dev(img_dev, rf, whole_size)
        updated = to_frame(whole, h, w)
        rects = select_patches(img, rf, whole_size, patch_scale,
                               whole_size_threshold)
        self.last_run = {"whole_size": whole_size, "patches": len(rects),
                         "chunks": -(-len(rects) // self.merge_batch)}
        if not rects:
            return updated.cpu().numpy()

        # each chunk of patches: cropped at both net sizes, estimated,
        # merged twice and fitted to the base in batched device calls; the
        # ragged tail padded to the full chunk
        mb = self.merge_batch
        n_pad = -(-len(rects) // mb) * mb
        rects_arr = np.zeros((n_pad, 4), np.int32)
        rects_arr[:len(rects)] = np.asarray(rects, np.int32)
        merged = []
        for i in range(0, n_pad, mb):
            rc = rects_arr[i:i + mb]
            lows = self.single_estimate(
                crop_resize_batch(img_dev, rc, rf, rf), rf)
            highs = self.single_estimate(
                crop_resize_batch(img_dev, rc, 2 * rf, 2 * rf), 2 * rf)
            m1 = minmax_norm_batch(self.merge(lows, highs))
            base = crop_resize_batch(updated, rc, PIX2PIX_SIZE, PIX2PIX_SIZE)
            merged.append(fit_to_base(self.merge(base, m1), base))
        if self._mask is None:
            self._mask = generate_mask(MASK_SIZE, self.device)
        updated = blend_patches(updated, torch.cat(merged), rects_arr,
                                self._mask)
        return updated.cpu().numpy()
