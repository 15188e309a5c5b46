"""Marigold's inference: VAE encode -> DDIM denoise -> decode -> ensemble.

Port of ``depthmap_tpu/models/marigold/pipeline.py``.  The RGB latent is
concatenated with the evolving depth latent (the UNet's 8 channels), the
conditioning is the empty prompt's CLIP embedding (a buffer of the
module), the decode's channel mean is clipped to [0, 1], and the ensemble
members (affine-invariant) are aligned by per-member scale and shift
(scipy BFGS) and reduced by their lower median.  The members ride the
batch axis of one denoise.  The weights take the module's dtype (f32 by
default, ``DEPTHMAP_MARIGOLD_DTYPE=bfloat16`` for bf16) and the nets'
inputs are cast to it; the latent state and the scheduler arithmetic stay
f32, with each step's coefficients computed on the host.  In bf16 the VAE
runs in bf16 and the UNet, as the JAX one under flax's dtype promotion,
in f32 on the bf16-rounded weights from its first time-embedding add on
(``unet.py``).  The initial noise comes from a ``torch.Generator`` on the
module's device seeded with ``seed`` (``noise=`` injects it).  The
resizes of the image and of the result are cv2's INTER_CUBIC, restated
(``ops/resize.py``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from depthmap_tpu_torch.models.marigold.ddim import DDIMScheduler
from depthmap_tpu_torch.models.marigold.unet import MarigoldUNet
from depthmap_tpu_torch.models.marigold.vae import VAE_SCALE, AutoencoderKL
from depthmap_tpu_torch.ops.resize import cv2_resize_cubic

CONTEXT_LEN = 77


def marigold_dtype() -> torch.dtype:
    """DEPTHMAP_MARIGOLD_DTYPE (a dtype name), f32 when unset."""
    env = os.environ.get("DEPTHMAP_MARIGOLD_DTYPE")
    return getattr(torch, env) if env else torch.float32


class MarigoldPipeline(nn.Module):
    def __init__(self, vae: Optional[AutoencoderKL] = None,
                 unet: Optional[MarigoldUNet] = None,
                 context_dim: int = 1024):
        super().__init__()
        self.vae = vae if vae is not None else AutoencoderKL()
        self.unet = unet if unet is not None else MarigoldUNet()
        self.register_buffer("empty_text_embed",
                             torch.zeros(1, CONTEXT_LEN, context_dim))
        self.scheduler = DDIMScheduler()

    def head_to_f32(self):
        """The predictor's module interface: one dtype throughout."""
        return self

    @staticmethod
    def pipeline_dtype() -> torch.dtype:
        """The dtype the predictor gives this module's weights."""
        return marigold_dtype()

    def load_weights(self, weights_dir: str, seed: int) -> None:
        """The diffusers tree under ``weights_dir/marigold`` where it is
        complete, else seeded random weights (the empty prompt's embedding
        zeros)."""
        from depthmap_tpu_torch.models import weights
        model_dir = os.path.join(weights_dir, "marigold")
        if os.path.isdir(model_dir):
            try:
                self.load_state_dict(
                    weights.load_marigold_checkpoint(model_dir), strict=True)
                return
            except FileNotFoundError:
                pass
        weights.init_random_(self, seed)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def draw_noise(self, n: int, lh: int, lw: int, seed: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        return torch.randn((n, 4, lh, lw), generator=g, device=self.device,
                           dtype=torch.float32)

    @torch.no_grad()
    def single_infer(self, rgb01: torch.Tensor, denoising_steps: int,
                     noise: torch.Tensor) -> torch.Tensor:
        """rgb01: (N, 3, H, W) in [0, 1] on the module's device, H and W
        multiples of 8; noise: (N, 4, H/8, W/8) f32 -> (N, H, W) depth in
        [0, 1], f32."""
        cdt = self.compute_dtype
        tsteps, coefs = self.scheduler.coefficients(denoising_steps)
        v_pred = self.scheduler.prediction_type == "v_prediction"
        mean = self.vae.encode_mean((rgb01 * 2.0 - 1.0).to(cdt))
        rgb_latent = (mean * VAE_SCALE).to(torch.float32)
        n = rgb_latent.shape[0]
        latent = noise.to(self.device, torch.float32)
        ctx = self.empty_text_embed.to(cdt).expand(n, -1, -1)
        for t, (c0, c1, c2, c3) in zip(tsteps.tolist(), coefs.tolist()):
            unet_in = torch.cat([rgb_latent, latent], 1).to(cdt)
            ts = torch.full((n,), t, dtype=torch.int32, device=self.device)
            out = self.unet(unet_in, ts, ctx).to(torch.float32)
            if v_pred:
                pred_x0 = c0 * latent - c1 * out
                eps = c0 * out + c1 * latent
            else:
                pred_x0 = (latent - c1 * out) / c0
                eps = out
            latent = c2 * pred_x0 + c3 * eps
        depth = self.vae.decode((latent / VAE_SCALE).to(cdt))
        depth = depth.to(torch.float32).mean(1)
        return torch.clamp(depth * 0.5 + 0.5, 0.0, 1.0)

    def forward(self, rgb01: np.ndarray, processing_res: int = 768,
                ensemble_size: int = 5, denoising_steps: int = 12,
                seed: int = 0, match_input_res: bool = False,
                noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """rgb01: (H, W, 3) float in [0, 1] -> (h', w') depth in [0, 1]
        (the input size with ``match_input_res``).  ``noise``: the
        (ensemble, 4, h'/8, w'/8) initial latents, else drawn from
        ``seed``."""
        h, w = rgb01.shape[:2]
        scale = processing_res / max(h, w)
        nh = max(int(round(h * scale / 8)) * 8, 8)
        nw = max(int(round(w * scale / 8)) * 8, 8)
        rgb = cv2_resize_cubic(np.asarray(rgb01, np.float32),
                               (nw, nh)).clip(0, 1)
        x = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)
        batch = x.permute(2, 0, 1)[None].expand(ensemble_size, -1, -1, -1)
        if noise is None:
            noise = self.draw_noise(ensemble_size, nh // 8, nw // 8, seed)
        preds = self.single_infer(batch, denoising_steps,
                                  torch.as_tensor(noise)).cpu().numpy()
        depth = ensemble_depths(preds) if ensemble_size > 1 else preds[0]
        if match_input_res:
            depth = cv2_resize_cubic(depth, (w, h))
        return depth


def _lower_median(arr: np.ndarray, axis: int = 0) -> np.ndarray:
    """torch.median semantics: the lower of the two middle values for even
    counts (np.median averages them)."""
    n = arr.shape[axis]
    return np.take(np.sort(arr, axis=axis), (n - 1) // 2, axis=axis)


def ensemble_depths(preds: np.ndarray) -> np.ndarray:
    """Align affine-invariant predictions by per-member scale / shift, then
    reduce (restated from the JAX package at the settings its pipeline
    uses, numpy + scipy): one joint distance term sqrt(mean over all
    pairs), a near / far [0, 1] anchoring regularizer (0.02), BFGS with at
    most 2 iterations (tol 1e-3), the lower median, a final [0, 1]
    rescale."""
    from scipy.optimize import minimize

    imgs = np.asarray(preds, np.float32)
    n = imgs.shape[0]
    mins = imgs.reshape(n, -1).min(1)
    maxs = imgs.reshape(n, -1).max(1)
    s_init = 1.0 / (maxs - mins)
    t_init = -s_init * mins
    x0 = np.concatenate([s_init, t_init]).astype(np.float64)

    def closure(x):
        x = x.astype(np.float32)
        s, t = x[:n], x[n:]
        arr = imgs * s[:, None, None] + t[:, None, None]
        dists = np.stack([arr[i] - arr[j]
                          for i in range(n) for j in range(i + 1, n)])
        sqrt_dist = np.sqrt(np.mean(dists ** 2))
        pred = _lower_median(arr)
        near_err = np.sqrt((0.0 - pred.min()) ** 2)
        far_err = np.sqrt((1.0 - pred.max()) ** 2)
        return float(sqrt_dist + (near_err + far_err) * 0.02)

    res = minimize(closure, x0, method="BFGS", tol=1e-3,
                   options={"maxiter": 2, "disp": False})
    x = res.x.astype(np.float32)
    s, t = x[:n], x[n:]
    aligned = _lower_median(imgs * s[:, None, None] + t[:, None, None])
    lo, hi = aligned.min(), aligned.max()
    return (aligned - lo) / (hi - lo) if hi > lo else aligned * 0


def build_marigold(base: int = 320, vae_base: int = 128,
                   context_dim: int = 1024,
                   dim_head: int = 64) -> MarigoldPipeline:
    return MarigoldPipeline(AutoencoderKL(base=vae_base),
                            MarigoldUNet(base=base, context_dim=context_dim,
                                         dim_head=dim_head),
                            context_dim)
