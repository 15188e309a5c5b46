"""Marigold v1-0 (prs-eth/marigold-v1-0, arXiv:2312.02145) in plain
PyTorch, at ensemble size 1.

Written from the published pipeline and diffusers' SD2 modules: the photo
in [0, 1], resized so that its longer side is the processing resolution,
scaled to [-1, 1] and encoded by the SD VAE (the latent mean, times
0.18215); a DDIM loop (SD2's scaled-linear betas 0.00085 -> 0.012 over
1000 steps, "leading" spacing, ``steps_offset`` 1, ``set_alpha_to_one``
False, v-prediction) over a UNet2DConditionModel whose 8 input channels
are the RGB latent and the noisy depth latent, conditioned on the empty
prompt's embedding; the last latent decoded, its channel mean mapped by
clamp(d * 0.5 + 0.5, 0, 1) and resized back to the photo.

UNet (SD2): conv_in, the sinusoidal time embedding (cos before sin) and
its two linears with SiLU; ResnetBlock2D (GroupNorm 32, eps 1e-5, SiLU,
3x3 conv, the time embedding's projection added, GroupNorm, SiLU, 3x3
conv, a 1x1 shortcut where the width changes); Transformer2DModel with
linear ``proj_in`` / ``proj_out`` (GroupNorm eps 1e-6) around one
BasicTransformerBlock (LayerNorm eps 1e-5; self-attention, cross-attention
on the 77 context rows, bias-free q / k / v and a biased output; a GEGLU
feed-forward with the exact GELU); three cross-attention down levels and a
plain one, each two ResBlocks and a stride-2 convolution but the last;
the mid block (ResBlock, transformer, ResBlock); the mirrored up path of
three ResBlocks a level on the concatenated skips, each level but the
last upsampled to the next skip's size and convolved; GroupNorm, SiLU,
conv_out.  VAE (SD): ResnetBlocks with GroupNorm 32, eps 1e-6; the
encoder's down path (two blocks a level, a stride-2 convolution after a
(0, 1) pad), the mid block with one attention head over every position,
conv_out to 8 channels and ``quant_conv``; the decoder's
``post_quant_conv``, mid block and up path (three blocks a level, a
nearest 2x upsample and a convolution).  Every product goes through
``Numerics``; the attention's scores are f32.

Departures from the published pipeline, each the program's:
- the processing size is rounded to multiples of 8 on both sides (the
  configuration's ``preprocess``), and the photo is resized with cv2's
  INTER_CUBIC rule, stated here as torch's bicubic (a = -0.75,
  align_corners=False, the rule both share), and clipped to [0, 1]; the
  map comes back the same way;
- the UNet's upsample to a skip size that is not twice its input (14 ->
  27 rows at a latent of 54) takes the half-pixel nearest rule
  (``nearest-exact``) where diffusers' ``nearest`` takes the floor;
- the empty prompt's embedding is the weights' ``empty_text_embed``, and
  zeros where the weights hold none (the seeded weights have no text
  encoder);
- one member, so no ensemble alignment; the noise is ``torch.randn`` of a
  generator on the device seeded with 0.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import common

VAE_SCALE = 0.18215
CONTEXT_LEN = 77


def group_norm(x, w, b, eps: float, groups: int = 32):
    n = x.shape[0]
    g = x.reshape(n, groups, -1)
    mu = g.mean(-1, keepdim=True)
    var = ((g - mu) ** 2).mean(-1, keepdim=True)
    g = (g - mu) / torch.sqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return g.reshape(x.shape) * w.view(shape) + b.view(shape)


def ddim_schedule(cfg: dict, steps: int):
    """[(timestep, [sqrt(a_t), sqrt(1 - a_t), sqrt(a_prev),
    sqrt(1 - a_prev)])] in f64, rounded to f32 as the step's factors."""
    s = cfg["scheduler"]
    n = s["num_train_timesteps"]
    betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5,
                        n) ** 2
    cum = np.cumprod(1.0 - betas)
    final = 1.0 if s["set_alpha_to_one"] else cum[0]
    stride = n // steps
    out = []
    for t in (np.arange(steps) * stride)[::-1] + s["steps_offset"]:
        a_t = cum[t]
        a_prev = cum[t - stride] if t - stride >= 0 else final
        coefs = np.float32([np.sqrt(a_t), np.sqrt(1 - a_t),
                            np.sqrt(a_prev), np.sqrt(1 - a_prev)])
        out.append((int(t), [float(c) for c in coefs]))
    return out


class Marigold:
    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 numerics: common.Numerics):
        self.cfg = cfg
        self.w = weights
        self.nx = numerics
        self.dev = weights["unet.conv_in.weight"].device
        u = cfg["unet"]
        self.ctx = weights.get("empty_text_embed")
        if self.ctx is None:
            self.ctx = torch.zeros(1, CONTEXT_LEN, u["cross_attention_dim"],
                                   device=self.dev)

    # -- shared pieces -----------------------------------------------------
    def conv(self, name, x, stride=1, padding=1):
        return self.nx.conv(x, self.w[name + ".weight"],
                            self.w[name + ".bias"], stride=stride,
                            padding=padding)

    def linear(self, name, x, bias=True):
        return self.nx.linear(x, self.w[name + ".weight"],
                              self.w[name + ".bias"] if bias else None)

    def norm(self, name, x, eps):
        return group_norm(x, self.w[name + ".weight"], self.w[name + ".bias"],
                          eps)

    def resnet(self, p, x, eps, temb=None):
        h = self.conv(p + "conv1", F.silu(self.norm(p + "norm1", x, eps)))
        if temb is not None:
            h = h + self.linear(p + "time_emb_proj",
                                F.silu(temb))[:, :, None, None]
        h = self.conv(p + "conv2", F.silu(self.norm(p + "norm2", h, eps)))
        if p + "conv_shortcut.weight" in self.w:
            x = self.conv(p + "conv_shortcut", x, padding=0)
        return x + h

    # -- the UNet ---------------------------------------------------------
    def attention(self, p, x, context, heads):
        b, n, c = x.shape
        d = c // heads

        def split(t):
            return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)
        q = split(self.linear(p + "to_q", x, bias=False))
        k = split(self.linear(p + "to_k", context, bias=False))
        v = split(self.linear(p + "to_v", context, bias=False))
        o = self.nx.attention(q, k, v)
        return self.linear(p + "to_out.0", o.transpose(1, 2).reshape(b, n, c))

    def transformer(self, p, x, context):
        u = self.cfg["unet"]
        n, c, h, w = x.shape
        heads = c // u["attention_head_dim"]
        y = self.norm(p + "norm", x, u["transformer_norm_eps"])
        y = self.linear(p + "proj_in", y.flatten(2).transpose(1, 2))
        b = p + "transformer_blocks.0."
        eps = u["layer_norm_eps"]

        def ln(name, t):
            return common.layer_norm(t, self.w[b + name + ".weight"],
                                     self.w[b + name + ".bias"], eps)
        h1 = ln("norm1", y)
        y = y + self.attention(b + "attn1.", h1, h1, heads)
        y = y + self.attention(b + "attn2.", ln("norm2", y), context, heads)
        hid, gate = self.linear(b + "ff.net.0.proj", ln("norm3", y)).chunk(
            2, dim=-1)
        y = y + self.linear(b + "ff.net.2", hid * common.gelu(gate))
        y = self.linear(p + "proj_out", y)
        return x + y.transpose(1, 2).reshape(n, c, h, w)

    def time_embedding(self, t: int, n: int):
        dim = self.cfg["unet"]["block_out_channels"][0]
        half = dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(
            half, dtype=torch.float32, device=self.dev) / half)
        args = torch.full((n, 1), float(t), device=self.dev) * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], -1)
        emb = F.silu(self.linear("unet.time_embedding.linear_1", emb))
        return self.linear("unet.time_embedding.linear_2", emb)

    def unet(self, x, t: int, context):
        u = self.cfg["unet"]
        eps = u["norm_eps"]
        levels = len(u["block_out_channels"])
        temb = self.time_embedding(t, x.shape[0])
        h = self.conv("unet.conv_in", x)
        skips = [h]
        for i in range(levels):
            p = f"unet.down_blocks.{i}."
            for j in range(u["layers_per_block"]):
                h = self.resnet(f"{p}resnets.{j}.", h, eps, temb)
                if i < levels - 1:
                    h = self.transformer(f"{p}attentions.{j}.", h, context)
                skips.append(h)
            if i < levels - 1:
                h = self.conv(p + "downsamplers.0.conv", h, stride=2)
                skips.append(h)
        h = self.resnet("unet.mid_block.resnets.0.", h, eps, temb)
        h = self.transformer("unet.mid_block.attentions.0.", h, context)
        h = self.resnet("unet.mid_block.resnets.1.", h, eps, temb)
        for k in range(levels):
            p = f"unet.up_blocks.{k}."
            for j in range(u["layers_per_block"] + 1):
                h = self.resnet(f"{p}resnets.{j}.",
                                torch.cat([h, skips.pop()], 1), eps, temb)
                if k > 0:
                    h = self.transformer(f"{p}attentions.{j}.", h, context)
            if k < levels - 1:
                h = F.interpolate(h, size=tuple(skips[-1].shape[2:]),
                                  mode="nearest-exact")
                h = self.conv(p + "upsamplers.0.conv", h)
        h = F.silu(self.norm("unet.conv_norm_out", h, eps))
        return self.conv("unet.conv_out", h)

    # -- the VAE ----------------------------------------------------------
    def vae_attention(self, p, x):
        eps = self.cfg["vae"]["norm_eps"]
        n, c, h, w = x.shape
        y = self.norm(p + "group_norm", x, eps).flatten(2).transpose(1, 2)
        q, k, v = (self.linear(p + name, y)[:, None]
                   for name in ("to_q", "to_k", "to_v"))
        o = self.nx.attention(q, k, v)[:, 0]
        o = self.linear(p + "to_out.0", o)
        return x + o.transpose(1, 2).reshape(n, c, h, w)

    def vae_mid(self, p, h):
        eps = self.cfg["vae"]["norm_eps"]
        h = self.resnet(p + "resnets.0.", h, eps)
        h = self.vae_attention(p + "attentions.0.", h)
        return self.resnet(p + "resnets.1.", h, eps)

    def encode_mean(self, x):
        v = self.cfg["vae"]
        eps = v["norm_eps"]
        levels = len(v["block_out_channels"])
        h = self.conv("vae.encoder.conv_in", x)
        for i in range(levels):
            p = f"vae.encoder.down_blocks.{i}."
            for j in range(v["layers_per_block"]):
                h = self.resnet(f"{p}resnets.{j}.", h, eps)
            if i < levels - 1:
                h = self.conv(p + "downsamplers.0.conv",
                              F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
        h = self.vae_mid("vae.encoder.mid_block.", h)
        h = F.silu(self.norm("vae.encoder.conv_norm_out", h, eps))
        h = self.conv("vae.encoder.conv_out", h)
        h = self.conv("vae.quant_conv", h, padding=0)
        return h[:, :v["latent_channels"]]

    def decode(self, z):
        v = self.cfg["vae"]
        eps = v["norm_eps"]
        levels = len(v["block_out_channels"])
        h = self.conv("vae.post_quant_conv", z, padding=0)
        h = self.vae_mid("vae.decoder.mid_block.",
                         self.conv("vae.decoder.conv_in", h))
        for k in range(levels):
            p = f"vae.decoder.up_blocks.{k}."
            for j in range(v["layers_per_block"] + 1):
                h = self.resnet(f"{p}resnets.{j}.", h, eps)
            if k < levels - 1:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = self.conv(p + "upsamplers.0.conv", h)
        h = F.silu(self.norm("vae.decoder.conv_norm_out", h, eps))
        return self.conv("vae.decoder.conv_out", h)

    # -- the pipeline -----------------------------------------------------
    def depth(self, rgb01: torch.Tensor) -> torch.Tensor:
        """(1, 3, h, w) in [0, 1] at the processing size -> (h, w) depth
        in [0, 1]."""
        cfg = self.cfg
        rgb_latent = self.encode_mean(rgb01 * 2.0 - 1.0) * VAE_SCALE
        lh, lw = rgb_latent.shape[2:]
        gen = torch.Generator(device=self.dev).manual_seed(0)
        latent = torch.randn((1, 4, lh, lw), generator=gen, device=self.dev,
                             dtype=torch.float32)
        for t, (c0, c1, c2, c3) in ddim_schedule(cfg,
                                                 cfg["denoising_steps"]):
            v = self.unet(torch.cat([rgb_latent, latent], 1), t, self.ctx)
            pred_x0 = c0 * latent - c1 * v
            eps = c0 * v + c1 * latent
            latent = c2 * pred_x0 + c3 * eps
        d = self.decode(latent / VAE_SCALE).mean(1)[0]
        return torch.clamp(d * 0.5 + 0.5, 0.0, 1.0)

    @torch.no_grad()
    def raw(self, img_u8: np.ndarray, net_hw: Tuple[int, int]
            ) -> torch.Tensor:
        """(H, W, 3) uint8 photo -> (H, W) f32 depth map at its size."""
        if self.cfg["ensemble_size"] != 1:
            raise ValueError("the reference runs one member")
        x = torch.as_tensor(img_u8, device=self.dev).to(torch.float32)
        x = (x / 255.0).permute(2, 0, 1)[None]
        x = F.interpolate(x, size=tuple(net_hw), mode="bicubic",
                          align_corners=False).clamp(0.0, 1.0)
        d = self.depth(x)
        return F.interpolate(d[None, None], size=tuple(img_u8.shape[:2]),
                             mode="bicubic", align_corners=False)[0, 0]


def build(cfg: dict, weights: Dict[str, torch.Tensor],
          numerics: common.Numerics) -> Marigold:
    return Marigold(cfg, weights, numerics)
