"""ZoeDepth K (isl-org/ZoeDepth ``ZoeD_M12_K.pt``, arXiv:2302.12288) in
plain PyTorch, as the WebUI runs it on one photo.

Written from the published model (``zoedepth/models/zoedepth/
zoedepth_v1.py`` with ``config_zoedepth_kitti.json``, the layers of
``zoedepth/models/layers/``) and the WebUI's inference around it:

- the photo in [0, 1], channels reversed (the funnel hands BGR), reflect
  padded by int(sqrt(h / 2) * 3) rows and int(sqrt(w / 2) * 3) columns,
  run together with its mirrored copy, each resized bilinearly
  (align_corners=True) to the net input that MiDaS's "minimal" resize at
  a multiple of 32 gives for the padded photo and the net size, and
  normalized by mean 0.5 and std 0.5;
- the relative-depth core: MiDaS 3.1's DPT over BEiT-L/16 384
  (``reference/beit_dpt.py``'s blocks, reassemble and rel-pos tables, by
  import) with ZoeDepth's taps: the 32-channel activation after the
  head's second convolution's ReLU, ``layer4_rn``'s output (the
  bottleneck) and the four fusion outputs;
- the metric head: ``conv2`` (1x1) on the bottleneck; the normed seed bin
  regressor (two 1x1 convolutions with ReLUs, + 1e-3, widths normed over
  their sum and scaled to [min_depth, max_depth], edges their cumulative
  sum from min_depth, centers the edges' midpoints), its centers
  normalized to [0, 1]; the seed projector and four projectors to the bin
  embedding; four attractor layers, each on its level's embedding plus
  the previous one resized: attractor points the first of each (value,
  norm) pair of a ReLU MLP + 1e-3, the previous centers resized, moved by
  the mean over the points of dx / (1 + 300 dx^2) (the published layers
  call the distance with its defaults, alpha 300 and gamma 2, whatever
  the configured alpha), scaled to depth, sorted per pixel and clipped;
  the conditional log-binomial over the bins on the 32-channel tap and
  the relative depth, concatenated with the last embedding resized to
  the net input: a 1x1 MLP (exact GELU, softplus) to (p, q) and two
  temperature parts, p / (p + q) clamped to [1e-4, 1], the temperature
  scaled into [min_temp, max_temp], logits log C(K - 1, k) (Stirling's
  form, eps 1e-7) + k log p + (K - 1 - k) log(1 - p), softmaxed over the
  bins at that temperature; the depth the expectation of the last
  centers, resized to the net input, under those probabilities;
- the map resized bicubically (a = -0.75, align_corners=False) to the
  padded size, cropped, and the two copies averaged (the mirrored one
  flipped back).

Every resize but the last is bilinear with align_corners=True.  Every
matrix product and convolution of the core goes through the ``Numerics``
the model is built with, and every one of the head (``conv2`` to the
expectation) through ``head``: by default the same, but f32 when the core
is rounded to bf16.  That is the configuration's stated precision (the
core in bf16, the metric head in f32), so the check's bf16-rounded side
measures the core's rounding alone; with the head rounded too, it would
measure a residual so much smaller than the program's bf16 core leaves
that a head rounded to bf16 or run in TF32 would read as the program
does.  The head computes in the dtype of the taps and weights it is given
(f32 here, bf16 in the head controls of ``port_bench/control_zoedepth.py``).

Departures, each for the card's memory or the benchmark's own rules:
- the net size is the funnel's matched one, each side of the photo
  rounded up to a multiple of 32: valid for traffic with ``net`` "match"
  only;
- attention runs in blocks of 1024 queries, each block's rel-pos bias
  gathered from the block's resized table (no (H, N, N) bias is held);
- the head past the resizes to the net input (the concat, the MLP, the
  log-binomial, the expectation) runs in blocks of ``HEAD_ROWS`` rows;
- the rel-pos tables are resized in f32, as in ``reference/beit_dpt.py``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import beit_dpt, common, dpt

CORE = "model.core.core."
HEAD = "model."
HEAD_ROWS = 128
ATTRACTOR_ALPHA = 300.0   # the distance's default, which the layers use
ATTRACTOR_GAMMA = 2
P_EPS = 1e-4


def matched_net(photo_hw: Tuple[int, int]) -> Tuple[int, int]:
    """(net_h, net_w): the funnel's matched net size for a photo."""
    return tuple((s + 31) // 32 * 32 for s in photo_hw)


def pads(h: int, w: int) -> Tuple[int, int]:
    return int(math.sqrt(h / 2) * 3), int(math.sqrt(w / 2) * 3)


def net_input(photo_hw: Tuple[int, int], net_hw: Tuple[int, int]
              ) -> Tuple[int, int]:
    """(h, w) of the net input: the padded photo's "minimal" resize to
    ``net_hw`` at a multiple of 32."""
    h, w = photo_hw
    ph, pw = pads(h, w)
    nw, nh = common.resize_size(w + 2 * pw, h + 2 * ph, net_hw[1],
                                net_hw[0], "minimal", 32)
    return nh, nw


def _resize(x, hw, mode="bilinear", align_corners=True):
    return F.interpolate(x, size=tuple(hw), mode=mode,
                         align_corners=align_corners)


class _RowBias:
    """A block's rel-pos bias, gathered a block of query rows at a time:
    ``bias[:, q0:q1]`` is the (H, q1 - q0, N) bias of those rows."""

    def __init__(self, table: torch.Tensor, index: torch.Tensor):
        self.table = table
        self.index = index

    def __getitem__(self, key):
        return self.table[self.index[key[1]]].permute(2, 0, 1)


class _Core(beit_dpt.BeitDPT):
    """The BEiT-L/16 DPT with ZoeDepth's taps."""

    def _biases(self, grid):
        if grid not in self._bias:
            cfg, w = self.cfg, self.w
            train = cfg["image_size"] // cfg["patch_size"]
            dev = w["pretrained.model.cls_token"].device
            index = beit_dpt.relative_position_index(*grid, dev)
            self._bias = {grid: [_RowBias(beit_dpt.resized_table(
                w[f"pretrained.model.blocks.{i}.attn."
                  "relative_position_bias_table"], train, grid), index)
                for i in range(cfg["num_hidden_layers"])]}
        return self._bias[grid]

    def taps(self, x):
        """(B, 3, h, w) normalized net input -> (relative depth (B, h, w),
        the 32-channel activation, the bottleneck, the fusion outputs
        coarsest first)."""
        cfg, nx, w = self.cfg, self.nx, self.w
        ps = cfg["patch_size"]
        x = nx.conv(x, w["pretrained.model.patch_embed.proj.weight"],
                    w["pretrained.model.patch_embed.proj.bias"], stride=ps)
        grid = (x.shape[2], x.shape[3])
        tokens = x.flatten(2).transpose(1, 2)
        cls = w["pretrained.model.cls_token"].expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], 1)
        biases = self._biases(grid)
        taps = []
        for i in range(cfg["num_hidden_layers"]):
            tokens = self._block(i, tokens, biases[i])
            if i in cfg["hooks"]:
                taps.append(tokens)
        layers = [self._reassemble(j, t, grid) for j, t in enumerate(taps)]
        r = [dpt._conv(nx, w, f"scratch.layer{i + 1}_rn", h, bias=False)
             for i, h in enumerate(layers)]
        p4 = dpt._fusion(nx, w, "scratch.refinenet4", r[3],
                         size=r[2].shape[2:])
        p3 = dpt._fusion(nx, w, "scratch.refinenet3", p4, r[2],
                         size=r[1].shape[2:])
        p2 = dpt._fusion(nx, w, "scratch.refinenet2", p3, r[1],
                         size=r[0].shape[2:])
        p1 = dpt._fusion(nx, w, "scratch.refinenet1", p2, r[0])
        out = dpt._conv(nx, w, "scratch.output_conv.0", p1)
        out = F.interpolate(out, scale_factor=2, mode="bilinear",
                            align_corners=True)
        act = F.relu(dpt._conv(nx, w, "scratch.output_conv.2", out))
        rel = F.relu(dpt._conv(nx, w, "scratch.output_conv.4", act,
                               padding=0))[:, 0]
        return rel, act, r[3], [p4, p3, p2, p1]


def log_binomial_table(k: int, device, dtype=torch.float32
                       ) -> torch.Tensor:
    """log C(K - 1, k) for k < K by Stirling's form with eps 1e-7, in
    ``dtype``: (1, K, 1, 1)."""
    eps = 1e-7
    n = torch.full((k,), k - 1, dtype=dtype, device=device) + eps
    i = torch.arange(k, dtype=dtype, device=device) + eps
    out = n * torch.log(n) - i * torch.log(i) - (n - i) * torch.log(
        n - i + eps)
    return out.view(1, k, 1, 1)


class ZoeDepthK:
    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 numerics: common.Numerics,
                 head: Optional[common.Numerics] = None):
        self.cfg = cfg
        if head is None:
            head = common.Numerics("f32") if numerics.mode == "bf16" \
                else numerics
        self.hx = head
        self.core = _Core(cfg, {k[len(CORE):]: v for k, v in weights.items()
                                if k.startswith(CORE)}, numerics)
        self.w = {k[len(HEAD):]: v for k, v in weights.items()
                  if k.startswith(HEAD) and not k.startswith(CORE)}

    def _conv1(self, name: str, x):
        return self.hx.conv(x, self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"])

    def _mlp(self, name: str, x, act_out=None):
        """The published ``_net``: 1x1 conv, ReLU, 1x1 conv[, act]."""
        h = self._conv1(f"{name}._net.2",
                        F.relu(self._conv1(f"{name}._net.0", x)))
        return h if act_out is None else act_out(h)

    def _attractor(self, i: int, emb, prev_emb, b_prev):
        """(moved normalized centers, sorted clipped centers in depth)."""
        cfg = self.cfg
        lo, hi = cfg["min_depth"], cfg["max_depth"]
        x = emb + _resize(prev_emb, emb.shape[2:])
        a = self._mlp(f"attractors.{i}", x, F.relu) + 1e-3
        n, _, h, w = a.shape
        a = a.view(n, cfg["n_attractors"][i], 2, h, w)[:, :, 0]
        b_prev = _resize(b_prev, (h, w))
        dx = a[:, :, None] - b_prev[:, None]
        dist = dx / (1.0 + ATTRACTOR_ALPHA * dx ** ATTRACTOR_GAMMA)
        b_new = b_prev + dist.mean(1)
        centers = torch.sort((hi - lo) * b_new + lo, 1).values
        return b_new, centers.clamp(lo, hi)

    def _bins(self, btlnck, blocks):
        """The seed bins through the four attractors: (the last centers,
        the last level's embedding)."""
        cfg = self.cfg
        lo, hi = cfg["min_depth"], cfg["max_depth"]
        b = self._mlp("seed_bin_regressor", btlnck, F.relu) + 1e-3
        widths = (hi - lo) * (b / b.sum(1, keepdim=True))
        edges = torch.cumsum(F.pad(widths, (0, 0, 0, 0, 1, 0), value=lo), 1)
        seed_centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        b_prev = (seed_centers - lo) / (hi - lo)
        prev_emb = self._mlp("seed_projector", btlnck)
        centers = None
        for i, xb in enumerate(blocks):
            emb = self._mlp(f"projectors.{i}", xb)
            b_prev, centers = self._attractor(i, emb, prev_emb, b_prev)
            prev_emb = emb
        return centers, prev_emb

    def _log_binomial_depth(self, last, emb, centers):
        """The conditional log-binomial and the expectation on rows of the
        net input: (B, 33, r, w), (B, 128, r, w), (B, K, r, w) -> (B, r,
        w)."""
        cfg = self.cfg
        k = cfg["n_bins"]
        h = common.gelu(self._conv1("conditional_log_binomial.mlp.0",
                                    torch.cat([last, emb], 1)))
        pt = F.softplus(self._conv1("conditional_log_binomial.mlp.2", h))
        p = pt[:, :2] + P_EPS
        p = p[:, 0] / (p[:, 0] + p[:, 1])
        t = pt[:, 2:] + P_EPS
        t = t[:, 0] / (t[:, 0] + t[:, 1])
        t = (cfg["max_temp"] - cfg["min_temp"]) * t[:, None] + \
            cfg["min_temp"]
        p = p[:, None].clamp(P_EPS, 1.0)
        q = (1.0 - p).clamp(P_EPS, 1.0)
        kk = torch.arange(k, dtype=p.dtype, device=p.device).view(1, k, 1, 1)
        y = log_binomial_table(k, p.device, p.dtype) + kk * torch.log(p) + \
            (k - 1 - kk) * torch.log(q)
        probs = torch.softmax(y / t, 1)
        return (probs * centers).sum(1)

    def metric(self, x):
        """(B, 3, h, w) normalized net input -> (B, h, w) metric depth."""
        rel, act, btlnck, blocks = self.core.taps(x)
        btlnck = self._conv1("conv2", btlnck)
        centers, emb = self._bins(btlnck, blocks)
        hw = act.shape[2:]
        last = torch.cat([act, _resize(rel[:, None], hw)], 1)
        emb = _resize(emb, hw)
        centers = _resize(centers, hw)
        out = torch.empty((x.shape[0],) + tuple(hw), device=x.device)
        for r0 in range(0, hw[0], HEAD_ROWS):
            r1 = min(r0 + HEAD_ROWS, hw[0])
            out[:, r0:r1] = self._log_binomial_depth(
                last[:, :, r0:r1], emb[:, :, r0:r1], centers[:, :, r0:r1])
        return out

    @torch.no_grad()
    def raw(self, img_u8: np.ndarray, net_hw: Tuple[int, int]
            ) -> torch.Tensor:
        """(H, W, 3) uint8 photo -> (H, W) f32 metric depth at its size;
        ``net_hw`` is the photo's own size (the configuration's
        ``preprocess``), matched here as the funnel matches it."""
        dev = self.w["conv2.weight"].device
        h, w = img_u8.shape[:2]
        x = torch.as_tensor(img_u8, device=dev).to(torch.float32) / 255.0
        x = x.flip(-1).permute(2, 0, 1)[None]
        ph, pw = pads(h, w)
        xp = F.pad(x, (pw, pw, ph, ph), mode="reflect")
        xb = torch.cat([xp, xp.flip(-1)], 0)
        xr = _resize(xb, net_input((h, w), matched_net(tuple(net_hw))))
        pred = self.metric((xr - 0.5) / 0.5)
        pred = _resize(pred[:, None], xp.shape[2:], "bicubic", False)[:, 0]
        pred = pred[:, ph:pred.shape[1] - ph, pw:pred.shape[2] - pw]
        return (pred[0] + pred[1].flip(-1)) / 2.0


def build(cfg: dict, weights: Dict[str, torch.Tensor],
          numerics: common.Numerics) -> ZoeDepthK:
    return ZoeDepthK(cfg, weights, numerics)
