"""ZoeDepth metric-depth models (zoedepth_n / k / nk), NCHW.

Port of ``depthmap_tpu/models/zoedepth.py`` in the reference checkpoint
layout (``zoedepth_v1.py`` / ``zoedepth_nk_v1.py``): the BEiT-L/16 384 DPT
under ``core.core``, then ``conv2``, ``seed_projector`` and
``projectors.{i}`` (``_net.{0,2}``), the seed bin regressor and the
attractors (``seed_bin_regressor`` / ``attractors.{i}``, or one of each per
domain under ``seed_bin_regressors.{nyu,kitti}`` /
``attractors.{nyu,kitti}.{i}`` for NK), the log-binomial head
(``conditional_log_binomial.mlp.{0,2}``) and, for NK, the domain router
(``patch_transformer``, ``mlp_classifier.{0,2}``).  ``ZoeDepthInference``
holds the model as ``model``, so its keys carry that prefix.  The
log-binomial table is built on the host (the LogBinomial buffers are not
kept).

The relative-depth core runs in its parameters' dtype (bf16 on the card
under the predictor's selective precision); its taps come back as f32 and
the metric head computes in f32.  The only kernel is K1, in the core's
BEiT blocks; the router's attention (4 heads of 32) is two einsums.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.models.dpt import DPTDepthModel
from depthmap_tpu_torch.ops.resize import interpolate
from depthmap_tpu_torch.pipeline.preprocess import resize_get_size


def inv_attractor(dx, alpha: float = 300.0, gamma: int = 2):
    return dx / (1.0 + alpha * dx ** gamma)


def exp_attractor(dx, alpha: float = 300.0, gamma: int = 2):
    return torch.exp(-alpha * dx.abs() ** gamma) * dx


def _mlp2(cin: int, mid: int, cout: int, act: Optional[nn.Module] = None
          ) -> nn.Sequential:
    """The reference's ``_net``: 1x1 conv, ReLU, 1x1 conv[, act]."""
    layers = [nn.Conv2d(cin, mid, 1), nn.ReLU(), nn.Conv2d(mid, cout, 1)]
    return nn.Sequential(*layers, *([act] if act is not None else []))


class SeedBinRegressorUnnormed(nn.Module):
    """Softplus bin centers: (centers, centers)."""

    def __init__(self, in_features: int, n_bins: int = 64,
                 mlp_dim: int = 256):
        super().__init__()
        self._net = _mlp2(in_features, mlp_dim, n_bins, nn.Softplus())

    def forward(self, x):
        centers = self._net(x)
        return centers, centers


class SeedBinRegressorNormed(nn.Module):
    """Bounded bins: widths normed over [min_depth, max_depth], centers at
    the middle of each edge pair: (normed widths, centers)."""

    def __init__(self, in_features: int, n_bins: int = 64,
                 mlp_dim: int = 256, min_depth: float = 1e-3,
                 max_depth: float = 10.0):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self._net = _mlp2(in_features, mlp_dim, n_bins, nn.ReLU())

    def forward(self, x):
        b = self._net(x) + 1e-3
        widths_normed = b / b.sum(1, keepdim=True)
        widths = (self.max_depth - self.min_depth) * widths_normed
        edges = torch.cumsum(F.pad(widths, (0, 0, 0, 0, 1, 0),
                                   value=self.min_depth), 1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return widths_normed, centers


class Projector(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 mlp_dim: int = 128):
        super().__init__()
        self._net = _mlp2(in_features, mlp_dim, out_features)

    def forward(self, x):
        return self._net(x)


def _attract(a, b_prev, kind: str, attractor_type: str):
    """b_prev moved by every attractor point of ``a``: (N, A, H, W) and
    (N, bins, H, W) -> (N, bins, H, W).  The reference calls its distance
    with the jit-script defaults (alpha 300, gamma 2), never with the
    configured alpha."""
    dist = inv_attractor if attractor_type == "inv" else exp_attractor
    delta = dist(a[:, :, None] - b_prev[:, None], 300.0, 2)
    delta = delta.mean(1) if kind == "mean" else delta.sum(1)
    return b_prev + delta


class AttractorLayerUnnormed(nn.Module):
    def __init__(self, in_features: int, n_attractors: int = 16,
                 mlp_dim: int = 128, alpha: float = 300.0, gamma: int = 2,
                 kind: str = "mean", attractor_type: str = "inv"):
        super().__init__()
        self.kind, self.attractor_type = kind, attractor_type
        self._net = _mlp2(in_features, mlp_dim, n_attractors, nn.Softplus())

    def forward(self, x, b_prev, prev_b_embedding=None):
        if prev_b_embedding is not None:
            x = x + interpolate(prev_b_embedding, x.shape[2:], "bilinear",
                                True)
        a = self._net(x)
        b_prev = interpolate(b_prev, x.shape[2:], "bilinear", True)
        b_new = _attract(a, b_prev, self.kind, self.attractor_type)
        return b_new, b_new


class AttractorLayerNormed(nn.Module):
    """Bounded-bin attractor (zoedepth_k).  The attractor points are the
    raw first element of each (value, norm) pair: the reference computes
    the normalized pair and overwrites it unused.  The moved centers are
    scaled to depth, sorted and clipped."""

    def __init__(self, in_features: int, n_attractors: int = 16,
                 mlp_dim: int = 128, alpha: float = 300.0, gamma: int = 2,
                 kind: str = "sum", attractor_type: str = "exp",
                 min_depth: float = 1e-3, max_depth: float = 10.0):
        super().__init__()
        self.kind, self.attractor_type = kind, attractor_type
        self.n_attractors = n_attractors
        self.min_depth, self.max_depth = min_depth, max_depth
        self._net = _mlp2(in_features, mlp_dim, 2 * n_attractors, nn.ReLU())

    def forward(self, x, b_prev, prev_b_embedding=None):
        if prev_b_embedding is not None:
            x = x + interpolate(prev_b_embedding, x.shape[2:], "bilinear",
                                True)
        a = self._net(x) + 1e-3
        n, _, h, w = a.shape
        a = a.view(n, self.n_attractors, 2, h, w)[:, :, 0]
        b_prev = interpolate(b_prev, x.shape[2:], "bilinear", True)
        b_new = _attract(a, b_prev, self.kind, self.attractor_type)
        centers = (self.max_depth - self.min_depth) * b_new + self.min_depth
        centers = torch.sort(centers, 1).values
        return b_new, centers.clamp(self.min_depth, self.max_depth)


def log_binom_table(k: int) -> np.ndarray:
    """log(C(K-1, k)) by Stirling, in numpy f32 as the JAX package builds
    it (an on-device expression gives NaN at k = K-1)."""
    n = np.float32(k - 1) + np.float32(1e-7)
    i = np.arange(k, dtype=np.float32) + np.float32(1e-7)
    return (n * np.log(n) - i * np.log(i)
            - (n - i) * np.log(n - i + np.float32(1e-7))).astype(np.float32)


class ConditionalLogBinomial(nn.Module):
    """(x, cond) -> (N, n_classes, H, W) probabilities: a binomial over the
    bins with p and a temperature from the MLP, softmaxed in f32."""

    def __init__(self, in_features: int, condition_dim: int = 128,
                 n_classes: int = 64, bottleneck_factor: int = 2,
                 min_temp: float = 0.0212, max_temp: float = 50.0):
        super().__init__()
        self.n_classes = n_classes
        self.min_temp, self.max_temp = min_temp, max_temp
        # device -> (table, k index) as (1, K, 1, 1) f32, copied to a device
        # once (not buffers: a reduced-dtype cast would round the table)
        self._consts: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        bottleneck = (in_features + condition_dim) // bottleneck_factor
        self.mlp = nn.Sequential(
            nn.Conv2d(in_features + condition_dim, bottleneck, 1),
            nn.GELU(),
            nn.Conv2d(bottleneck, 4, 1),
            nn.Softplus())

    def forward(self, x, cond):
        pt = self.mlp(torch.cat([x, cond], 1))
        p = pt[:, :2] + 1e-4
        p = p[:, 0] / (p[:, 0] + p[:, 1])
        t = pt[:, 2:] + 1e-4
        t = t[:, 0] / (t[:, 0] + t[:, 1])
        t = (self.max_temp - self.min_temp) * t + self.min_temp
        k = self.n_classes
        if x.device not in self._consts:
            self._consts[x.device] = tuple(
                torch.from_numpy(a).to(x.device).view(1, k, 1, 1)
                for a in (log_binom_table(k),
                          np.arange(k, dtype=np.float32)))
        table, k_idx = self._consts[x.device]
        p = p.clamp(1e-4, 1.0)[:, None]
        one_minus_p = (1.0 - p).clamp(1e-4, 1.0)
        y = table + k_idx * torch.log(p) \
            + (k - 1 - k_idx) * torch.log(one_minus_p)
        return torch.softmax(y / t[:, None], 1)


class _SelfAttention(nn.Module):
    """torch's MultiheadAttention parameters (``in_proj_weight`` /
    ``in_proj_bias`` / ``out_proj``), computed with two einsums."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, s, c = x.shape
        hd = c // self.num_heads
        q, k, v = F.linear(x, self.in_proj_weight,
                           self.in_proj_bias).split(c, -1)

        def heads(t):
            return t.reshape(b, s, self.num_heads, hd).transpose(1, 2)
        att = torch.softmax(torch.einsum("bhsd,bhtd->bhst",
                                         heads(q) * hd ** -0.5, heads(k)), -1)
        o = torch.einsum("bhst,bhtd->bhsd", att, heads(v))
        return self.out_proj(o.transpose(1, 2).reshape(b, s, c))


class _EncoderLayer(nn.Module):
    """torch's TransformerEncoderLayer (post-norm, ReLU) with the JAX
    package's LayerNorm epsilon (flax's 1e-6)."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int):
        super().__init__()
        self.self_attn = _SelfAttention(dim, num_heads)
        self.linear1 = nn.Linear(dim, ff_dim)
        self.linear2 = nn.Linear(ff_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


def _positional_encoding(s: int, e: int) -> np.ndarray:
    """(s, e) sinusoids laid out concat([sin, cos]), not interleaved."""
    position = np.arange(s, dtype=np.float32)[:, None]
    index = np.arange(0, e, 2, dtype=np.float32)[None, :]
    div = np.exp(index * (-math.log(10000.0) / e))
    pe = position * div
    return np.concatenate([np.sin(pe), np.cos(pe)], axis=1)


class PatchTransformerEncoder(nn.Module):
    """1x1-patch transformer with a class token for the NK domain router:
    (N, C, H, W) -> the class token's (N, embedding_dim) embedding."""

    def __init__(self, in_channels: int, embedding_dim: int = 128,
                 num_heads: int = 4, num_layers: int = 4,
                 ff_dim: int = 1024):
        super().__init__()
        self.embedding_dim = embedding_dim
        # (sequence length, device) -> the positional encoding there
        self._pos: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        self.embedding_convPxP = nn.Conv2d(in_channels, embedding_dim, 1)
        self.transformer_encoder = nn.Module()
        self.transformer_encoder.layers = nn.ModuleList(
            [_EncoderLayer(embedding_dim, num_heads, ff_dim)
             for _ in range(num_layers)])

    def forward(self, x):
        emb = self.embedding_convPxP(x).flatten(2).transpose(1, 2)
        # the class token: a zero row at the sequence's start
        emb = F.pad(emb, (0, 0, 1, 0))
        key = (emb.shape[1], emb.device)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(_positional_encoding(
                emb.shape[1], self.embedding_dim)).to(emb.device)
        emb = emb + self._pos[key]
        for layer in self.transformer_encoder.layers:
            emb = layer(emb)
        return emb[:, 0]


def core_head(btlnck_features: int, n_bins: int = 64,
              bin_embedding_dim: int = 128, min_depth: float = 1e-3,
              max_depth: float = 10.0,
              n_attractors: Sequence[int] = (16, 8, 4, 1),
              alpha: float = 1000.0, gamma: int = 2, kind: str = "mean",
              attractor_type: str = "inv", mlp_dim_seed: int = 256,
              attractor_mlp_dim: int = 128,
              bin_centers_type: str = "softplus"
              ) -> Tuple[nn.Module, nn.ModuleList]:
    """The modules of the JAX package's ``ZoeCoreHead`` for one domain:
    (seed bin regressor, attractors), which the model registers under the
    reference checkpoint's names; ``bins`` runs them."""
    if bin_centers_type == "normed":
        return (SeedBinRegressorNormed(btlnck_features, n_bins, mlp_dim_seed,
                                       min_depth, max_depth),
                nn.ModuleList([
                    AttractorLayerNormed(bin_embedding_dim, a,
                                         attractor_mlp_dim, alpha, gamma,
                                         kind, attractor_type, min_depth,
                                         max_depth)
                    for a in n_attractors]))
    return (SeedBinRegressorUnnormed(btlnck_features, n_bins, mlp_dim_seed),
            nn.ModuleList([
                AttractorLayerUnnormed(bin_embedding_dim, a,
                                       attractor_mlp_dim, alpha, gamma, kind,
                                       attractor_type)
                for a in n_attractors]))


def bins(seed_regressor: nn.Module, attractors: nn.ModuleList, btlnck,
         seed_embedding, embeddings):
    """Seed bins -> attractors (``ZoeCoreHead``'s forward): (final
    centers, last embedding).  For softplus bins the unnormed chain's
    centers are the running b_prev; for normed bins the chain runs on
    normalized centers and the last attractor's scaled, sorted, clipped
    centers come back."""
    _, seed_b_centers = seed_regressor(btlnck)
    b_prev = seed_b_centers
    if isinstance(seed_regressor, SeedBinRegressorNormed):
        lo, hi = seed_regressor.min_depth, seed_regressor.max_depth
        b_prev = (seed_b_centers - lo) / (hi - lo)
    prev_b_embedding = seed_embedding
    b_centers = b_prev
    for attractor, b_embedding in zip(attractors, embeddings):
        b_prev, b_centers = attractor(b_embedding, b_prev, prev_b_embedding)
        prev_b_embedding = b_embedding
    return b_centers, embeddings[-1]


class MidasCore(nn.Module):
    """The relative-depth core: the DPT (built with its ZoeDepth taps) at
    ``core``, as the reference's MidasCore holds it."""

    def __init__(self, core: DPTDepthModel):
        super().__init__()
        self.core = core

    def forward(self, x, **grid_inputs):
        x = x.to(self.core.scratch.layer1_rn.weight.dtype)
        return self.core(x, **grid_inputs)


class _ZoeBase(nn.Module):
    """What ZoeDepth and ZoeDepthNK share: the core, its f32 taps, the
    bottleneck conv and the bin-embedding projectors."""

    def __init__(self, core: DPTDepthModel, bin_embedding_dim: int,
                 projector_mlp_dim: int):
        super().__init__()
        self.core = MidasCore(core)
        feats = core.scratch.layer4_rn.out_channels
        self.conv2 = nn.Conv2d(feats, feats, 1)
        self.seed_projector = Projector(feats, bin_embedding_dim,
                                        projector_mlp_dim)
        self.projectors = nn.ModuleList(
            [Projector(feats, bin_embedding_dim, projector_mlp_dim)
             for _ in range(4)])

    def _features(self, x, grid_inputs):
        """-> (rel_depth, out_conv_act, btlnck, seed embedding, level
        embeddings), all f32."""
        rel_depth, taps = self.core(x, **grid_inputs)
        out_conv_act, btlnck, *x_blocks = [t.float() for t in taps]
        btlnck = self.conv2(btlnck)
        embeddings = [p(xb) for p, xb in zip(self.projectors, x_blocks)]
        return (rel_depth.float(), out_conv_act, btlnck,
                self.seed_projector(btlnck), embeddings)

    def head_to_f32(self) -> None:
        """The metric head in f32 (its weights keep the values they were
        rounded to), the core's last conv too."""
        for name, child in self.named_children():
            if name != "core":
                child.float()
        self.core.core.head_to_f32()

    def core_to(self, dtype: torch.dtype) -> None:
        """The relative-depth core in ``dtype``, its last conv in f32."""
        self.core.to(dtype)
        self.core.core.head_to_f32()


def _metric(probs, b_centers):
    b_centers = interpolate(b_centers, probs.shape[2:], "bilinear", True)
    return (probs.float() * b_centers.float()).sum(1)


class ZoeDepth(_ZoeBase):
    """Single-head ZoeDepth (n: softplus bins, k: normed bins): (N, 3, H,
    W) normalized input -> (N, H, W) metric depth in meters."""

    def __init__(self, core: DPTDepthModel, n_bins: int = 64,
                 bin_embedding_dim: int = 128, min_depth: float = 1e-3,
                 max_depth: float = 10.0, min_temp: float = 0.0212,
                 max_temp: float = 50.0, alpha: float = 1000.0,
                 attractor_kind: str = "mean", attractor_type: str = "inv",
                 bin_centers_type: str = "softplus"):
        super().__init__(core, bin_embedding_dim, 128)
        feats = core.scratch.layer4_rn.out_channels
        self.seed_bin_regressor, self.attractors = core_head(
            feats, n_bins, bin_embedding_dim, min_depth, max_depth,
            alpha=alpha, kind=attractor_kind, attractor_type=attractor_type,
            bin_centers_type=bin_centers_type)
        # the head's last tap (32 channels) and the relative depth
        self.conditional_log_binomial = ConditionalLogBinomial(
            33, bin_embedding_dim, n_bins, min_temp=min_temp,
            max_temp=max_temp)

    def forward(self, x, **grid_inputs):
        rel_depth, last, btlnck, seed_emb, embeddings = \
            self._features(x, grid_inputs)
        b_centers, b_embedding = bins(self.seed_bin_regressor,
                                      self.attractors, btlnck, seed_emb,
                                      embeddings)
        rel_cond = interpolate(rel_depth[:, None], last.shape[2:],
                               "bilinear", True)
        last = torch.cat([last, rel_cond], 1)
        b_embedding = interpolate(b_embedding, last.shape[2:], "bilinear",
                                  True)
        probs = self.conditional_log_binomial(last, b_embedding)
        return _metric(probs, b_centers)


DOMAINS = ("nyu", "kitti")


class ZoeDepthNK(_ZoeBase):
    """Dual-expert ZoeDepth: a patch-transformer router votes over the
    whole batch (the flipped copies and every image of a batched call
    included) for the NYU or the KITTI expert; both are computed and one
    is selected for all, with no host sync."""

    def __init__(self, core: DPTDepthModel, n_bins: int = 64,
                 bin_embedding_dim: int = 128, min_temp: float = 0.0212,
                 max_temp: float = 50.0, alpha: float = 1000.0):
        super().__init__(core, bin_embedding_dim, bin_embedding_dim // 2)
        feats = core.scratch.layer4_rn.out_channels
        # every attractor keeps 16 points: the reference passes
        # n_attractors[i] where it means n_bins
        heads = {d: core_head(feats, n_bins, bin_embedding_dim,
                              n_attractors=(16, 16, 16, 16), alpha=alpha,
                              kind="mean", attractor_type="inv",
                              mlp_dim_seed=bin_embedding_dim // 2,
                              attractor_mlp_dim=bin_embedding_dim)
                 for d in DOMAINS}
        self.seed_bin_regressors = nn.ModuleDict(
            {d: seed for d, (seed, _) in heads.items()})
        self.attractors = nn.ModuleDict(
            {d: attractors for d, (_, attractors) in heads.items()})
        self.conditional_log_binomial = nn.ModuleDict(
            {d: ConditionalLogBinomial(32, bin_embedding_dim, n_bins, 4,
                                       min_temp, max_temp)
             for d in DOMAINS})
        self.patch_transformer = PatchTransformerEncoder(feats)
        self.mlp_classifier = nn.Sequential(nn.Linear(128, 128), nn.ReLU(),
                                            nn.Linear(128, 2))

    def forward(self, x, **grid_inputs):
        _, last, btlnck, seed_emb, embeddings = self._features(x,
                                                               grid_inputs)
        domain_logits = self.mlp_classifier(self.patch_transformer(btlnck))
        vote = torch.softmax(domain_logits.sum(0, keepdim=True), -1)
        use_kitti = vote.argmax(-1)[0] == 1
        out = {}
        for d in DOMAINS:
            b_centers, b_embedding = bins(self.seed_bin_regressors[d],
                                          self.attractors[d], btlnck,
                                          seed_emb, embeddings)
            b_emb = interpolate(b_embedding, last.shape[2:], "bilinear", True)
            probs = self.conditional_log_binomial[d](last, b_emb)
            out[d] = _metric(probs, b_centers)
        return torch.where(use_kitti, out["kitti"], out["nyu"])


class ZoeDepthInference(nn.Module):
    """The inference wrapper: reflect pad, flip TTA as one batch of 2N,
    in-model resize and normalization, the model, bicubic back, crop and
    average.  It holds the model as ``model``: its state dict is the
    reference checkpoint's under that prefix."""

    def __init__(self, model: _ZoeBase, img_size: Tuple[int, int] = (384,
                                                                     512)):
        super().__init__()
        self.model = model
        self.img_size = tuple(img_size)   # (H, W)

    @staticmethod
    def net_input_size(h: int, w: int,
                       net_size: Optional[Tuple[int, int]],
                       img_size: Tuple[int, int]) -> Tuple[int, int]:
        """(new_h, new_w) the padded flip-TTA batch is resized to, from the
        static shapes alone (the predictor keys its grid inputs on it)."""
        net_h, net_w = net_size if net_size is not None else img_size
        pad_h = int(np.sqrt(h / 2) * 3)
        pad_w = int(np.sqrt(w / 2) * 3)
        new_w, new_h = resize_get_size(w + 2 * pad_w, h + 2 * pad_h, net_w,
                                       net_h, "minimal", True, 32)
        return new_h, new_w

    def grid_inputs(self, input_hw: Tuple[int, int],
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The BEiT core's per-grid inputs for a net input of
        ``input_hw`` (the biases hoisted under BIAS_HOIST_CAP)."""
        return self.model.core.core.grid_inputs(input_hw, dtype)

    def head_to_f32(self) -> None:
        self.model.head_to_f32()

    def core_to(self, dtype: torch.dtype) -> None:
        self.model.core_to(dtype)

    def forward(self, x01, net_size: Optional[Tuple[int, int]] = None,
                **grid_inputs):
        """x01: (N, 3, H, W) in [0, 1] -> (N, H, W) metric depth."""
        n, _, h, w = x01.shape
        pad_h = int(np.sqrt(h / 2) * 3)
        pad_w = int(np.sqrt(w / 2) * 3)
        xp = F.pad(x01, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
        xb = torch.cat([xp, xp.flip(-1)], 0)
        new_h, new_w = self.net_input_size(h, w, net_size, self.img_size)
        xr = interpolate(xb, (new_h, new_w), "bilinear", True)
        pred = self.model((xr - 0.5) / 0.5, **grid_inputs)
        pred = interpolate(pred[:, None].float(), xp.shape[2:], "bicubic",
                           False)[:, 0]
        pred = pred[:, pad_h:pred.shape[1] - pad_h,
                    pad_w:pred.shape[2] - pad_w]
        return (pred[:n] + pred[n:].flip(-1)) / 2.0


def build_zoedepth(variant: str) -> ZoeDepthInference:
    """variant in {n, k, nk}: BEiT-L/16 384 core; n max depth 10 at 384 x
    512, k normed bins to 80 at 384 x 768, nk the routed pair at 384 x
    512."""
    from depthmap_tpu_torch.models import beit
    core = DPTDepthModel(beit.beit_large(384), with_zoe_taps=True)
    if variant == "n":
        return ZoeDepthInference(ZoeDepth(core, max_depth=10.0), (384, 512))
    if variant == "k":
        return ZoeDepthInference(
            ZoeDepth(core, max_depth=80.0, bin_centers_type="normed"),
            (384, 768))
    if variant == "nk":
        return ZoeDepthInference(ZoeDepthNK(core), (384, 512))
    raise ValueError(f"Unknown ZoeDepth variant {variant!r}")
