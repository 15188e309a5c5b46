"""The port's Marigold (type 10: ``depthmap_tpu_torch/models/marigold/``)
against the JAX package's, on the same weights and the same initial noise
(JAX's ``jax.random.normal`` draws, fed to the port through ``noise=`` or
its ``draw_noise``).

Small nets: the UNet at base 32 (heads of 16, a 64-wide context), the VAE
at base 32, f32 (the pipeline's own tests, on these nets, are in
tests/test_torch_port_marigold_pipeline.py).  Tolerances: the DDIM
timesteps and coefficients exactly (the same f64 arithmetic rounded to
f32); the UNet and the VAE at atol 5e-5 (outputs of magnitude ~1-4);
``ensemble_depths`` to 1e-6 on equal members; the UNet's bf16 weights
on f32 inputs at 5e-5, its bf16 mode (bf16 inputs too) within 0.8 of the
mean distance between JAX's f32 and bf16 maps, the bf16 pipeline at 0.03
(each test says why); the full nets' keys and a strict load from a
diffusers tree exactly.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu.models.marigold import ddim as jddim
from depthmap_tpu.models.marigold import pipeline as jmp
from depthmap_tpu.models.marigold import unet as junet
from depthmap_tpu.models.marigold import vae as jvae
from depthmap_tpu_torch.models import weights as W
from depthmap_tpu_torch.models.marigold import ddim as tddim
from depthmap_tpu_torch.models.marigold import pipeline as tmp
from depthmap_tpu_torch.models.marigold import unet as tunet
from depthmap_tpu_torch.models.marigold import vae as tvae
from tests.test_torch_port_midas import _draw

NET_ATOL = 5e-5
SMALL_UNET = dict(base=32, context_dim=64, dim_head=16)
SMALL_VAE = 32


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def jax_noise(n: int, lh: int, lw: int, seed: int) -> torch.Tensor:
    """The JAX pipeline's initial latents for ``seed``, NCHW."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    z = jax.vmap(lambda k: jax.random.normal(k, (lh, lw, 4),
                                             dtype=jnp.float32))(keys)
    return _nchw(np.asarray(z)).contiguous()


@functools.lru_cache(maxsize=None)
def jax_pipeline(seed: int = 0) -> jmp.MarigoldPipeline:
    """The JAX pipeline on the small nets, its weights drawn with numpy
    (``_draw``; the empty prompt's embedding zeros), one per seed: its
    compiled programs are kept across tests."""
    enc, dec = jvae.Encoder(base=SMALL_VAE), jvae.Decoder(base=SMALL_VAE)
    unet = junet.MarigoldUNet(**SMALL_UNET)
    key = jax.random.PRNGKey(0)
    shapes = {
        "encoder": jax.eval_shape(enc.init, key, jnp.zeros((1, 64, 64, 3))),
        "decoder": jax.eval_shape(dec.init, key, jnp.zeros((1, 8, 8, 4))),
        "unet": jax.eval_shape(unet.init, key, jnp.zeros((1, 8, 8, 8)),
                               jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 77, 64)))}
    variables = _draw(shapes, seed)
    variables["empty_text_embed"] = np.zeros((1, 77, 64), np.float32)
    return jmp.MarigoldPipeline(variables, encoder=enc, decoder=dec,
                                unet=unet)


def torch_pipeline(variables=None) -> tmp.MarigoldPipeline:
    pipe = tmp.MarigoldPipeline(tvae.AutoencoderKL(base=SMALL_VAE),
                                tunet.MarigoldUNet(**SMALL_UNET),
                                SMALL_UNET["context_dim"])
    if variables is not None:
        pipe.load_state_dict(W.state_dict_from_jax_marigold(variables),
                             strict=True)
    return pipe.eval()


@pytest.fixture
def tiny_marigold(monkeypatch):
    """build_model(10) gives the small pipeline in both packages (neither
    edited); the port draws JAX's noise."""
    jpipe = jax_pipeline()
    monkeypatch.setattr(jmp, "build_marigold_pipeline",
                        lambda variables=None: jpipe)
    monkeypatch.setattr(tmp, "build_marigold", lambda: torch_pipeline())
    monkeypatch.setattr(tmp.MarigoldPipeline, "draw_noise",
                        lambda self, n, lh, lw, seed: jax_noise(n, lh, lw,
                                                                seed))
    return jpipe


def _predictors(jpipe, ensembles=2, steps=2):
    from depthmap_tpu.pipeline.depth import DepthPredictor as JPred
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor as TPred
    jp = JPred(10, marigold_ensembles=ensembles, marigold_steps=steps)
    tp = TPred(10, state_dict=W.state_dict_from_jax_marigold(jpipe.vars),
               device="cpu", marigold_ensembles=ensembles,
               marigold_steps=steps)
    return jp, tp


def _image(seed: int, h: int, w: int) -> np.ndarray:
    from tests.test_torch_port_boost import scene
    return scene(seed, h, w)


# -- the scheduler --------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 2, 10, 12, 50])
def test_ddim_timesteps_and_coefficients(steps):
    js, ts = jddim.DDIMScheduler(), tddim.DDIMScheduler()
    np.testing.assert_array_equal(ts.alphas_cumprod, js.alphas_cumprod)
    assert ts.final_alpha_cumprod == js.final_alpha_cumprod
    np.testing.assert_array_equal(ts.set_timesteps(steps),
                                  js.set_timesteps(steps))
    pipe = jmp.MarigoldPipeline.__new__(jmp.MarigoldPipeline)
    pipe.scheduler, pipe._infer_cache = js, {}
    pipe._enc = pipe._dec = pipe._unet = None
    _, coefs, tsteps = pipe._infer_program(steps)
    got_t, got_c = ts.coefficients(steps)
    np.testing.assert_array_equal(got_t, tsteps)
    np.testing.assert_array_equal(got_c, coefs)


# -- the nets --------------------------------------------------------------

@pytest.mark.parametrize("hw", [(16, 16), (6, 8)])
def test_unet_small_matches_jax(hw):
    """Square latents and odd ones (6 x 8 -> 3 x 4 -> 2 x 2: each upsample
    goes to its skip's size, half-pixel nearest)."""
    jm = junet.MarigoldUNet(**SMALL_UNET)
    rng = np.random.default_rng(hw[0])
    x = rng.normal(size=(2, *hw, 8)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 64)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.zeros((2,), jnp.int32), jnp.asarray(ctx))
    v = _draw(shapes, 1)
    t = np.array([901, 1], np.int32)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(ctx)))
    tm = tunet.MarigoldUNet(**SMALL_UNET)
    tm.load_state_dict(W.state_dict_from_jax_unet(v), strict=True)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx)))
    assert got.shape == want.shape == (2, *hw, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_ATOL)


def test_vae_small_matches_jax():
    rng = np.random.default_rng(2)
    je, jd = jvae.Encoder(base=SMALL_VAE), jvae.Decoder(base=SMALL_VAE)
    img = rng.normal(size=(2, 48, 40, 3)).astype(np.float32)
    z = rng.normal(size=(2, 6, 5, 4)).astype(np.float32)
    ve = _draw(jax.eval_shape(je.init, jax.random.PRNGKey(0),
                              jnp.asarray(img)), 2)
    vd = _draw(jax.eval_shape(jd.init, jax.random.PRNGKey(0),
                              jnp.asarray(z)), 3)
    vae = tvae.AutoencoderKL(base=SMALL_VAE)
    vae.load_state_dict(W.state_dict_from_jax_vae(ve, vd), strict=True)
    mean, _ = jax.jit(je.apply)(ve, jnp.asarray(img))
    with torch.no_grad():
        got_mean = _nhwc(vae.encode_mean(_nchw(img)))
        got_dec = _nhwc(vae.decode(_nchw(z)))
    np.testing.assert_allclose(got_mean, np.asarray(mean), rtol=0,
                               atol=NET_ATOL)
    np.testing.assert_allclose(
        got_dec, np.asarray(jax.jit(jd.apply)(vd, jnp.asarray(z))), rtol=0,
        atol=NET_ATOL)


def _recording(sd):
    class Rec(dict):
        used = set()

        def __getitem__(self, k):
            self.used.add(k)
            return dict.__getitem__(self, k)
    return Rec(sd)


def test_full_width_keys_match_converters():
    """The full nets' keys (meta device) are exactly those convert_unet
    and convert_vae read."""
    from depthmap_tpu.models.marigold.convert import convert_unet, \
        convert_vae
    with torch.device("meta"):
        pipe = tmp.build_marigold()
    for net, convert in ((pipe.unet, convert_unet), (pipe.vae, convert_vae)):
        sd = _recording({k: np.zeros(t.shape, np.float32)
                         for k, t in net.state_dict().items()})
        convert(sd)
        assert set(sd) == sd.used
    n_unet = sum(t.numel() for t in pipe.unet.parameters())
    assert 860e6 < n_unet < 870e6       # SD2's 865.9M


def test_ensemble_depths_matches_jax():
    rng = np.random.default_rng(4)
    base = rng.random((24, 32))
    for n in (2, 3, 5):
        preds = np.stack([base * s + t + 0.01 * rng.random((24, 32))
                          for s, t in zip(rng.uniform(0.5, 2, n),
                                          rng.uniform(-1, 1, n))])
        np.testing.assert_allclose(tmp.ensemble_depths(preds),
                                   jmp.ensemble_depths(preds), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(tmp._lower_median(preds),
                                  jmp._lower_median(preds))


def _bf16(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  tree)


def _unet_case(seed: int, t: int):
    """JAX's UNet weights of ``jax_pipeline(seed)``, the port's UNet on them
    in bf16, and a seeded latent, context and timestep."""
    jvars = jax_pipeline(seed=seed).vars
    tm = torch_pipeline(jvars).unet.to(torch.bfloat16)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 12, 8, 8)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 64)).astype(np.float32)
    return jvars["unet"], tm, x, ctx, np.array([t, t], np.int32)


def test_unet_bf16_weights_promote_like_flax():
    """bf16 weights on f32 inputs: flax computes every layer in f32 on the
    bf16-rounded weights, and so does the port (no layer may compute in
    bf16 or cast its input down)."""
    jv, tm, x, ctx, t = _unet_case(6, 501)
    want = np.asarray(junet.MarigoldUNet(**SMALL_UNET).apply(
        _bf16(jv), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    assert want.dtype == np.float32
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=NET_ATOL)


@pytest.mark.parametrize("seed,t", [(6, 81), (8, 981)])
def test_unet_bf16_matches_jax(seed, t):
    """The pipeline's bf16 mode: bf16 weights, latent and context.  Flax's
    promotion runs the JAX UNet in bf16 up to the first ResBlock's
    time-embedding add and in f32 from there on (the cross-attention's keys
    and values of the bf16 context, and what they make, in bf16).  XLA's
    CPU bf16 convolutions do not round exactly (28% of conv_in's outputs
    one ulp off the exactly rounded ones, where torch's are exact), so the
    bar is relative: the port's mean distance to JAX's bf16 map stays under
    0.8 of the distance between JAX's f32 and bf16 maps.  Measured 0.49-0.67
    of it over three weight seeds and two timesteps; a UNet wholly in bf16
    lands at 1.25-1.39 of it, one wholly in f32 at 1.0."""
    jv, tm, x, ctx, ts = _unet_case(seed, t)
    jm = junet.MarigoldUNet(**SMALL_UNET)
    want = np.asarray(jm.apply(
        _bf16(jv), jnp.asarray(x, jnp.bfloat16), jnp.asarray(ts),
        jnp.asarray(ctx, jnp.bfloat16)).astype(jnp.float32))
    want32 = np.asarray(jm.apply(jv, jnp.asarray(x), jnp.asarray(ts),
                                 jnp.asarray(ctx)))
    with torch.no_grad():
        got = tm(_nchw(x).to(torch.bfloat16), torch.from_numpy(ts),
                 torch.from_numpy(ctx).to(torch.bfloat16))
    assert got.dtype == torch.float32      # promoted past the first add
    drift = np.abs(want32 - want).mean()
    assert np.abs(_nhwc(got.float()) - want).mean() < 0.8 * drift


def test_bf16_path_runs(monkeypatch):
    """DEPTHMAP_MARIGOLD_DTYPE=bfloat16: the weights in bf16, the latents
    f32, the map near JAX's bf16 pipeline's on the same weights and noise.
    Both VAEs run wholly in bf16, where XLA's CPU convolutions round
    differently from torch's, so the maps agree to 0.03 (measured 0.0165;
    JAX's own f32 map stands 0.0141 from its bf16 one): the UNet's
    precision is held by test_unet_bf16_matches_jax."""
    jpipe = jax_pipeline(seed=6)
    rgb = np.stack([_image(19, 48, 64), _image(20, 48, 64)])
    monkeypatch.setenv("DEPTHMAP_MARIGOLD_DTYPE", "bfloat16")
    assert tmp.marigold_dtype() == torch.bfloat16
    pipe = torch_pipeline(jpipe.vars).to(tmp.marigold_dtype())
    assert pipe.compute_dtype == torch.bfloat16
    j16 = jmp.MarigoldPipeline(jpipe.vars, compute_dtype=jnp.bfloat16,
                               encoder=jpipe.encoder, decoder=jpipe.decoder,
                               unet=jpipe.unet)
    want = np.asarray(j16.single_infer(
        rgb, 2, jax.random.split(jax.random.PRNGKey(7), 2)))
    got = pipe.single_infer(_nchw(rgb).contiguous(), 2,
                            jax_noise(2, 6, 8, 7)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.03)


def test_strict_load_from_diffusers_tree(tmp_path, monkeypatch):
    """A diffusers tree (the VAE under its older attention names, as 1x1
    convs) loads strictly into DepthPredictor(10); without a text encoder
    the empty prompt's embedding is zeros."""
    monkeypatch.setattr(tmp, "build_marigold", lambda: torch_pipeline())
    jpipe = jax_pipeline(seed=8)
    unet = W.state_dict_from_jax_unet(jpipe.vars["unet"])
    vae = {}
    for k, v in W.state_dict_from_jax_vae(jpipe.vars["encoder"],
                                          jpipe.vars["decoder"]).items():
        for new, old in (("to_q", "query"), ("to_k", "key"),
                         ("to_v", "value"), ("to_out.0", "proj_attn")):
            if f".attentions.0.{new}." in k:
                k = k.replace(f".{new}.", f".{old}.")
                v = v[:, :, None, None] if v.dim() == 2 else v
        vae[k] = v
    for sub, sd in (("unet", unet), ("vae", vae)):
        os.makedirs(tmp_path / "marigold" / sub)
        torch.save(sd, tmp_path / "marigold" / sub /
                   "diffusion_pytorch_model.bin")
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    tp = DepthPredictor(10, weights_dir=str(tmp_path), device="cpu")
    want = torch_pipeline(jpipe.vars).state_dict()
    got = tp.bundle.module.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
