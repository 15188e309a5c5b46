"""K1's gradient, the SILog train step and the differentiable StdConv of
the port against the JAX package's, on the CPU.

- ``FlashAttentionFunction`` (K1's forward, a backward in torch): dq, dk,
  dv and dbias against autograd through ``flash_attention_plain`` and
  against ``jax.grad`` of ``depthmap_tpu.models.attention.attention_xla``
  (the function the JAX train step differentiates at these shapes), for a
  shared bias, a per-batch bias, a padded-row bias and Nk != N; f32, atol
  1e-5 (the outputs' ulps at these magnitudes are ~1e-7; the three
  versions sum the products in other orders).
- ``silog_loss`` / ``grad_l1_loss`` and their gradients against JAX's:
  rtol 1e-5.
- One step of ``make_train_step`` at world 1 on the multichip dryrun's
  tiny ViT DPT, weights carried from the JAX tree by
  ``state_dict_from_jax``, against JAX's ``make_train_step`` on a
  one-device mesh: the loss (rtol 1e-5), the gradients before Adam
  (STEP_GRAD_RTOL), then the updated parameters.
- The gradients of the tiny ViT, BEiT (its rel-pos tables too) and hybrid
  (its StdConvs) DPTs against ``jax.grad``, both backpropagating one
  cotangent drawn with numpy, positive so that a bias's sum over pixels
  does not cancel (VJP_RTOL).

Gradients are held per tensor to a share of the tensor's largest
magnitude.  VJP_RTOL 2e-5: the forwards agree to ~2e-6 of the output's
range and the backward sums the same products in another order (measured
2.4e-6 on the ViT, 6.4e-6 on the BEiT).  STEP_GRAD_RTOL 3e-3: the step's
loss takes log(max(pred, 0) + 1e-3), whose gradient 1 / (pred + 1e-3)
moves by d / 1e-3 of itself where the ReLU head leaves pred near 0 and
the two forwards differ by d (~3e-6 here), so the loss's gradient differs
by up to ~3e-3 of itself there (measured 5.5e-4 on the ViT; 1e-3 on the
BEiT).  Adam's first step moves a parameter by ~lr x sign(g): it flips
where a gradient is near 0, so the updated parameters are held to 2 x lr
+ 1e-6 everywhere and to 1e-6 where |g| is above STEP_GRAD_RTOL of its
tensor's largest.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmap_tpu_torch.graft_entry import (LEARNING_RATE, TINY_FEATURES,
                                            TINY_REASSEMBLE, TINY_VIT,
                                            dryrun_batch)
from depthmap_tpu_torch.models.weights import state_dict_from_jax
from depthmap_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction, flash_attention, flash_attention_plain,
    pad_bias_rows)
from depthmap_tpu_torch.parallel.train import (depth_loss, grad_l1_loss,
                                               make_train_step, silog_loss)
from tests.test_torch_port_midas import _draw
from tests.test_torch_port_midas import small_encoders  # noqa: F401

VJP_RTOL = 2e-5
STEP_GRAD_RTOL = 3e-3
K1_GRAD_ATOL = 1e-5


# -- K1's gradient --------------------------------------------------------

def _attention_inputs(seed, b, h, n, nk, bias_batch):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, m, 64)).astype(np.float32)
               for m in (n, nk, nk))
    bias = None if bias_batch is None else rng.normal(
        size=(bias_batch, h, n, nk)).astype(np.float32)
    dout = rng.normal(size=(b, h, n, 64)).astype(np.float32)
    return q, k, v, bias, dout


def _torch_grads(fn, q, k, v, bias, dout, padded=False):
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    b = None
    if bias is not None:
        b = torch.from_numpy(bias).requires_grad_()
        ins.append(b)
        if padded:   # the padded-row view models/beit.py gathers into
            b = pad_bias_rows(b)
    out = fn(*ins[:3], b)
    grads = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), ins)
    return out, [g.numpy() for g in grads]


CASES = {"shared": (2, 3, 40, 40, 1), "per_batch": (2, 3, 40, 40, 2),
         "nk_ne_n": (2, 2, 33, 77, 1), "bias_free": (3, 2, 50, 50, None)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_gradient_matches_plain_and_jax(case):
    b, h, n, nk, bb = CASES[case]
    q, k, v, bias, dout = _attention_inputs(11, b, h, n, nk, bb)
    out, got = _torch_grads(flash_attention, q, k, v, bias, dout)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__.startswith("FlashAttentionFunction")
    _, plain = _torch_grads(flash_attention_plain, q, k, v, bias, dout)
    from depthmap_tpu.models.attention import attention_xla
    args = (q, k, v) if bias is None else (q, k, v, bias)
    want = jax.grad(lambda *a: jnp.sum(attention_xla(*a) * dout),
                    argnums=tuple(range(len(args))))(*args)
    assert len(got) == len(want) == len(plain)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g, p, rtol=0, atol=K1_GRAD_ATOL)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=K1_GRAD_ATOL)


def test_k1_gradient_reaches_a_padded_row_bias():
    """The bias as models/beit.py hands it to K1 (the [..., :Nk] view of
    rows padded to 16): dbias reaches the dense tensor it was copied from
    through the view."""
    q, k, v, bias, dout = _attention_inputs(12, 2, 2, 25, 25, 1)
    _, dense = _torch_grads(flash_attention, q, k, v, bias, dout)
    _, padded = _torch_grads(flash_attention, q, k, v, bias, dout,
                             padded=True)
    for a, b in zip(dense, padded):
        np.testing.assert_array_equal(a, b)


def test_k1_without_grad_saves_nothing():
    """Under no_grad, or with no input that requires grad, the forward
    runs alone: its output is the plain forward's, bit for bit, and has no
    graph."""
    q, k, v, bias, _ = _attention_inputs(13, 1, 2, 20, 20, 1)
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    plain = flash_attention_plain(*t)
    out = flash_attention(*t)
    assert out.grad_fn is None
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    with torch.no_grad():
        out = flash_attention(*[x.requires_grad_() for x in t])
    assert out.grad_fn is None and not out.requires_grad
    # with grad: the Function, the same forward values
    out = FlashAttentionFunction.apply(*t, 0.125)
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)


# -- the losses -----------------------------------------------------------

def test_losses_and_their_gradients_match_jax():
    from depthmap_tpu.parallel import train as jtrain
    rng = np.random.default_rng(3)
    pred = rng.random((2, 24, 20)).astype(np.float32) + 0.1
    target = rng.random((2, 24, 20)).astype(np.float32) + 0.5
    for tfn, jfn in ((silog_loss, jtrain.silog_loss),
                     (grad_l1_loss, jtrain.grad_l1_loss)):
        p = torch.from_numpy(pred).requires_grad_()
        loss = tfn(p, torch.from_numpy(target))
        loss.backward()
        jl, jg = jax.value_and_grad(jfn)(pred, target)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5 * np.abs(jg).max())


# -- the models' gradients against jax.grad ------------------------------

def _jax_loss(module, images, targets, cotangent=None):
    """The JAX step's loss on the module's output; with a cotangent, the
    sum of the output times it instead."""
    from depthmap_tpu.parallel.train import grad_l1_loss as jgl1
    from depthmap_tpu.parallel.train import silog_loss as jsilog

    def loss(variables):
        pred = module.apply(variables, images, train=False)
        if cotangent is not None:
            return jnp.sum(pred * cotangent)
        return jsilog(jnp.maximum(pred, 0.0) + 1e-3, targets) + \
            0.1 * jgl1(pred, targets)
    return loss


def _jax_value_and_grads(module, variables, images, targets,
                         cotangent=None):
    """(loss, {torch key: gradient}) of the JAX module at ``variables``,
    the gradient tree carried to the port's keys by the inverse
    converter (linear in the leaves)."""
    loss, g = jax.jit(jax.value_and_grad(_jax_loss(
        module, images, targets, cotangent)))(variables)
    g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), g)
    return float(loss), {k: v.numpy() for k, v in
                         state_dict_from_jax(g).items()}


def _torch_value_and_grads(model, images, targets, cotangent=None):
    model.eval()
    pred = model(torch.from_numpy(np.ascontiguousarray(
        images.transpose(0, 3, 1, 2))))
    if cotangent is not None:
        loss = (pred * torch.from_numpy(cotangent)).sum()
    else:
        loss = depth_loss(pred, torch.from_numpy(targets))
    loss.backward()
    return float(loss), {k: p.grad.numpy() for k, p in
                         model.named_parameters()}


def assert_grads_close(got, want, keys, rtol):
    """Each tensor within ``rtol`` of its largest |gradient|; none all
    zero."""
    for k in keys:
        g, w = got[k], want[k]
        scale = float(np.abs(w).max())
        assert scale > 0, k
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, (k, err, scale)


def tiny_vit_jax():
    from depthmap_tpu.models.dpt import DPTDepthModel
    from depthmap_tpu.models.vit import VitBackbone
    return DPTDepthModel(backbone=VitBackbone(**TINY_VIT),
                         reassemble_channels=TINY_REASSEMBLE,
                         features=TINY_FEATURES)


def tiny_vit_torch(variables):
    from depthmap_tpu_torch.models import vit
    from depthmap_tpu_torch.models.dpt import DPTDepthModel
    m = DPTDepthModel(vit.VitBackbone(**TINY_VIT), TINY_REASSEMBLE,
                      TINY_FEATURES)
    m.load_state_dict(state_dict_from_jax(variables), strict=True)
    return m


def tiny_vit_variables(seed: int = 0):
    shapes = jax.eval_shape(tiny_vit_jax().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    return _draw(shapes, seed)


def _nhwc_batch(batch: int):
    images, targets = dryrun_batch(batch)
    return images.numpy().transpose(0, 2, 3, 1).copy(), targets.numpy()


def test_train_step_world_1_matches_jax():
    """make_train_step without a mesh against JAX's make_train_step on a
    one-device mesh: the loss, the gradients before Adam, the updated
    parameters."""
    import optax
    from depthmap_tpu.parallel.mesh import make_mesh as jmake_mesh
    from depthmap_tpu.parallel.train import make_train_step as jmake_step
    variables = tiny_vit_variables(1)
    images, targets = _nhwc_batch(2)
    model = tiny_vit_torch(variables)
    step = make_train_step(model, functools.partial(torch.optim.Adam,
                                                    lr=LEARNING_RATE))
    loss = float(step(*dryrun_batch(2)))
    got_g = {k: p.grad.numpy() for k, p in model.named_parameters()}
    want_loss, want_g = _jax_value_and_grads(tiny_vit_jax(), variables,
                                             images, targets)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert_grads_close(got_g, want_g, got_g, STEP_GRAD_RTOL)

    mesh = jmake_mesh(1)
    with mesh:
        params, opt_state, jstep = jmake_step(
            tiny_vit_jax(), optax.adam(LEARNING_RATE), mesh)(
                jax.tree_util.tree_map(jnp.asarray, variables))
        params, _, jloss = jstep(params, opt_state, (images, targets))
    np.testing.assert_allclose(float(jloss), want_loss, rtol=1e-6)
    want_p = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    before = state_dict_from_jax(variables)
    flips = 0
    for k, p in model.named_parameters():
        got, want = p.detach().numpy(), want_p[k]
        moved = np.abs(want - before[k].numpy())
        assert moved.max() > 0.5 * LEARNING_RATE, k   # Adam moved it
        err = np.abs(got - want)
        assert err.max() <= 2 * LEARNING_RATE + 1e-6, (k, err.max())
        firm = np.abs(want_g[k]) > STEP_GRAD_RTOL * np.abs(want_g[k]).max()
        assert err[firm].max(initial=0) <= 1e-6, (k, err[firm].max())
        flips += int((err > 1e-6).sum())
    assert flips <= 1e-3 * sum(p.numel() for p in model.parameters())


def _vjp_case(seed: int, shape):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(*shape, 3)).astype(np.float32)
    # positive, so the sums over pixels (a bias's gradient) do not cancel
    cotangent = (rng.random(shape) + 0.5).astype(np.float32)
    return images, cotangent


def test_tiny_vit_gradients_match_jax():
    variables = tiny_vit_variables(2)
    images, cot = _vjp_case(2, (2, 64, 64))
    loss, got = _torch_value_and_grads(tiny_vit_torch(variables), images,
                                       None, cot)
    want_loss, want = _jax_value_and_grads(tiny_vit_jax(), variables,
                                           images, None, cot)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    assert_grads_close(got, want, got, VJP_RTOL)


def test_tiny_beit_gradients_match_jax():
    """Every parameter's gradient, the rel-pos tables' (through the
    gather into K1's padded-row bias and the table resize at a 4 x 6 grid)
    too."""
    from tests.test_torch_port_model import (jax_small_module,
                                             jax_small_variables,
                                             torch_small_module)
    variables = jax_small_variables(5)
    images, cot = _vjp_case(5, (2, 64, 96))
    loss, got = _torch_value_and_grads(torch_small_module(variables),
                                       images, None, cot)
    want_loss, want = _jax_value_and_grads(jax_small_module(), variables,
                                           images, None, cot)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    tables = [k for k in got if k.endswith("relative_position_bias_table")]
    assert len(tables) == 4
    assert_grads_close(got, want, got, VJP_RTOL)


def test_tiny_hybrid_stdconv_gradients_match_jax(small_encoders):
    """The hybrid's weight-standardized convs carry a gradient to their
    raw weights (the value from the cache a no-grad forward filled) equal
    to JAX's."""
    from tests.test_torch_port_midas import (jax_model, jax_variables,
                                             torch_model)
    variables = jax_variables("hybrid", 9)
    images, cot = _vjp_case(9, (1, 80, 112))
    model = torch_model("hybrid", variables)
    with torch.no_grad():      # the inference cache filled first
        model(torch.zeros(1, 3, 80, 112))
    loss, got = _torch_value_and_grads(model, images, None, cot)
    want_loss, want = _jax_value_and_grads(jax_model("hybrid"), variables,
                                           images, None, cot)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    convs = [k for k in got if ".patch_embed.backbone." in k and
             ".conv" in k and k.endswith("weight")]
    assert len(convs) >= 10
    assert_grads_close(got, want, got, VJP_RTOL)
