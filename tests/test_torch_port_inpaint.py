"""The 3D photo on the port against the JAX package's (CPU).

* the three inpainting nets at full width on a 128 x 128 crop, f32, to
  1e-5: the JAX variables come from the JAX converter reading seeded
  random checkpoints in the reference layout (the edge net spectral-normed)
  and go into the port through ``state_dict_from_jax_inpaint``; the port's
  own loader folds the spectral norm to the same weights; the full-width
  key layouts equal what the converters consume (meta device);
  ``spectral_weight`` against ``spectral_fold`` (dim 1 for transposed
  convs);
* the weighted-median filter and ``sparse_bilateral_filtering`` exactly
  (64 x 80, planted discontinuities, windows 7 and 5);
* ``tear_sets``, ``reassign_floating_islands`` and ``edge_pixel_groups``
  exactly on the scenes of tests/test_ldi_fidelity.py (restated here);
* ``build_ldi`` with each package's nets on the same checkpoints: faces
  equal, vertices within 1e-5 of the depth range, colours within 1;
* OBJ and PLY (binary, ascii) byte-equal to the JAX writer's for one mesh,
  and ``read_mesh`` round trips;
* the renderer on the scene of tests/test_render.py at 3 cameras: taps
  and z-buffer within 1e-5 relative, raw frames within 1e-6 (the same
  winning taps), uint8 frames equal on >= 99.9% of the pixels, |d| <= 1;
  the same K per camera; the chunk size leaves the frame unchanged;
* the cv2 restatements against cv2 (blur 3 x 3 on f32 to 1e-6, the uint8
  Gaussian at k = 3, 5, 7 and INTER_AREA at factors 2 and 3 byte for
  byte; Telea's inpainting byte for byte), and ``build_ldi`` without nets
  (Telea's fill) equal to the JAX package's;
* ``path_planning`` exactly; ``run_3dphoto`` end to end (48 x 64, nets)
  with its demo frames (4 a trajectory) on >= 99.9% of the pixels;
* the funnel's ``inpainted_mesh`` path name, and a failing net raising
  where the JAX package falls back in silence.
"""
from __future__ import annotations

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmap_tpu.models import convert_inpaint as jci
from depthmap_tpu.models import inpaint_nets as jnets
from depthmap_tpu.models.convert import SDict
from depthmap_tpu.options import GenerationOptions as JOptions
from depthmap_tpu.pipeline import core as jcore
from depthmap_tpu.pipeline import inpaint_mesh as jim
from depthmap_tpu.pipeline import inpaint_video as jiv
from depthmap_tpu.pipeline import render as jr
from depthmap_tpu_torch.models import inpaint_nets as tnets
from depthmap_tpu_torch.models import weights as tw
from depthmap_tpu_torch.ops import filters as tfilters
from depthmap_tpu_torch.ops import resize as tresize
from depthmap_tpu_torch.options import GenerationOptions as TOptions
from depthmap_tpu_torch.pipeline import core as tcore
from depthmap_tpu_torch.pipeline import inpaint_mesh as tim
from depthmap_tpu_torch.pipeline import inpaint_video as tiv
from depthmap_tpu_torch.pipeline import render as tr

NET_TOL = 1e-5


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """Seeded random-init checkpoints in the reference's layout."""
    d = tmp_path_factory.mktemp("3dphoto")
    tw.save_random_inpaint_checkpoints(str(d), seed=3)
    return str(d)


@pytest.fixture(scope="module")
def nets(ckpt_dir):
    """Each package's nets on the same checkpoints: (JAX callables, port
    callables on the CPU)."""
    return (jim.build_inpaint_callables(ckpt_dir),
            tim.build_inpaint_callables(ckpt_dir, device="cpu"))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                              (0, 3, 1, 2))))


# -- the nets ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["edge", "depth", "color"])
def test_nets_match_jax(ckpt_dir, name):
    """Full width on a 128 x 128 crop: JAX's variables (its converter on
    the checkpoint) carried into the port, to NET_TOL; the port's own
    loader gives the same weights."""
    variables = jci.load_inpaint_nets(ckpt_dir)[name]
    sd = tw.state_dict_from_jax(variables)
    port = {"edge": tnets.InpaintEdgeNet, "depth": tnets.InpaintDepthNet,
            "color": tnets.InpaintColorNet}[name]()
    port.load_state_dict(sd, strict=True)
    port.eval()
    loaded = tw.load_inpaint_nets(ckpt_dir)[name].state_dict()
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        np.testing.assert_allclose(loaded[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    rng = np.random.default_rng(5)
    h = w = 128

    def plane(c=1):
        return rng.random((1, h, w, c)).astype(np.float32)
    ctx = (plane() > 0.4).astype(np.float32)
    mask = (1 - ctx) * (plane() > 0.3).astype(np.float32)
    if name == "edge":
        args = (plane(7),)
        jm = jnets.InpaintEdgeNet()
    elif name == "depth":
        args = (3 + 5 * plane(), plane(), ctx, mask)
        jm = jnets.InpaintDepthNet()
    else:
        args = (plane(3), plane(), ctx, mask)
        jm = jnets.InpaintColorNet()
    want = np.asarray(jm.apply(variables, *(jnp.asarray(a) for a in args)))
    with torch.no_grad():
        got = port(*(_nchw(a) for a in args)).numpy().transpose(0, 2, 3, 1)
    assert np.ptp(want) > 0.01
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=NET_TOL * max(1.0, np.abs(want).max()))


def _zeros_sd(module):
    return SDict({k: np.broadcast_to(np.float32(0), tuple(v.shape))
                  for k, v in module.state_dict().items()})


def test_full_width_layouts_match_converters():
    """The reference layout of each full-width net (the edge net with its
    spectral-norm triples) is exactly what convert_inpaint consumes, and
    the port's modules hold its keys with each triple folded to one
    weight."""
    with torch.device("meta"):
        edge = tnets.InpaintEdgeNet()
        keys = set(edge.state_dict())
        wrapped = tw.edge_net_with_spectral_norm(tnets.InpaintEdgeNet())
        depth, color = tnets.InpaintDepthNet(), tnets.InpaintColorNet()
    s = _zeros_sd(wrapped)
    with np.errstate(divide="ignore", invalid="ignore"):
        jci.convert_edge_net(s)
    assert s.unused() == []
    folded = {k.replace("_orig", "") for k in s.sd
              if not k.endswith(("_u", "_v"))}
    assert folded == keys
    assert sum(k.endswith("weight_orig") for k in s.sd) == 21
    for module, conv in ((depth, jci.convert_depth_inpaint),
                         (color, jci.convert_color_inpaint)):
        s = _zeros_sd(module)
        conv(s)
        assert s.unused() == []
    assert "dec_1A.conv.input_conv.bias" in color.state_dict()
    assert "enc_2.conv.input_conv.bias" in depth.state_dict()
    assert "enc_2.conv.input_conv.bias" not in color.state_dict()


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("with_v", [True, False])
def test_spectral_fold_matches_jax(transposed, with_v):
    rng = np.random.default_rng(7)
    shape = (6, 6, 4, 4)        # square: only the dim tells them apart
    w = rng.normal(size=shape).astype(np.float32)
    u = rng.normal(size=6).astype(np.float32)
    u /= np.linalg.norm(u)
    v = rng.normal(size=6 * 16).astype(np.float32)
    v /= np.linalg.norm(v)
    raw = {"m.weight_orig": torch.from_numpy(w),
           "m.weight_u": torch.from_numpy(u)}
    if with_v:
        raw["m.weight_v"] = torch.from_numpy(v)
    want = jci.spectral_weight(SDict(raw), "m", transpose=transposed)
    got = tw.spectral_fold(w, u, v if with_v else None, transposed)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tw.spectral_fold(w[:, :3], u, None, True)


def test_inpaint_checkpoint_rules(tmp_path):
    """None only without any checkpoint; some missing or one unreadable
    raises (the JAX package returns None for both)."""
    assert tw.load_inpaint_nets(str(tmp_path)) is None
    assert tim.build_inpaint_callables(str(tmp_path), device="cpu") is None
    (tmp_path / "depth_model.pth").write_bytes(b"not a checkpoint")
    with pytest.raises(FileNotFoundError):
        tim.build_inpaint_callables(str(tmp_path), device="cpu")
    for name in ("edge-model.pth", "color-model.pth"):
        (tmp_path / name).write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        tim.build_inpaint_callables(str(tmp_path), device="cpu")


# -- the filter ---------------------------------------------------------------

def _planted_depth(seed, h=64, w=80):
    rng = np.random.default_rng(seed)
    depth = 1.0 / np.maximum(rng.random((h, w)) * 3, 0.05)
    depth = np.round(depth, 1)            # ties inside windows
    depth[10:30, 20:50] *= 3
    depth[40:60, 5:25] = 0.7
    return depth.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_median_exact(seed):
    depth = _planted_depth(seed)
    disc = jim.vis_depth_discontinuity(depth, 0.04)
    np.testing.assert_array_equal(
        tim.vis_depth_discontinuity(depth, 0.04), disc)
    for window in (7, 5):
        want = np.asarray(jim._weighted_median_filter(depth, disc, window))
        got = tim.weighted_median_filter(torch.from_numpy(depth),
                                         torch.from_numpy(disc), window)
        assert (want != depth).sum() > 100
        np.testing.assert_array_equal(got.numpy(), want)
    _, want = jim.sparse_bilateral_filtering(depth.copy(), None,
                                             [7, 7, 5, 5, 5], 0.04, 5)
    _, got = tim.sparse_bilateral_filtering(depth.copy(), None,
                                            [7, 7, 5, 5, 5], 0.04, 5,
                                            device="cpu")
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_blocked_cumsum_is_xla_cpu_cumsum():
    """The median's weight sums: the port's blocked f32 scan against
    jnp.cumsum on every count of 1/n weights at random positions."""
    rng = np.random.default_rng(8)
    f = jax.jit(lambda a: jnp.cumsum(a, axis=-1))
    for k2 in (9, 25, 49):
        rows = []
        for n in range(1, k2 + 1):
            for _ in range(4):
                v = np.zeros(k2, np.float32)
                v[rng.choice(k2, n, replace=False)] = \
                    np.float32(1) / np.float32(n)
                rows.append(v)
        x = np.stack(rows)
        np.testing.assert_array_equal(
            tim._blocked_cumsum(torch.from_numpy(x)).numpy(),
            np.asarray(f(jnp.asarray(x))))


# -- the LDI's graph stages ---------------------------------------------------

def make_nested_scene(H=96, W=128):
    rng = np.random.default_rng(0)
    depth = np.full((H, W), 10.0)
    depth[20:80, 30:110] = 5.0
    depth[35:65, 50:90] = 2.0
    depth += rng.normal(scale=0.01, size=depth.shape)
    img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    return img, depth


def make_staircase_scene(H=64, W=96):
    depth = np.full((H, W), 8.0)
    for i, d in enumerate([6.0, 4.0, 2.5, 1.5]):
        depth[:, 20 + i * 18: 20 + (i + 1) * 18] = d
    return np.zeros((H, W, 3), np.uint8), depth


def make_dangling_scene(H=48, W=64):
    depth = np.full((H, W), 10.0)
    depth[:, 32:] = 3.0
    for y in (10, 25, 37):
        depth[y, 32:] = 10.0
    return np.zeros((H, W, 3), np.uint8), depth


def make_island_scene(H=64, W=96):
    depth = np.full((H, W), 10.0)
    depth[20:50, 10:60] = 5.0
    depth[30:36, 70:78] = 1.0          # a floating speck
    depth[19:22, 30:34] = 1.0          # one straddling a border
    return np.zeros((H, W, 3), np.uint8), depth


def make_noisy_scene(H=56, W=72):
    """Blocks of random depth: hundreds of islands and edge groups, as a
    random-init model's map gives them."""
    rng = np.random.default_rng(14)
    depth = 2.0 + 6.0 * rng.random((H // 4, W // 4)).repeat(4, 0).repeat(
        4, 1)
    depth[10:40, 16:56] = 1.5
    img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    return img, depth


SCENES = {"nested": make_nested_scene, "staircase": make_staircase_scene,
          "dangling": make_dangling_scene, "island": make_island_scene,
          "noisy": make_noisy_scene}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_ldi_graph_stages_equal_jax(scene):
    _, depth = SCENES[scene]()
    disp = 1.0 / depth
    for a, b in zip(tim.tear_sets(disp, 0.04), jim.tear_sets(disp, 0.04)):
        np.testing.assert_array_equal(a, b)
    dh, dv = jim.tear_sets(disp, 0.04)
    for a, b in zip(tim.edge_pixel_groups(dh, dv, 12),
                    jim.edge_pixel_groups(dh, dv, 12)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tim.grid_components(dh, dv),
                    jim.grid_components(dh, dv)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tim._far_side_mask(disp, dh, dv),
                                  jim._far_side_mask(disp, dh, dv))
    got, changed = tim.reassign_floating_islands(depth, 0.04)
    want, jchanged = jim.reassign_floating_islands(depth, 0.04)
    assert changed == jchanged
    np.testing.assert_array_equal(got, want)
    assert changed or scene not in ("island", "noisy")


def _ldi_input(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    depth = np.full((h, w), 6.0, np.float32)
    depth[10:36, 14:46] = 2.5
    depth[18:28, 22:34] = 1.2
    depth += rng.normal(scale=0.005, size=depth.shape).astype(np.float32)
    int_mtx = np.array([[1.0, 0, 0.5], [0, 4 / 3, 0.5], [0, 0, 1]],
                       np.float32)
    return img, depth, int_mtx


def assert_meshes_close(got, want):
    """Faces equal, vertices within 1e-5 of the mesh's depth range,
    colours within 1 of 255 (the depth net's f32 output differs between
    the frameworks by ~1e-6 of its range, which is the depth's)."""
    gv, gc, gf = (np.asarray(a) for a in got[:3])
    wv, wc, wf = (np.asarray(a) for a in want[:3])
    np.testing.assert_array_equal(gf, wf)
    assert gv.shape == wv.shape and gc.shape == wc.shape
    err = np.abs(gv - wv).max(axis=1)
    assert err.max() <= 1e-5 * np.abs(wv[:, 2]).max(), err.max()
    scale = 255.0 if wc.max() <= 1.0 + 1e-6 else 1.0
    assert np.abs(gc.astype(np.float64) - wc).max() * scale <= 1 + 1e-6


def test_build_ldi_with_nets_matches_jax(nets):
    jn, tn = nets
    img, depth, int_mtx = _ldi_input(4)
    want = jim.build_ldi(img, depth, int_mtx, tiv.CONFIG, jn)
    before = sum(tim.net_calls.values())
    got = tim.build_ldi(img, depth, int_mtx, tiv.CONFIG, tn)
    calls = sum(tim.net_calls.values()) - before
    assert calls > 0 and calls % 3 == 0
    assert len(got[0]) > 48 * 64             # background bands were made
    assert got[3] == want[3]
    assert_meshes_close(got, want)


def test_failing_net_raises(nets):
    """A net that fails raises out of build_ldi (the JAX package falls back
    to its diffusion fill in silence)."""
    _, tn = nets

    def broken(*args):
        raise RuntimeError("net failed")
    img, depth, int_mtx = _ldi_input(5)
    with pytest.raises(RuntimeError, match="net failed"):
        tim.build_ldi(img, depth, int_mtx, tiv.CONFIG, dict(tn, edge=broken))
    jverts = jim.build_ldi(img, depth, int_mtx, tiv.CONFIG,
                           dict(nets[0], edge=broken))[0]
    assert len(jverts) > 48 * 64


# -- mesh files ---------------------------------------------------------------

def test_mesh_files_byte_equal(tmp_path):
    rng = np.random.default_rng(9)
    verts = rng.normal(size=(50, 3)) * [1, 1, 3] - [0, 0, 4]
    colors = (rng.random((50, 3)) * 255).astype(np.uint8)
    faces = rng.integers(0, 50, (70, 3))
    args = (verts, colors, faces, 6, 8, 0.9, 0.7, 3.25)
    for fmt, ply in (("obj", "bin"), ("ply", "bin"), ("ply", "ascii")):
        jp, tp = (str(tmp_path / f"{k}_{ply}.{fmt}") for k in "jt")
        jim.write_mesh_file(jp, *args, fmt=fmt, ply_fmt=ply)
        tim.write_mesh_file(tp, *args, fmt=fmt, ply_fmt=ply)
        assert open(tp, "rb").read() == open(jp, "rb").read()
        got, want = tim.read_mesh(tp), jim.read_mesh(jp)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w
        np.testing.assert_array_equal(got[2], faces)
    with pytest.raises(ValueError):
        tim.read_mesh(str(tmp_path / "mesh.stl"))


# -- the renderer -------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_mesh():
    """tests/test_render.py's nested-occlusion mesh (the JAX LDI with its
    diffusion fill)."""
    H, W = 48, 64
    rng = np.random.default_rng(0)
    depth = np.full((H, W), 10.0)
    depth[12:36, 16:48] = 5.0
    depth[18:30, 24:40] = 2.0
    img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    int_mtx = np.array([[max(H, W), 0, W / 2.], [0, max(H, W), H / 2.],
                        [0, 0, 1]])
    cfg = {"depth_threshold": 0.04, "background_thickness": 70}
    verts, colors, faces, _ = jim.build_ldi(img, depth, int_mtx, cfg)
    hfov = 2 * np.arctan(0.5 * W / (int_mtx[0, 0] * W))
    vfov = 2 * np.arctan(0.5 * H / (int_mtx[1, 1] * H))
    return (np.asarray(verts), np.asarray(colors), np.asarray(faces),
            max(hfov, vfov))


CAMERAS = [(0.0, 0.0, 0.0), (0.02, -0.015, -0.03), (-0.03, 0.02, 0.05)]


def test_raster_matches_jax(scene_mesh):
    verts, colors, faces, fov = scene_mesh
    size, off, total, frames = 64, 0, 0, []
    for cam in CAMERAS:
        jrend = jr.MeshRenderer(verts, colors, faces, fov, size)
        trend = tr.MeshRenderer(verts, colors, faces, fov, size,
                                device="cpu")
        want8 = jrend.render(np.asarray(cam))
        got8 = trend.render(np.asarray(cam))
        assert trend._K == jrend._K
        K, thf = trend._K, float(np.tan(fov / 2))
        # taps and z-buffer
        jpx = jr._project(jrend.verts, jnp.asarray(cam, jnp.float32), thf,
                          size)
        jidx, jz, _ = jr._face_taps(*jpx, jrend.colors,
                                    jnp.asarray(faces, jnp.int32), size, K)
        tpx = tr._project(trend.verts, torch.tensor(cam, dtype=torch.float32),
                          torch.tensor(thf), size)
        tidx, tz, _ = tr._face_taps(*tpx, trend.colors, trend.faces, size,
                                    K, False)
        jidx, jz = np.asarray(jidx), np.asarray(jz)
        np.testing.assert_array_equal(tidx.numpy(), jidx)
        ok = jidx < size * size
        np.testing.assert_allclose(tz.numpy()[ok], jz[ok], rtol=1e-5)
        zb = {}
        for k, (idx, z) in (("j", (jidx, jz)), ("t", (tidx.numpy(),
                                                      tz.numpy()))):
            zb[k] = np.full(size * size + 1, np.inf, np.float32)
            np.minimum.at(zb[k], idx, z)
        np.testing.assert_allclose(zb["t"], zb["j"], rtol=1e-5)
        # the frames: the same winning taps, colours rounded apart
        want = np.asarray(jr._raster(
            jrend.verts, jrend.colors, jrend.faces,
            jnp.asarray(cam, jnp.float32), thf, size, K, jrend._chunk))
        got = trend.render_device(np.asarray(cam)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        d = np.abs(got8.astype(int) - want8)
        assert d.max() <= 1
        off += int(d.any(-1).sum())
        total += size * size
        frames.append(got8)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tr, "TAPS_PER_CHUNK", 997)
            small = tr.MeshRenderer(verts, colors, faces, fov, size,
                                    device="cpu")
            np.testing.assert_array_equal(small.render(np.asarray(cam)),
                                          got8)
    assert off <= 0.001 * total, off


@pytest.mark.parametrize("ssaa", [1, 2])
def test_splat_matches_jax(scene_mesh, ssaa):
    verts, colors, faces, fov = scene_mesh
    off = total = 0
    for cam in CAMERAS:
        want = jr.MeshRenderer(verts, colors, faces, fov, 48, ssaa=ssaa,
                               method="splat").render(np.asarray(cam))
        got = tr.MeshRenderer(verts, colors, faces, fov, 48, ssaa=ssaa,
                              method="splat", device="cpu").render(
                                  np.asarray(cam))
        assert got.shape == want.shape == (48, 48, 3)
        off += int((got != want).any(-1).sum())
        total += 48 * 48
    assert off <= 0.001 * total, off


def test_footprint_ladder_matches_jax():
    """K grows with a dolly, never shrinks, as in the JAX renderer."""
    verts = np.array([[0.0, 0.0, -4.0], [0.3, 0.0, -4.0],
                      [0.0, 0.3, -4.0]], np.float32)
    colors = np.array([[1, 0, 0]] * 3, np.float32)
    faces = np.array([[0, 1, 2]])
    j = jr.MeshRenderer(verts, colors, faces, np.pi / 2, 48)
    t = tr.MeshRenderer(verts, colors, faces, np.pi / 2, 48, device="cpu")
    for z in (0.0, -3.2, 0.0):
        cam = np.array([0.0, 0.0, z])
        np.testing.assert_array_equal(t.render(cam), j.render(cam))
        assert t._K == j._K


# -- cv2 restatements ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 53), (64, 64, 3), (9, 200, 3)])
def test_cv2_restatements(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape[:2]).astype(np.float32)
    np.testing.assert_allclose(tfilters.cv2_blur3(x),
                               cv2.blur(x, ksize=(3, 3)), rtol=0, atol=1e-6)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    for k in (3, 5, 7):
        np.testing.assert_array_equal(tfilters.cv2_gaussian_blur_u8(img, k),
                                      cv2.GaussianBlur(img, (k, k), 0))
    for f in (2, 3):
        h, w = shape[0] // f * f, shape[1] // f * f
        np.testing.assert_array_equal(
            tresize.cv2_resize_area_u8(img[:h, :w], (w // f, h // f)),
            cv2.resize(img[:h, :w], (w // f, h // f),
                       interpolation=cv2.INTER_AREA))
    with pytest.raises(ValueError):
        tresize.cv2_resize_area_u8(img, (shape[1] // 2 + 1, shape[0] // 2))


@pytest.mark.parametrize("seed", range(6))
def test_telea_equals_cv2(seed):
    """Telea's fill byte for byte against cv2.inpaint, radii 5 (the 3D
    photo's), 3 and 1, holes on the image's edges too."""
    from depthmap_tpu_torch.ops.inpaint_telea import inpaint_telea
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(8, 36, 2))
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    if seed % 2:      # smooth, where the gradient term matters
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.clip(np.stack([xx * 5, yy * 7, (xx + yy) * 3], -1)
                      + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
    mask = (rng.random((h, w)) > rng.uniform(0.6, 0.95)).astype(np.uint8)
    mask[h // 4:h // 2, w // 3:2 * w // 3] = 1
    mask[:, :seed % 3] = 1
    mask[-(seed % 2 + 1):, -2:] = 1
    for radius in (5, 3, 1):
        np.testing.assert_array_equal(
            inpaint_telea(img, mask, radius),
            cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA))
    np.testing.assert_array_equal(inpaint_telea(img, 0 * mask, 5), img)
    with pytest.raises(ValueError):
        inpaint_telea(img[..., 0], mask, 5)


@pytest.mark.parametrize("scene", ["planted", "noisy"])
def test_build_ldi_without_nets_equals_jax(scene):
    """No checkpoints: the 4-neighbour propagation and Telea's fill, the
    same mesh as the JAX package's (cv2.inpaint) to the last bit."""
    if scene == "noisy":
        img, depth = make_noisy_scene()
        int_mtx = np.array([[1.0, 0, 0.5], [0, 1.4, 0.5], [0, 0, 1]])
    else:
        img, depth, int_mtx = _ldi_input(13)
    got = tim.build_ldi(img, depth, int_mtx, tiv.CONFIG, None)
    want = jim.build_ldi(img, depth, int_mtx, tiv.CONFIG, None)
    assert len(got[0]) > depth.size
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


# -- trajectories, run_3dphoto, the funnel ------------------------------------

@pytest.mark.parametrize("path_type", ["straight-line",
                                       "double-straight-line", "circle"])
def test_path_planning_equal_jax(path_type):
    for n in (4, 30):
        for a, b in zip(tiv.path_planning(n, 0.02, -0.015, -0.05, path_type),
                        jiv.path_planning(n, 0.02, -0.015, -0.05, path_type)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tiv.path_planning(4, 0, 0, 0, "spiral")


def _capture_frames(monkeypatch, module, sink):
    def capture(fps, frames, path, name, *args):
        sink[name] = [np.asarray(f) for f in frames]
        return [os.path.join(path, name)]
    monkeypatch.setattr(module, "frames_to_video", capture)


def test_run_3dphoto_matches_jax(nets, tmp_path, monkeypatch):
    """48 x 64 with nets and the demos at 4 frames a trajectory: the OBJ as
    build_ldi holds it, the demo frames equal on >= 99.9% of the pixels."""
    jn, tn = nets
    rng = np.random.default_rng(11)
    img = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    dep = np.full((48, 64), 20000, np.int64)
    dep[10:35, 15:45] = 50000
    dep[20:30, 25:35] = 64000
    dep = (dep + rng.integers(0, 300, dep.shape)).astype(np.uint16)
    jframes, tframes = {}, {}
    _capture_frames(monkeypatch, jiv, jframes)
    _capture_frames(monkeypatch, tiv, tframes)
    real = jiv.run_3dphoto_videos
    monkeypatch.setattr(jiv, "run_3dphoto_videos",
                        lambda fi, b, o, n, *a: real(fi, b, o, 4, *a))
    monkeypatch.setattr(tiv, "DEMO_FRAMES", 4)
    jpath = jiv.run_3dphoto(None, [img], [dep], ["pic.png"],
                            str(tmp_path / "j"), True, 1, "mp4", nets=jn)
    tpath = tiv.run_3dphoto("cpu", [img], [dep], ["pic.png"],
                            str(tmp_path / "t"), True, 1, "mp4", nets=tn)
    assert os.path.basename(tpath) == os.path.basename(jpath) == \
        "pic-0000.obj"
    assert_meshes_close(tim.read_mesh(tpath), jim.read_mesh(jpath))
    assert sorted(tframes) == sorted(jframes) == [
        f"pic_{p}" for p in ("circle", "dolly-zoom-in", "swing",
                                  "zoom-in")]
    off = total = 0
    for name in jframes:
        assert len(tframes[name]) == len(jframes[name]) == 4
        for g, w in zip(tframes[name], jframes[name]):
            assert g.shape == w.shape and g.dtype == np.uint8
            off += int((g != w).any(-1).sum())
            total += g.shape[0] * g.shape[1]
    assert off <= 0.001 * total, (off, total)


def test_funnel_inpainted_mesh(ckpt_dir, tmp_path, monkeypatch):
    """Both funnels on a custom depth map, the nets read from
    ./models/3dphoto: the JAX funnel's mesh path, the mesh as build_ldi
    holds it; then a failing net raises out of the port's funnel where the
    JAX funnel still yields a mesh (its silent diffusion fallback)."""
    wd = tmp_path / "work"
    (wd / "models").mkdir(parents=True)
    os.symlink(ckpt_dir, wd / "models" / "3dphoto")
    monkeypatch.chdir(wd)
    rng = np.random.default_rng(12)
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    dm = np.full((40, 56), 0.3)
    dm[8:30, 12:40] = 0.8
    dm[15:24, 20:30] = 0.97
    opts = dict(compute_device="CPU", gen_inpainted_mesh=True)
    out = {}
    for key, funnel, options in (("j", jcore, JOptions), ("t", tcore,
                                                          TOptions)):
        res = list(funnel.core_generation_funnel(
            str(tmp_path / key), [img], [dm], ["photo.jpg"],
            options(**opts)))
        assert [t for _, t, _ in res] == ["depth", "inpainted_mesh"]
        out[key] = res[1][2]
    assert os.path.basename(out["t"]) == os.path.basename(out["j"]) == \
        "photo-0000.obj"
    assert_meshes_close(tim.read_mesh(out["t"]), jim.read_mesh(out["j"]))

    def broken_nets(*args, **kw):
        def broken(*a):
            raise RuntimeError("net failed")
        return {"edge": broken, "depth": broken, "color": broken}
    monkeypatch.setattr(tim, "build_inpaint_callables", broken_nets)
    monkeypatch.setattr(jim, "build_inpaint_callables", broken_nets)
    with pytest.raises(RuntimeError, match="net failed"):
        list(tcore.core_generation_funnel(
            str(tmp_path / "t2"), [img], [dm], None, TOptions(**opts)))
    res = list(jcore.core_generation_funnel(
        str(tmp_path / "j2"), [img], [dm], None, JOptions(**opts)))
    assert [t for _, t, _ in res] == ["depth", "inpainted_mesh"]


def test_cli_inpainted_mesh(tmp_path):
    """``--inpainted-mesh`` on the CPU with a custom depth map and no
    checkpoints (Telea's fill): the OBJ lands in the output directory."""
    import subprocess
    import sys
    from PIL import Image
    rng = np.random.default_rng(15)
    img = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    dm = np.full((48, 64), 20000, np.uint16)       # a 16-bit PNG
    dm[10:35, 15:45] = 50000
    dm[20:30, 25:35] = 64000
    Image.fromarray(img).save(tmp_path / "pic.png")
    Image.fromarray(dm).save(tmp_path / "dm.png")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "depthmap_tpu_torch.cli",
         str(tmp_path / "pic.png"), "--depthmap", str(tmp_path / "dm.png"),
         "--inpainted-mesh", "--compute-device", "CPU", "--output",
         str(tmp_path / "out")], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert res.returncode == 0, res.stderr
    mesh = tmp_path / "out" / "pic-0000.obj"
    assert f"inpainted_mesh: {mesh}" in res.stdout
    verts = tim.read_mesh(str(mesh))[0]
    assert len(verts) > 48 * 64
