"""Entry points: the flagship forward, and the multi-device dryrun.

Port of the repository's ``__graft_entry__.py``.  ``entry`` gives the
forward of dpt_beit_large_512 (the BASELINE headline model) on a 512 x 512
input, on the card unless asked for the CPU.  ``dryrun_multichip(n)`` runs
one sharded train step of a tiny DPT in ``n`` gloo processes on the CPU
(data parallel on the batch, tensor parallel on the ViT blocks when ``n``
is even), then the four inference splits on a CPU device list of ``n``
(``_dryrun_inference_shards``), each held to its unsplit run.

Process groups join through a file store in a fresh temporary directory,
never a fixed port, and every join and collective times out.
"""
from __future__ import annotations

import functools
import os
import tempfile
import traceback
from typing import Callable, Tuple
from unittest import mock

import numpy as np
import torch

# the dryrun's tiny DPT: a 4-block ViT of width 32 with 2 heads, the same
# code path as the full models
TINY_VIT = dict(embed_dim=32, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
                train_grid=4)
TINY_REASSEMBLE = (16, 32, 48, 48)
TINY_FEATURES = 32
TINY_SIZE = 64
LEARNING_RATE = 1e-4
SPAWN_TIMEOUT_S = 300.0


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """(fn, (module, x)): ``fn(module, x)`` is the f32 forward of
    dpt_beit_large_512 (24 blocks, 1024 wide, seeded random weights) on
    ``x``, a (1, 3, 512, 512) zero input, both on ``device``."""
    from depthmap_tpu_torch.device import resolve_device
    from depthmap_tpu_torch.models.build import build_model
    from depthmap_tpu_torch.models.weights import init_random_
    from depthmap_tpu_torch.pipeline.depth import set_fp32_precision
    dev = resolve_device(device)
    set_fp32_precision(dev)
    module = init_random_(build_model(1).module, 0).to(dev).eval()
    x = torch.zeros((1, 3, 512, 512), device=dev)

    def fn(module, x):
        with torch.no_grad():
            return module(x)

    return fn, (module, x)


def tiny_dpt(seed: int = 0, backbone: str = "vit") -> torch.nn.Module:
    """The dryrun's tiny DPT ViT (``backbone="beit"``: a BEiT of the same
    width, with its rel-pos biases), seeded random weights."""
    from depthmap_tpu_torch.models import beit, vit
    from depthmap_tpu_torch.models.dpt import DPTDepthModel
    from depthmap_tpu_torch.models.weights import init_random_
    if backbone == "beit":
        body = beit.BeitBackbone(
            embed_dim=TINY_VIT["embed_dim"], depth=TINY_VIT["depth"],
            num_heads=TINY_VIT["num_heads"], hooks=TINY_VIT["hooks"],
            train_img_size=TINY_SIZE)
    else:
        body = vit.VitBackbone(**TINY_VIT)
    return init_random_(DPTDepthModel(body, TINY_REASSEMBLE, TINY_FEATURES),
                        seed)


def dryrun_batch(batch: int, seed: int = 0):
    """The dryrun's inputs: images ~ N(0, 1), NCHW, and targets
    U(0, 1) + 0.5, drawn with numpy as the JAX dryrun draws them (NHWC)."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, TINY_SIZE, TINY_SIZE, 3))
    targets = rng.random((batch, TINY_SIZE, TINY_SIZE)) + 0.5
    return (torch.from_numpy(images.transpose(0, 3, 1, 2).astype(
        np.float32)).contiguous(), torch.from_numpy(targets.astype(
            np.float32)))


def train_worker(rank: int, world: int, model_parallel: int,
                 batch: int, state: bool = False, backbone: str = "vit"):
    """One rank's sharded step of ``tiny_dpt(backbone=backbone)`` (Adam,
    LEARNING_RATE) on a (world / model_parallel, model_parallel) CPU mesh:
    (loss, mesh shape) and, with ``state``, the step's gradients and
    updated parameters gathered into the checkpoint's tensors (numpy
    dicts)."""
    from depthmap_tpu_torch.parallel.mesh import full_state_dict, make_mesh
    from depthmap_tpu_torch.parallel.train import make_train_step
    mesh = make_mesh(world, model_parallel=model_parallel,
                     device_type="cpu")
    step = make_train_step(tiny_dpt(backbone=backbone),
                           functools.partial(torch.optim.Adam,
                                             lr=LEARNING_RATE), mesh)
    loss = float(step(*dryrun_batch(batch)))
    shape = {"data": mesh["data"].size(), "model": mesh["model"].size()}
    if not state:
        return loss, shape
    grads = full_state_dict(step.model, mesh, grads=True)
    params = full_state_dict(step.model, mesh)
    return loss, shape, {k: v.numpy() for k, v in grads.items()}, \
        {k: v.numpy() for k, v in params.items()}


def _gloo_main(rank, world, store, timeout_s, fn, args, queue):
    import torch.distributed as dist
    from depthmap_tpu_torch.parallel.mesh import init_process_group
    torch.set_num_threads(1)
    try:
        init_process_group(rank, world, store, "cpu", timeout_s)
        try:
            queue.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:   # the parent reports it
        queue.put((rank, False, traceback.format_exc()))


def spawn_gloo(world: int, fn: Callable, args: tuple = (),
               timeout_s: float = SPAWN_TIMEOUT_S):
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined in a
    gloo group (a file store in a fresh temporary directory): rank 0's
    result.  Raises on a rank's error or after ``timeout_s``; every
    process is ended before it returns.  ``fn`` must be importable from a
    module.  The processes are spawned, so each imports the calling
    script's ``__main__``: a script that calls this must do its work
    under ``if __name__ == "__main__":``, or every child runs the script
    again instead of ``fn`` and the call times out."""
    import multiprocessing as mp
    import queue as queue_mod
    import time
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as store:
        results = ctx.Queue()
        procs = [ctx.Process(target=_gloo_main, daemon=True,
                             args=(rank, world, store, timeout_s, fn, args,
                                   results)) for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got = {}
        try:
            while len(got) < world:
                try:
                    rank, ok, value = results.get(
                        timeout=max(1.0, deadline - time.monotonic()))
                except queue_mod.Empty:
                    raise TimeoutError(f"{world} gloo ranks: "
                                       f"{sorted(got)} answered in "
                                       f"{timeout_s} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return got[0]


def dryrun_multichip(n_devices: int) -> None:
    """A sharded train step on an n-device CPU mesh with tiny shapes: data
    parallelism on the batch and, for even n, tensor parallelism on the
    attention and MLP weights (Megatron's column / row split) over a
    model axis of 2; one Adam step, its loss finite.  Then the inference
    splits (``_dryrun_inference_shards``).  The step runs in spawned
    processes (``spawn_gloo``): a script that calls this must do so under
    ``if __name__ == "__main__":``."""
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    batch = max(n_devices // model_parallel, 2)
    loss, shape = spawn_gloo(n_devices, train_worker,
                             (model_parallel, batch))
    assert np.isfinite(loss), loss
    print(f"dryrun_multichip({n_devices}): mesh={shape} loss={loss:.4f} OK")
    _dryrun_inference_shards(n_devices)


def _dryrun_inference_shards(n_devices: int) -> None:
    """The production inference splits over a CPU device list of n, each
    against its unsplit run:
    (a) DepthPredictor.predict_batch (frames split over the devices)
        against the per-frame predict loop, midas_v21_small, 1e-5;
    (b) BoostEngine.estimate (each chunk's patches split over them)
        against the same engine on one device, 1e-5;
    (c) a tiny Marigold's ensemble members split over them
        (DEPTHMAP_SHARD_ENSEMBLE=1) against one device, 1e-4 (the convs'
        sums at another batch size), before their alignment: the BFGS
        of ``ensemble_depths`` takes a finite-difference gradient of an
        objective that casts its parameters to f32, so its result turns
        on the members' last bits (1e-7 on them moves it by ~2e-2);
        the alignment of the gathered members is the unsplit one's;
    (d) the polylines fill's rows split over them, 4n + 3 rows (not
        divisible), byte-exact."""
    from depthmap_tpu_torch.parallel import mesh
    from depthmap_tpu_torch.pipeline import boost as boost_mod
    from depthmap_tpu_torch.pipeline.depth import DepthPredictor
    cpu = torch.device("cpu")
    devices = [cpu] * n_devices
    # midas_v21_small at seed 0, its batches split over the devices or not
    pred, single = (DepthPredictor(6, weights_dir="./models", device="cpu",
                                   devices=d) for d in (devices, [cpu]))
    rng = np.random.default_rng(0)
    frames = rng.random((n_devices, 96, 128, 3)).astype(np.float32)
    batch_out = pred.predict_batch(frames, 64, 64)
    single_out = np.stack([pred.predict(f, 64, 64) for f in frames])
    assert batch_out.shape == (n_devices, 96, 128)
    np.testing.assert_allclose(batch_out, single_out, atol=1e-5)
    print(f"dryrun predict_batch({n_devices} frames): DP shard == "
          f"per-frame (max |d|={np.abs(batch_out - single_out).max():.2e})")

    yy, xx = np.mgrid[0:256, 0:320]
    img = (np.stack([np.sin(xx / 9), np.cos(yy / 7), np.sin((xx + yy) / 11)],
                    axis=-1).astype(np.float32) * 0.5 + 0.5)
    eng = boost_mod.BoostEngine(pred, merge_batch=1)
    sharded = eng.estimate(img)
    unsharded = boost_mod.BoostEngine(single, eng.merge_net,
                                      merge_batch=1).estimate(img)
    np.testing.assert_allclose(sharded, unsharded, atol=1e-5)
    print(f"dryrun Boost estimate: sharded patch chain == single-device "
          f"(max |d|={np.abs(sharded - unsharded).max():.2e}) OK")

    from depthmap_tpu_torch.models.marigold.pipeline import MarigoldPipeline
    from depthmap_tpu_torch.models.marigold.unet import MarigoldUNet
    from depthmap_tpu_torch.models.marigold.vae import AutoencoderKL
    from depthmap_tpu_torch.models.weights import init_random_
    tiny = init_random_(MarigoldPipeline(
        AutoencoderKL(base=32), MarigoldUNet(base=32, context_dim=64,
                                             dim_head=16), 64), 0).eval()
    mimg = rng.random((32, 32, 3)).astype(np.float32)
    ens = max(2, min(4, n_devices))
    run = functools.partial(tiny.members, mimg, processing_res=32,
                            ensemble_size=ens, denoising_steps=2)
    with mock.patch.dict(os.environ, {"DEPTHMAP_SHARD_ENSEMBLE": "1"}):
        m_sharded = run(devices=devices)
    m_single = run()
    assert m_sharded.shape == (ens, 32, 32)
    np.testing.assert_allclose(m_sharded, m_single, atol=1e-4)
    print(f"dryrun Marigold ensemble({ens} members): mesh-sharded == "
          f"single-device (max |d|={np.abs(m_sharded - m_single).max():.2e})"
          " OK")

    from depthmap_tpu_torch.ops.polylines import polylines_rasterize
    h, w = 4 * n_devices + 3, 96          # deliberately not divisible
    s_img = torch.from_numpy((rng.random((h, w, 3)) * 255).astype(np.uint8))
    s_nd = torch.from_numpy(rng.random((h, w)).astype(np.float32))
    fill = functools.partial(polylines_rasterize, s_img, s_nd, 2.3, 0.5, 1.0,
                             True)
    # the JAX dryrun's n virtual devices: a list that repeats the CPU
    with mock.patch.object(mesh, "local_devices",
                           lambda device="cuda": devices):
        sharded_px = fill(shard=True).numpy()
    single_px = fill(shard=False).numpy()
    np.testing.assert_array_equal(sharded_px, single_px)
    print(f"dryrun polylines fill ({h} rows over {n_devices} devices): "
          "row-sharded == single-device (byte-exact) OK")
