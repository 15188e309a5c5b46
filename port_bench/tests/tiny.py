"""Tiny stand-ins for the benchmark's configurations, for CPU tests: the
same model families at a width a test can hold, on the program's side
(its builders patched to build them) and on the reference's (the
configuration with the same widths)."""
from __future__ import annotations

import copy
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BEIT = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=2,
            head_dim=32, intermediate_size=256, image_size=64,
            hooks=[0, 1, 2, 3], reassemble_channels=[16, 32, 64, 64],
            features=32, default_net_size=[64, 64])
DINO = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=2,
            head_dim=32, intermediate_size=256, image_size=70,
            hooks=[0, 1, 2, 3], out_channels=[16, 32, 64, 64], features=32,
            default_net_size=[70, 70])


def config(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(copy.deepcopy(BEIT if name == "dpt_beit_large_512"
                             else DINO))
    return cfg


def beit_module():
    from depthmap_tpu_torch.models.beit import BeitBackbone
    from depthmap_tpu_torch.models.dpt import DPTDepthModel
    return DPTDepthModel(
        BeitBackbone(embed_dim=BEIT["hidden_size"],
                     depth=BEIT["num_hidden_layers"],
                     num_heads=BEIT["num_attention_heads"],
                     hooks=tuple(BEIT["hooks"]),
                     train_img_size=BEIT["image_size"]),
        reassemble_channels=tuple(BEIT["reassemble_channels"]),
        features=BEIT["features"])


def dino_module():
    from depthmap_tpu_torch.models.depth_anything import DepthAnything
    from depthmap_tpu_torch.models.dinov2 import DinoV2Backbone
    return DepthAnything(
        DinoV2Backbone(embed_dim=DINO["hidden_size"],
                       depth=DINO["num_hidden_layers"],
                       num_heads=DINO["num_attention_heads"],
                       hooks=tuple(DINO["hooks"]),
                       train_img_size=DINO["image_size"]),
        features=DINO["features"], out_channels=tuple(DINO["out_channels"]))


def patch_builders(monkeypatch) -> None:
    """The program's model builders give the tiny models."""
    from depthmap_tpu_torch.models import depth_anything, dpt
    monkeypatch.setattr(dpt, "build_dpt", lambda variant: beit_module())
    monkeypatch.setattr(depth_anything, "build_depth_anything_v2",
                        lambda variant: dino_module())


def cell(name: str, config_name: str, traffic: dict, limits: dict):
    """A cell of the tiny configuration under ``traffic``, its limits
    given."""
    from port_bench.harness import Cell

    class TinyCell(Cell):
        def limits(self):
            return dict(limits)

    bench = {"end_to_end": [], "per_layer": []}
    for key in ("end_to_end", "per_layer"):
        with open(os.path.join(os.path.dirname(BENCH_DIR),
                               "BENCHMARK.json")) as f:
            bench[key] = json.load(f)[key]
    workload = {"name": name, "config": config_name, "traffic": "tiny",
                "chips": 1}
    return TinyCell(name, workload, config(config_name), traffic, bench)


STEREO_TRAFFIC = {
    "photo": {"width": 96, "height": 64, "shapes": 4, "texture": 18.0,
              "noise": 4.0},
    "pool": 4, "photos_per_job": 2, "net": [64, 64],
    "options": {"gen_stereo": True,
                "stereo_modes": ["left-right", "red-cyan-anaglyph"],
                "stereo_fill_algo": "polylines_sharp",
                "stereo_divergence": 2.5, "stereo_separation": 0.0,
                "stereo_balance": 0.0, "stereo_offset_exponent": 1.0},
    "trace_jobs": 1,
    "check": {"photos": 2, "stereo_photos": 2, "stereo_rows": 4},
}
