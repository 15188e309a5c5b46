"""Simple textured mesh (numpy, no mesh library).

Restated from ``depthmap_tpu/pipeline/mesh.py`` (held byte-equal on the
OBJ by tests/test_torch_port_outputs.py): 55-degree-FoV pinhole
back-projection, pytorch3d's axis flip, grid triangulation with
occlusion-edge masking, the heuristic depth rescale of non-metric models,
and an OBJ with per-vertex colours.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from depthmap_tpu_torch.io.image import get_unique_filename


def get_intrinsics(h: int, w: int) -> np.ndarray:
    """Pinhole intrinsics, 55-degree FoV, central principal point."""
    f = 0.5 * w / np.tan(0.5 * 55 * np.pi / 180.0)
    return np.array([[f, 0, 0.5 * w],
                     [0, f, 0.5 * h],
                     [0, 0, 1]])


def depth_to_points(depth: np.ndarray) -> np.ndarray:
    """depth: (H, W) -> (H, W, 3) camera-space points (pytorch3d axes)."""
    h, w = depth.shape
    Kinv = np.linalg.inv(get_intrinsics(h, w))
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    coord = np.stack([x, y, np.ones_like(x)], axis=-1).astype(np.float64)
    pts = depth[..., None] * (coord @ Kinv.T)
    pts[..., 0] *= -1.0   # M = diag(-1, -1, 1)
    pts[..., 1] *= -1.0
    return pts


def pano_depth_to_world_points(depth: np.ndarray) -> np.ndarray:
    """Equirectangular depth -> spherical world points."""
    radius = depth.flatten()
    lon = np.linspace(-np.pi, np.pi, depth.shape[1])
    lat = np.linspace(-np.pi / 2, np.pi / 2, depth.shape[0])
    lon, lat = np.meshgrid(lon, lat)
    lon = lon.flatten()
    lat = lat.flatten()
    x = radius * np.cos(lat) * np.cos(lon)
    y = radius * np.cos(lat) * np.sin(lon)
    z = radius * np.sin(lat)
    return np.stack([x, y, z], axis=1)


def create_triangles(h: int, w: int,
                     mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Grid triangulation (2 triangles per cell), optionally masked."""
    x, y = np.meshgrid(range(w - 1), range(h - 1))
    tl = y * w + x
    tr = y * w + x + 1
    bl = (y + 1) * w + x
    br = (y + 1) * w + x + 1
    triangles = np.array([tl, bl, tr, br, tr, bl])
    triangles = np.transpose(triangles, (1, 2, 0)).reshape(
        ((w - 1) * (h - 1) * 2, 3))
    if mask is not None:
        mask = mask.reshape(-1)
        triangles = triangles[mask[triangles].all(1)]
    return triangles


def depth_edges_mask(depth: np.ndarray) -> np.ndarray:
    """True where the depth gradient magnitude exceeds 0.05."""
    depth_dx, depth_dy = np.gradient(depth)
    return np.sqrt(depth_dx ** 2 + depth_dy ** 2) > 0.05


def rescale_depth_for_mesh(depthi: np.ndarray, model_type: int, boost: bool,
                           custom_depthmap: bool) -> np.ndarray:
    """Heuristic mapping of non-metric predictions to mesh-friendly depth.
    ZoeDepth (types 7-9) without boost and without a custom map passes
    through unchanged."""
    depthi = np.asarray(depthi, dtype=np.float64)
    depthi_min, depthi_max = depthi.min(), depthi.max()
    if model_type not in (7, 8, 9) or boost or custom_depthmap:
        if model_type > 0 or custom_depthmap:  # invert if midas-style
            depthi = depthi_max - depthi + depthi_min
            depthi_max = depthi.max()
            depthi_min = depthi.min()
        if depthi_min < 0:
            depthi = depthi - depthi_min
            depthi_max = depthi.max()
            depthi_min = depthi.min()
        if depthi.max() > 10.0:
            depthi = 4.0 * (depthi - depthi_min) / (depthi_max - depthi_min)
        depthi = depthi + 1.0
    return depthi


def write_obj_with_vertex_colors(path: str, verts: np.ndarray,
                                 faces: np.ndarray,
                                 colors: np.ndarray) -> None:
    """OBJ with `v x y z r g b` lines (colors in [0,1]); 1-based faces."""
    colors01 = np.asarray(colors, np.float64)
    if colors01.max() > 1.0:
        colors01 = colors01 / 255.0
    with open(path, "w") as f:
        f.write("# depthmap_tpu simple mesh\n")
        for (x, y, z), (r, g, b) in zip(verts, colors01):
            f.write(f"v {x:.8f} {y:.8f} {z:.8f} {r:.6f} {g:.6f} {b:.6f}\n")
        for a, b_, c in faces + 1:
            f.write(f"f {a} {b_} {c}\n")


def create_simple_mesh(image: np.ndarray, depth: np.ndarray,
                       keep_edges: bool = False, spherical: bool = False,
                       maxsize: int = 2048):
    """(verts, faces, colors).  An image larger than maxsize is
    thumbnailed and the depth resized alongside it; cv2 is imported only
    to resize."""
    h, w = image.shape[:2]
    if max(h, w) > maxsize or depth.shape != (h, w):
        import cv2
    if max(h, w) > maxsize:
        scale = maxsize / max(h, w)
        nw, nh = int(w * scale), int(h * scale)
        image = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_AREA)
        depth = cv2.resize(depth.astype(np.float32), (nw, nh),
                           interpolation=cv2.INTER_AREA)
        h, w = nh, nw
    if depth.shape != image.shape[:2]:
        depth = cv2.resize(depth.astype(np.float32), (w, h),
                           interpolation=cv2.INTER_AREA)

    if not spherical:
        pts3d = depth_to_points(np.asarray(depth, np.float64))
    else:
        pts3d = pano_depth_to_world_points(np.asarray(depth, np.float64))
    verts = pts3d.reshape(-1, 3)

    if keep_edges:
        triangles = create_triangles(h, w)
    else:
        triangles = create_triangles(h, w, mask=~depth_edges_mask(depth))
    colors = image.reshape(-1, image.shape[-1])[:, :3]

    if spherical:  # rotate 90 deg over X
        a = math.pi / 2
        rot = np.array([[1, 0, 0],
                        [0, math.cos(a), -math.sin(a)],
                        [0, math.sin(a), math.cos(a)]])
        verts = verts @ rot.T
    return verts, triangles, colors


def create_simple_mesh_output(image: np.ndarray, depthi: np.ndarray,
                              outpath: Optional[str], model_type: int,
                              boost: bool, custom_depthmap: bool,
                              occlude: bool = True,
                              spherical: bool = False) -> str:
    depth = rescale_depth_for_mesh(depthi, model_type, boost, custom_depthmap)
    verts, faces, colors = create_simple_mesh(
        np.asarray(image), depth, keep_edges=not occlude, spherical=spherical)
    outpath = outpath or "."
    os.makedirs(outpath, exist_ok=True)
    mesh_path = get_unique_filename(outpath, "depthmap", "obj", "simple")
    write_obj_with_vertex_colors(mesh_path, verts, faces, colors)
    return mesh_path
