"""The 3D photo: inpainted LDI mesh and trajectory videos (torch).

Port of ``depthmap_tpu/pipeline/inpaint_video.py``:

* ``run_3dphoto``: per image, the disparity from the 16-bit map (a 3 x 3
  box blur, ``ops/filters.py cv2_blur3``), depth = 1 / max(disparity, 0.05),
  the sparse bilateral filter, then the LDI mesh (``inpaint_mesh``) with
  the inpainting nets from ``./models/3dphoto`` when their checkpoints are
  there; with ``gen_inpainted_mesh_demos``, the four demo videos;
* ``run_3dphoto_videos`` / ``output_3d_photo``: camera paths
  (``path_planning``), each frame rendered by ``render.MeshRenderer`` on
  the device, cropped to the image's aspect and the crop border, and
  written through ``video_mode.frames_to_video``.  The last mesh read is
  kept (``_video_mesh``), as the reference keeps it between calls;
* ``run_makevideo``: one trajectory video of a saved mesh.

``device`` is the torch device of the filter, the nets and the renderer
("cuda" unless the caller asks for "cpu").
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from depthmap_tpu_torch.io.image import get_unique_filename
from depthmap_tpu_torch.pipeline.inpaint_mesh import (
    read_mesh, sparse_bilateral_filtering, write_mesh)
from depthmap_tpu_torch.pipeline.render import MeshRenderer
from depthmap_tpu_torch.pipeline.video_mode import frames_to_video

# the last mesh file read and its contents (the reference's module-level
# cache between video calls)
_video_mesh = {"path": None, "data": None}

# the funnel's four demo videos: trajectories, shifts and names
DEMO_TRAJECTORIES = dict(
    crop_border=[0.03, 0.03, 0.05, 0.03],
    traj_types=["double-straight-line", "double-straight-line", "circle",
                "circle"],
    x_shift_range=[0.00, 0.00, -0.015, -0.015],
    y_shift_range=[0.00, 0.00, -0.015, -0.00],
    z_shift_range=[-0.05, -0.05, -0.05, -0.05],
    video_postfix=["dolly-zoom-in", "zoom-in", "circle", "swing"])
DEMO_FRAMES, DEMO_FPS = 300, 40

# the reference's 3D-photo configuration
CONFIG = {
    "extrapolation_thickness": 60, "extrapolate_border": True,
    "depth_threshold": 0.04, "redundant_number": 12,
    "ext_edge_threshold": 0.002, "background_thickness": 70,
    "context_thickness": 140, "background_thickness_2": 70,
    "context_thickness_2": 70, "log_depth": True,
    "depth_edge_dilate": 10, "depth_edge_dilate_2": 5,
    "largest_size": 512, "repeat_inpaint_edge": True,
    "ply_fmt": "bin", "save_ply": False, "save_obj": True,
    "sparse_iter": 5, "filter_size": [7, 7, 5, 5, 5],
    "sigma_s": 4.0, "sigma_r": 0.5,
}


def path_planning(num_frames: int, x: float, y: float, z: float,
                  path_type: str = ""):
    """Camera trajectories (the reference's inpaint/utils.py)."""
    from scipy.interpolate import interp1d
    if path_type in ("straight-line", "double-straight-line"):
        if path_type == "straight-line":
            corner_points = np.array([[0, 0, 0],
                                      [(0 + x) * 0.5, (0 + y) * 0.5,
                                       (0 + z) * 0.5],
                                      [x, y, z]])
        else:
            corner_points = np.array([[-x, -y, -z], [0, 0, 0], [x, y, z]])
        corner_t = np.linspace(0, 1, len(corner_points))
        t = np.linspace(0, 1, num_frames)
        cs = interp1d(corner_t, corner_points, axis=0, kind="quadratic")
        spline = cs(t)
        xs, ys, zs = [xx.squeeze() for xx in np.split(spline, 3, 1)]
    elif path_type == "circle":
        xs, ys, zs = [], [], []
        for bs_shift_val in np.arange(-2.0, 2.0, (4.0 / num_frames)):
            xs += [np.cos(bs_shift_val * np.pi) * 1 * x]
            ys += [np.sin(bs_shift_val * np.pi) * 1 * y]
            zs += [np.cos(bs_shift_val * np.pi / 2.0) * 1 * z]
        xs, ys, zs = np.array(xs), np.array(ys), np.array(zs)
    else:
        raise ValueError(f"Unknown path type {path_type!r}")
    return xs, ys, zs


def output_3d_photo(verts, colors, faces, H, W, hfov, vfov, videos_poses,
                    video_postfixes, output_dir, video_basename, config,
                    mean_loc_depth, original_h=None, original_w=None,
                    dolly=False, fn_ext="mp4", device="cuda") -> List[str]:
    """Render the trajectory videos (the reference's output_3d_photo
    flow); returns the written paths."""
    original_h = original_h or H
    original_w = original_w or W
    fov_rad = max(hfov, vfov)
    canvas_size = max(original_h, original_w)
    ssaa = int(config.get("ssaa", 1))
    renderer = MeshRenderer(verts, colors, faces, fov_rad, canvas_size, ssaa,
                            method=config.get("render_method", "triangles"),
                            device=device)
    plane_width = np.tan(fov_rad / 2.0) * abs(mean_loc_depth)

    aspect = original_h / original_w
    S = canvas_size
    if aspect > 1:
        img_h_len = original_h
        img_w_len = img_h_len / aspect
        anchor = [0, S, int(max(0, S // 2 - img_w_len // 2)),
                  int(min(S // 2 + img_w_len // 2, S - 1))]
    else:
        img_w_len = original_w
        img_h_len = img_w_len * aspect
        anchor = [int(max(0, S // 2 - img_h_len // 2)),
                  int(min(S // 2 + img_h_len // 2, S - 1)), 0, S]

    fn_saved = []
    fps = config.get("fps", 40)
    crop_border = config.get("crop_border", [0, 0, 0, 0])
    for poses, postfix in zip(videos_poses, video_postfixes):
        frames = []
        for tp in poses:
            shift = np.asarray(tp)[:3, 3]
            new_mean_loc = mean_loc_depth - float(-shift[2])
            if dolly or "dolly" in postfix:
                fov = float(np.arctan2(plane_width,
                                       abs(new_mean_loc))) * 2.0
            else:
                fov = fov_rad
            # the camera moves opposite the pose's shift (inv(tp))
            img = renderer.render(-shift, fov)
            img = img[anchor[0]:anchor[1], anchor[2]:anchor[3]]
            if any(np.array(crop_border) > 0.0):
                hc, wc = img.shape[:2]
                o_t = int(hc * crop_border[0])
                o_l = int(wc * crop_border[1])
                o_b = int(hc * crop_border[2])
                o_r = int(wc * crop_border[3])
                img = img[o_t:hc - o_b, o_l:wc - o_r]
            frames.append(img)
        name = f"{video_basename}_{postfix}" if postfix else video_basename
        fn_saved += frames_to_video(fps, frames, output_dir, name)
    return fn_saved


def run_3dphoto_videos(mesh_fi: str, basename: str, outpath: str,
                       num_frames: int, fps: int, crop_border,
                       traj_types, x_shift_range, y_shift_range,
                       z_shift_range, video_postfix, vid_dolly, vid_format,
                       vid_ssaa, device="cuda") -> List[str]:
    """The videos of one mesh file along the given trajectories."""
    if _video_mesh["path"] != mesh_fi:
        _video_mesh["data"] = read_mesh(mesh_fi)
        _video_mesh["path"] = mesh_fi
    verts, colors, faces, H, W, hfov, vfov, mean_loc_depth = \
        _video_mesh["data"]

    if not len(traj_types) == len(x_shift_range) == len(y_shift_range) == \
            len(z_shift_range) == len(video_postfix):
        raise ValueError("one shift per axis and one postfix per trajectory")
    tgts_poses = []
    for ti in range(len(traj_types)):
        tgt_poses = []
        sx, sy, sz = path_planning(num_frames, x_shift_range[ti],
                                   y_shift_range[ti], z_shift_range[ti],
                                   path_type=traj_types[ti])
        for xx, yy, zz in zip(sx, sy, sz):
            pose = np.eye(4)
            pose[:3, 3] = [xx, yy, zz]
            tgt_poses.append(pose)
        tgts_poses.append(tgt_poses)

    config = {"fps": fps, "crop_border": crop_border, "ssaa": vid_ssaa}
    return output_3d_photo(verts, colors, faces, H, W, hfov, vfov,
                           tgts_poses, video_postfix, outpath, basename,
                           config, mean_loc_depth, original_h=H,
                           original_w=W, dolly=vid_dolly, fn_ext=vid_format,
                           device=device)


def run_makevideo(fn_mesh: str, vid_numframes, vid_fps, vid_traj, vid_shift,
                  vid_border, dolly, vid_format, vid_ssaa, outpath=None,
                  basename=None, device="cuda"):
    """One trajectory video of a saved mesh (the 'Generate video' tab and
    its API): -> (path, path, "")."""
    if len(fn_mesh) == 0 or not os.path.exists(fn_mesh):
        raise FileNotFoundError(f"Could not open mesh {fn_mesh!r}.")
    vid_ssaa = int(vid_ssaa)
    if vid_traj == 0:
        vid_traj = ["straight-line"]
    elif vid_traj == 1:
        vid_traj = ["double-straight-line"]
    elif vid_traj == 2:
        vid_traj = ["circle"]
    elif isinstance(vid_traj, str):
        vid_traj = [vid_traj]

    shifts = vid_shift.split(",") if isinstance(vid_shift, str) else vid_shift
    if len(shifts) != 3:
        raise ValueError("Translate requires 3 elements.")
    borders = vid_border.split(",") if isinstance(vid_border, str) \
        else vid_border
    if len(borders) != 4:
        raise ValueError("Crop Border requires 4 elements.")

    outpath = outpath or "./outputs"
    if not basename:
        basename = os.path.splitext(os.path.basename(fn_mesh))[0]
    fn_saved = run_3dphoto_videos(
        fn_mesh, basename, outpath, int(vid_numframes), int(vid_fps),
        [float(b) for b in borders], vid_traj, [float(shifts[0])],
        [float(shifts[1])], [float(shifts[2])], [""], dolly, vid_format,
        vid_ssaa, device=device)
    return fn_saved[-1], fn_saved[-1], ""


def disparity_to_depth(depth16: np.ndarray) -> np.ndarray:
    """The reference's depth ingest: the map shifted to 0, box-blurred at
    [0, 1] (3 x 3), scaled to a disparity in [0, 3], depth = 1 /
    max(disparity, 0.05)."""
    from depthmap_tpu_torch.ops.filters import cv2_blur3
    disp = np.asarray(depth16).astype(np.float32)
    disp = disp - disp.min()
    disp = cv2_blur3(disp / disp.max()) * disp.max()
    disp = (disp / disp.max()) * 3.0
    return 1.0 / np.maximum(disp, 0.05)


def run_3dphoto(device, inpaint_imgs, inpaint_depths, inputnames, outpath,
                gen_inpainted_mesh_demos, vid_ssaa, vid_format,
                nets: Optional[dict] = None) -> str:
    """The inpainted mesh of each image (and, with
    ``gen_inpainted_mesh_demos``, its four demo videos); returns the last
    mesh's path.  ``nets`` default to ``build_inpaint_callables``'s from
    ./models/3dphoto (None there: the diffusion fill)."""
    from depthmap_tpu_torch.device import resolve_device
    from depthmap_tpu_torch.pipeline.inpaint_mesh import \
        build_inpaint_callables
    device = resolve_device(device)
    if nets is None:
        nets = build_inpaint_callables(device=device)
    mesh_fi = ""
    for count in range(len(inpaint_imgs)):
        basename = "depthmap"
        if inputnames is not None and inputnames[count] is not None:
            basename = os.path.splitext(os.path.basename(
                str(inputnames[count])))[0]
        os.makedirs(outpath, exist_ok=True)
        mesh_fi = get_unique_filename(outpath, basename, "obj")

        img = np.asarray(inpaint_imgs[count])
        if img.ndim > 2 and img.shape[2] == 4:
            img = img[..., :3]
        H, W = img.shape[:2]
        int_mtx = np.array([[max(H, W), 0, W // 2],
                            [0, max(H, W), H // 2],
                            [0, 0, 1]]).astype(np.float32)
        if int_mtx.max() > 1:
            int_mtx[0, :] = int_mtx[0, :] / float(W)
            int_mtx[1, :] = int_mtx[1, :] / float(H)

        depth = disparity_to_depth(inpaint_depths[count])
        _imgs, depths = sparse_bilateral_filtering(
            depth.copy(), img.copy(), CONFIG["filter_size"],
            CONFIG["depth_threshold"], num_iter=CONFIG["sparse_iter"],
            device=device)
        write_mesh(img, depths[-1], int_mtx, mesh_fi, CONFIG, nets=nets)

        if gen_inpainted_mesh_demos:
            run_3dphoto_videos(mesh_fi, basename, outpath, DEMO_FRAMES,
                               DEMO_FPS, vid_dolly=False,
                               vid_format=vid_format, vid_ssaa=vid_ssaa,
                               device=device, **DEMO_TRAJECTORIES)
    return mesh_fi
