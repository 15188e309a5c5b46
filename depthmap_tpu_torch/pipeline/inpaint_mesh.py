"""The 3D photo's layered-depth-image (LDI) mesh and its files (torch).

Port of ``depthmap_tpu/pipeline/inpaint_mesh.py``:

* ``sparse_bilateral_filtering``: five iterations of the discontinuity-aware
  weighted-median filter; the discontinuity map is numpy on the host, the
  median (``weighted_median_filter``: (H, W, K^2) patches, a stable sort)
  runs on the given device;
* the LDI (``build_ldi``): one vertex per pixel, triangulated except across
  disparity tears, plus one inpainted background band per occlusion-edge
  group, whose depth and colour come from the three inpainting nets on the
  device (``build_inpaint_callables``: crops padded into power-of-two
  buckets of 128, whose zero border the nets' instance norms and partial
  convolutions see, so the padding is part of the result), or, where no
  checkpoint is there, from a 4-neighbour mean propagation and Telea's
  fill (``ops/inpaint_telea.py``).  The graph stages (tears, components,
  floating islands, edge groups) are numpy / scipy, restated;
* the mesh files: OBJ with the ``# depthmap-script`` header (H, W, hFov,
  vFov, meanLoc), binary or ascii PLY with the same comments, byte-equal
  to the JAX writer's, and their readers.

A failure of a net or of the card raises: nothing falls back to the
diffusion fill in silence.
"""
from __future__ import annotations

import collections
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MESH_MAGIC = "# depthmap-script v0.4.8-tpu mesh"


# ---------------------------------------------------------------------------
# sparse bilateral filtering (weighted median on the device)
# ---------------------------------------------------------------------------

def vis_depth_discontinuity(depth: np.ndarray,
                            depth_threshold: float) -> np.ndarray:
    """Union of the reference's 4 directional discontinuity maps
    (bilateral_filtering.py:48-104), as one (H, W) float map."""
    disp = 1.0 / depth
    u = np.zeros_like(disp)
    b = np.zeros_like(disp)
    l = np.zeros_like(disp)
    r = np.zeros_like(disp)
    u[1:-1, 1:-1] = np.abs((disp[1:, :] - disp[:-1, :])[:-1, 1:-1])
    b[1:-1, 1:-1] = np.abs((disp[:-1, :] - disp[1:, :])[1:, 1:-1])
    l[1:-1, 1:-1] = np.abs((disp[:, 1:] - disp[:, :-1])[1:-1, :-1])
    r[1:-1, 1:-1] = np.abs((disp[:, :-1] - disp[:, 1:])[1:-1, 1:])
    over = ((u > depth_threshold).astype(np.float32)
            + (b > depth_threshold) + (l > depth_threshold)
            + (r > depth_threshold)).clip(0, 1)
    over[depth == 0] = 1
    return over


def _blocked_cumsum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """The f32 cumsum along the last axis as XLA's CPU backend computes
    ``jnp.cumsum`` (its reduce-window rewrite): the axis padded to a
    multiple of ``block`` and cut into blocks, each summed in order, the
    blocks' totals scanned the same way, and each block's exclusive prefix
    added to its elements.  Every step is one IEEE f32 add, so the result
    is the same on any device."""
    n = x.shape[-1]
    m = -(-n // block) * block
    blk = F.pad(x, (0, m - n)).reshape(*x.shape[:-1], m // block, block)
    acc = blk[..., 0]
    sums = [acc]
    for j in range(1, block):
        acc = acc + blk[..., j]
        sums.append(acc)
    inb = torch.stack(sums, dim=-1)
    nb = m // block
    if nb == 1:
        return inb.reshape(*x.shape[:-1], m)[..., :n]
    tot = inb[..., -1]
    if nb > block:
        pre = _blocked_cumsum(tot, block)
    else:
        acc = tot[..., 0]
        pres = [acc]
        for j in range(1, nb):
            acc = acc + tot[..., j]
            pres.append(acc)
        pre = torch.stack(pres, dim=-1)
    out = torch.cat([inb[..., :1, :], inb[..., 1:, :] + pre[..., :-1, None]],
                    dim=-2)
    return out.reshape(*x.shape[:-1], m)[..., :n]


def _window_patches(x: torch.Tensor, window: int) -> torch.Tensor:
    """(H, W) -> (H, W, window^2) edge-padded windows, row-major."""
    mid = window // 2
    p = F.pad(x[None, None], (mid, mid, mid, mid), mode="replicate")[0, 0]
    h, w = x.shape
    return p.unfold(0, window, 1).unfold(1, window, 1).reshape(
        h, w, window * window)


def weighted_median_filter(depth: torch.Tensor, discontinuity: torch.Tensor,
                           window_size: int) -> torch.Tensor:
    """Where a pixel's window touches a discontinuity: the weighted median
    of the window, weights 1 - discontinuity (0 or 1), normalized; other
    pixels unchanged.  (H, W) f32 tensors on one device; the window's
    values sorted stably (``jnp.argsort`` is stable), so ties keep their
    row-major order."""
    disc_patches = _window_patches(discontinuity, window_size)
    if not bool(((disc_patches == 0) | (disc_patches == 1)).all()):
        raise ValueError("the discontinuity map must hold only 0 and 1")
    k2 = window_size * window_size
    valid = disc_patches == 0                       # weight 1 / n
    any_disc = (~valid).any(dim=-1)
    n = valid.sum(dim=-1)
    # the normalized weights: 0, or fl(1 / n) as f32 division rounds it
    recip = torch.from_numpy(np.float32(1.0) / np.maximum(
        np.arange(k2 + 1, dtype=np.float32), 1)).to(depth.device)
    coef = torch.where(valid, recip[n][..., None], 0.0)
    sorted_depth, order = torch.sort(_window_patches(depth, window_size),
                                     dim=-1, stable=True)
    cum = _blocked_cumsum(torch.gather(coef, -1, order))
    ind = (cum <= 0.5).sum(dim=-1).clamp(max=k2 - 1)
    median = torch.gather(sorted_depth, -1, ind[..., None])[..., 0]
    return torch.where(any_disc & (n > 0), median, depth)


def sparse_bilateral_filtering(depth: np.ndarray, image: np.ndarray,
                               filter_size: List[int],
                               depth_threshold: float = 0.04,
                               num_iter: int = 5, device="cuda"):
    """(images, depths) lists as the reference returns them (the 3D photo
    keeps depths[-1]); each iteration edge-pads the map's interior
    ([1:-1], the reference's border quirk) and filters it on ``device``."""
    from depthmap_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    vis_depth = depth.copy().astype(np.float32)
    save_depths = [vis_depth]
    for i in range(num_iter):
        window_size = filter_size[i] if isinstance(filter_size,
                                                   (list, tuple)) \
            else filter_size
        disc = vis_depth_discontinuity(vis_depth, depth_threshold)
        d = np.pad(vis_depth[1:-1, 1:-1], 1, mode="edge")
        c = np.pad(disc[1:-1, 1:-1], 1, mode="edge")
        vis_depth = weighted_median_filter(
            torch.from_numpy(d).to(dev), torch.from_numpy(c).to(dev),
            int(window_size)).cpu().numpy()
        save_depths.append(vis_depth)
    return [image] * len(save_depths), save_depths


# ---------------------------------------------------------------------------
# camera helpers (reference mesh.py:112-152 conventions)
# ---------------------------------------------------------------------------

def fov_from_int_mtx(int_mtx: np.ndarray, H: int,
                     W: int) -> Tuple[float, float]:
    int_mtx_real_x = int_mtx[0] * W
    int_mtx_real_y = int_mtx[1] * H
    hfov = 2 * np.arctan(0.5 * W / int_mtx_real_x[0])
    vfov = 2 * np.arctan(0.5 * H / int_mtx_real_y[1])
    return float(hfov), float(vfov)


def pixels_to_verts(rows, cols, depth, H, W, hfov, vfov):
    """The reference's reproject_3d_int_detail_FB convention: the ray
    [(-1 + 2 (col + .5) / (W - 1)) tan(h / 2),
     (1 - 2 (row + .5) / (H - 1)) tan(v / 2), -1] times |z|."""
    tx = np.tan(hfov / 2.0)
    ty = np.tan(vfov / 2.0)
    x = (-1.0 + 2.0 * (cols + 0.5) / (W - 1)) * tx * np.abs(depth)
    y = (1.0 - 2.0 * (rows + 0.5) / (H - 1)) * ty * np.abs(depth)
    z = -np.abs(depth)
    return np.stack([x, y, z], axis=-1)


# ---------------------------------------------------------------------------
# LDI construction
# ---------------------------------------------------------------------------

def _grid_faces(index_map: np.ndarray) -> np.ndarray:
    """Triangulate a (H, W) int index map (-1 = no vertex): two triangles per
    cell whose 4 corners all exist."""
    tl = index_map[:-1, :-1]
    tr = index_map[:-1, 1:]
    bl = index_map[1:, :-1]
    br = index_map[1:, 1:]
    ok = (tl >= 0) & (tr >= 0) & (bl >= 0) & (br >= 0)
    f1 = np.stack([tl[ok], bl[ok], tr[ok]], axis=1)
    f2 = np.stack([br[ok], tr[ok], bl[ok]], axis=1)
    return np.concatenate([f1, f2], axis=0)


def tear_sets(disp: np.ndarray, depth_threshold: float):
    """Torn 4-neighbor edges (reference tear_edges, inpaint/mesh.py:71-108).

    Base criterion (:76): an edge is removed when |disp(a) - disp(b)| >
    threshold.  Dangling pass (:91-108): an intact edge squeezed between two
    parallel torn edges is removed too — a horizontal edge at (row, col)
    whose same-column horizontal edges in the rows directly above and below
    are both torn (and symmetrically for vertical edges across columns).
    The reference computes the pass once from the base tear maps and limits
    it to rows/cols at least 1 away from the border; np.roll wraparound is
    excluded by the same bound.

    Returns (dh, dv): dh[(y, x)] tears the edge (y,x)-(y,x+1), dv[(y, x)]
    tears (y,x)-(y+1,x).
    """
    H, W = disp.shape
    dh = np.abs(disp[:, 1:] - disp[:, :-1]) > depth_threshold   # (H, W-1)
    dv = np.abs(disp[1:, :] - disp[:-1, :]) > depth_threshold   # (H-1, W)

    # dangling pass on (H, W) canvases marked at the min-coordinate pixel
    # (mesh.py:84-87), one shot from the base maps (mesh.py:91-92)
    ch = np.zeros((H, W), bool)
    ch[:, : W - 1] = dh
    cv = np.zeros((H, W), bool)
    cv[: H - 1, :] = dv
    dang_h = np.roll(ch, 1, 0) & np.roll(ch, -1, 0) & ~ch
    dang_h[0, :] = False
    dang_h[-1, :] = False       # horizon_condition: 1 <= row < H-1
    dang_v = np.roll(cv, 1, 1) & np.roll(cv, -1, 1) & ~cv
    dang_v[:, 0] = False
    dang_v[:, -1] = False       # vertical_condition: 1 <= col < W-1
    dh = dh | dang_h[:, : W - 1]
    dv = dv | dang_v[: H - 1, :]
    return dh, dv


def grid_components(dh: np.ndarray, dv: np.ndarray):
    """Connected components of the (H, W) pixel grid under untorn 4-edges
    (the reference's netx.connected_components over the pixel graph,
    inpaint/mesh.py:169).  Returns ((H, W) int labels, n_components)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    H = dv.shape[0] + 1
    W = dh.shape[1] + 1
    idx = np.arange(H * W).reshape(H, W)
    a = idx[:, :-1][~dh]
    b = idx[:, 1:][~dh]
    c = idx[:-1, :][~dv]
    d = idx[1:, :][~dv]
    rows = np.concatenate([a, c])
    cols = np.concatenate([b, d])
    g = sp.coo_matrix((np.ones(len(rows), bool), (rows, cols)),
                      shape=(H * W, H * W))
    n, labels = connected_components(g, directed=False)
    return labels.reshape(H, W), n


def reassign_floating_islands(depth: np.ndarray, depth_threshold: float,
                              min_node_in_cc: int = 200):
    """Reference floating-island handling, dense formulation.

    generate_init_node (inpaint/mesh.py:164-194, min_node_in_cc=200 at
    :1848) drops pixel components smaller than min_node_in_cc from the mesh;
    reassign_floating_island (:244-326) then, per lost island, picks the
    surrounding edge group with the most adjacent nodes (:292) and
    re-propagates depth into the island by iterated 4-neighbor means
    (:297-326), gluing it onto that surface.  Here the two stages fuse into
    one depth rewrite: small components get their depth replaced by
    propagation from the dominant neighboring component.  Deviation: the
    reference's in-place scan uses partially-updated values within one
    sweep (order-dependent); this uses synchronous frontier updates.

    Returns (new_depth, changed).
    """
    H, W = depth.shape
    disp = 1.0 / np.maximum(depth, 1e-8)
    dh, dv = tear_sets(disp, depth_threshold)
    labels, n = grid_components(dh, dv)
    sizes = np.bincount(labels.ravel(), minlength=n)
    lost = sizes[labels] < min_node_in_cc
    if not lost.any():
        return depth, False

    from scipy.ndimage import find_objects
    out = depth.copy()
    known = ~lost
    boxes = find_objects(labels + 1)      # label li's bounding box
    for li in np.unique(labels[lost]):
        # the island's box and its 4-neighbours: every pixel the dense
        # formulation reads or writes for this island
        sl = _grown(boxes[li], 1, H, W)
        lab = labels[sl]
        m = lab == li
        nb = np.zeros(m.shape, bool)      # known 4-neighbors of the island
        nb[:-1, :] |= m[1:, :]
        nb[1:, :] |= m[:-1, :]
        nb[:, :-1] |= m[:, 1:]
        nb[:, 1:] |= m[:, :-1]
        nb &= known[sl]
        if not nb.any():
            continue
        # dominant surrounding group = the one with most adjacent pixels
        dom = np.bincount(lab[nb]).argmax()
        seeds = nb & (lab == dom)

        crop = out[sl]                    # a view: writes land in out
        edm = np.where(seeds, crop, 0.0)
        has = seeds.copy()
        remaining = m.copy()
        while remaining.any():
            ssum = np.zeros(m.shape, np.float64)
            scnt = np.zeros(m.shape, np.int32)
            for src, dst in _SHIFTS:
                ssum[dst] += np.where(has[src], edm[src], 0.0)
                scnt[dst] += has[src]
            newly = remaining & (scnt > 0)
            if not newly.any():
                break                      # island part with no seed path
            val = ssum / np.maximum(scnt, 1)
            edm[newly] = val[newly]
            has[newly] = True
            crop[newly] = val[newly]
            remaining &= ~newly
    return out, True


# (source, destination) slices of the four 4-neighbour shifts
_SHIFTS = (((slice(1, None), slice(None)), (slice(None, -1), slice(None))),
           ((slice(None, -1), slice(None)), (slice(1, None), slice(None))),
           ((slice(None), slice(1, None)), (slice(None), slice(None, -1))),
           ((slice(None), slice(None, -1)), (slice(None), slice(1, None))))


def _grown(box, margin: int, H: int, W: int):
    """A find_objects box grown by ``margin`` on each side, in the image."""
    ys, xs = box
    return (slice(max(ys.start - margin, 0), min(ys.stop + margin, H)),
            slice(max(xs.start - margin, 0), min(xs.stop + margin, W)))


def _propagate_mean(vals: np.ndarray, known: np.ndarray, region: np.ndarray):
    """Fill `region` by iterated synchronous 4-neighbor means seeded from
    `known` (the reference's depth-propagation loop shape, mesh.py:297-326).
    Returns (vals, filled): filled marks seeds + reached region pixels."""
    vals = vals.astype(np.float64).copy()
    known = known.copy()
    remaining = region & ~known
    while remaining.any():
        ssum = np.zeros(vals.shape, np.float64)
        scnt = np.zeros(vals.shape, np.int32)
        for src, dst in _SHIFTS:
            ssum[dst] += np.where(known[src], vals[src], 0.0)
            scnt[dst] += known[src]
        newly = remaining & (scnt > 0)
        if not newly.any():
            break
        vals = np.where(newly, ssum / np.maximum(scnt, 1), vals)
        known |= newly
        remaining &= ~newly
    return vals, known


def edge_pixel_groups(dh: np.ndarray, dv: np.ndarray, min_size: int = 12):
    """Occlusion-edge groups: torn-edge pixels labeled by connectivity
    within the edge-pixel subgraph under untorn 4-edges (reference
    group_edges, inpaint/mesh.py:385 — edge nodes connect along the tear
    curve, never across it).  Groups smaller than `min_size` are dropped
    (reference remove_redundant_edge :636 culls degenerate edge groups;
    redundant_number=12 per src/core.py:417).

    Returns ((H, W) int labels with -1 = not an edge pixel, n_groups).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    H = dv.shape[0] + 1
    W = dh.shape[1] + 1
    edge_px = np.zeros((H, W), bool)
    edge_px[:, 1:] |= dh
    edge_px[:, :-1] |= dh
    edge_px[1:, :] |= dv
    edge_px[:-1, :] |= dv
    n = int(edge_px.sum())
    if n == 0:
        return np.full((H, W), -1, np.int64), 0

    pid = np.full((H, W), -1, np.int64)
    pid[edge_px] = np.arange(n)
    ph = (~dh) & edge_px[:, :-1] & edge_px[:, 1:]
    pv = (~dv) & edge_px[:-1, :] & edge_px[1:, :]
    rows = np.concatenate([pid[:, :-1][ph], pid[:-1, :][pv]])
    cols = np.concatenate([pid[:, 1:][ph], pid[1:, :][pv]])
    g = sp.coo_matrix((np.ones(len(rows), bool), (rows, cols)), shape=(n, n))
    ng, lab = connected_components(g, directed=False)
    sizes = np.bincount(lab, minlength=ng)
    keep = sizes >= min_size
    remap = np.full(ng, -1, np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    out = np.full((H, W), -1, np.int64)
    out[edge_px] = remap[lab]
    return out, int(keep.sum())


def _far_side_mask(disp: np.ndarray, dh: np.ndarray, dv: np.ndarray):
    """Pixels that are the FAR side of some torn edge (their torn neighbor
    is nearer, i.e. has larger disparity) — the reference's nodes that carry
    a 'near' list (tear_edges, mesh.py:79-82)."""
    H, W = disp.shape
    far = np.zeros((H, W), bool)
    far[:, :-1] |= dh & (disp[:, :-1] < disp[:, 1:])
    far[:, 1:] |= dh & (disp[:, 1:] < disp[:, :-1])
    far[:-1, :] |= dv & (disp[:-1, :] < disp[1:, :])
    far[1:, :] |= dv & (disp[1:, :] < disp[:-1, :])
    return far


def build_ldi(img: np.ndarray, depth: np.ndarray, int_mtx: np.ndarray,
              config: Dict, nets: Optional[Dict] = None):
    """(verts, colors, faces, mean_loc_depth).

    Foreground layer: one vertex per pixel, triangulated except across
    disparity discontinuities (> depth_threshold).  Background layer: an
    inpainted band behind each occlusion-edge group (depth and colour from
    the inpainting nets when given, the diffusion fill otherwise),
    triangulated within the band, stitched to the far side of each
    discontinuity.
    """
    from depthmap_tpu_torch.ops.resize import cv2_dilate
    H, W = depth.shape
    depth_threshold = config.get("depth_threshold", 0.04)
    thickness = config.get("background_thickness", 70)
    hfov, vfov = fov_from_int_mtx(int_mtx, H, W)

    # floating islands first (the reference's write_mesh order): small
    # torn-off components glue back onto the dominant surrounding surface
    depth, _ = reassign_floating_islands(
        depth, depth_threshold,
        min_node_in_cc=config.get("min_node_in_cc", 200))

    disp = 1.0 / np.maximum(depth, 1e-8)
    dh, dv = tear_sets(disp, depth_threshold)

    # --- foreground layer: faces of the cells no tear cuts
    rows, cols = np.mgrid[0:H, 0:W]
    fg_index = np.arange(H * W).reshape(H, W)
    fg_verts = pixels_to_verts(rows, cols, depth, H, W, hfov, vfov)
    cell_cut = np.zeros((H - 1, W - 1), bool)
    cell_cut |= dh[:-1, :] | dh[1:, :]
    cell_cut |= dv[:, :-1] | dv[:, 1:]
    keep = ~cell_cut
    tl, tr = fg_index[:-1, :-1], fg_index[:-1, 1:]
    bl, br = fg_index[1:, :-1], fg_index[1:, 1:]
    f1 = np.stack([tl[keep], bl[keep], tr[keep]], axis=1)
    f2 = np.stack([br[keep], tr[keep], bl[keep]], axis=1)

    verts = [fg_verts.reshape(-1, 3)]
    colors = [img.reshape(-1, 3)]
    faces = [np.concatenate([f1, f2], axis=0)]
    n_verts = H * W

    # --- background layers: one per occlusion-edge group, each its own
    # continuation behind its edge (bands of different groups may overlap:
    # several background samples at one pixel make the LDI multi-layer)
    glabels, ngroups = edge_pixel_groups(
        dh, dv, min_size=config.get("redundant_number", 12))
    far_side = _far_side_mask(disp, dh, dv)
    labels_cc, _ = grid_components(dh, dv)
    it = max(thickness // 7, 2)
    margin = it + 2

    from scipy.ndimage import find_objects
    boxes = find_objects(glabels + 1)     # group g's bounding box
    for g in range(ngroups):
        sl = _grown(boxes[g], margin, H, W)
        r0, c0 = sl[0].start, sl[1].start
        gmask = glabels[sl] == g
        seeds = gmask & far_side[sl]
        if not seeds.any():
            continue    # near-side-only group: its far-side twin covers it

        band = seeds.astype(np.float32)
        for _ in range(it):     # cv2.dilate(3 x 3, iterations=it)
            band = cv2_dilate(band, 3)
        band = band > 0
        # context: band pixels on the group's own (background) surface,
        # where the layer meets the foreground mesh; synthesis: band pixels
        # a nearer surface occludes
        seed_comps = np.unique(labels_cc[sl][seeds])
        context = band & np.isin(labels_cc[sl], seed_comps)
        synth = band & ~context
        if not synth.any():
            continue

        bg_depth, bg_color = _inpaint_group(
            img[sl], depth[sl], disp[sl], gmask, context, synth, nets)

        band_index = np.full(band.shape, -1, np.int64)
        brows, bcols = np.nonzero(band)
        band_index[band] = np.arange(len(brows)) + n_verts
        n_verts += len(brows)
        verts.append(pixels_to_verts(brows + r0, bcols + c0, bg_depth[band],
                                     H, W, hfov, vfov))
        colors.append(bg_color[band])
        faces.append(_grid_faces(band_index))

    mean_loc_depth = float(depth[H // 2, W // 2])
    return (np.concatenate(verts, axis=0), np.concatenate(colors, axis=0),
            np.concatenate(faces, axis=0), mean_loc_depth)


def _inpaint_group(img_c, depth_c, disp_c, edge_c, context, synth, nets):
    """Background depth and colour of one edge group's band (crops).

    With nets: edge -> depth -> colour inpainting on the crop (the
    reference runs the three nets per edge group).  Without: depth is the
    4-neighbour mean propagation of the context surface into the occluded
    region, colour Telea's fill of it."""
    depth_c = depth_c.astype(np.float32)
    if nets is not None:
        rgb01 = img_c.astype(np.float32) / 255.0
        ctxf = context.astype(np.float32)
        maskf = synth.astype(np.float32)
        edge_out = nets["edge"](rgb01, disp_c.astype(np.float32),
                                edge_c.astype(np.float32), ctxf, maskf)
        depth_out = nets["depth"](depth_c, edge_out, ctxf, maskf)
        color_out = nets["color"](rgb01, edge_out, ctxf, maskf)
        bg_depth = np.where(synth, np.maximum(depth_out, depth_c), depth_c)
        bg_color = np.where(synth[..., None], color_out * 255.0,
                            img_c.astype(np.float32))
        return bg_depth.astype(np.float32), bg_color.astype(np.uint8)

    from depthmap_tpu_torch.ops.inpaint_telea import inpaint_telea
    vals, filled = _propagate_mean(np.where(context, depth_c, 0.0),
                                   context.copy(), synth)
    bg_depth = np.where(synth & filled, np.maximum(vals, depth_c), depth_c)
    bg_color = inpaint_telea(np.ascontiguousarray(img_c.astype(np.uint8)),
                             synth.astype(np.uint8), 5)
    bg_color = np.where(synth[..., None], bg_color, img_c).astype(np.uint8)
    return bg_depth.astype(np.float32), bg_color


# ---------------------------------------------------------------------------
# the inpainting nets on the device
# ---------------------------------------------------------------------------

def _bucket(d: int) -> int:
    """The next power-of-two multiple of the nets' unit of 128."""
    units = -(-d // 128)
    p = 1
    while p < units:
        p *= 2
    return p * 128


def _pad_bucket(x: torch.Tensor):
    """(N, C, h, w) centred in a zero canvas of the buckets' size; the
    crop's (top, bottom, left, right) in it."""
    h, w = x.shape[2:]
    rh, rw = _bucket(h) - h, _bucket(w) - w
    top, left = rh // 2, rw // 2
    return (F.pad(x, (left, rw - left, top, rh - top)),
            (top, top + h, left, left + w))


# calls of each inpainting net by (name, device type)
net_calls: collections.Counter = collections.Counter()


def run_net(name: str, net, *planes: torch.Tensor) -> torch.Tensor:
    """One inpainting net on bucket-padded (1, C, h, w) planes, cropped
    back; counted in ``net_calls[(name, device type)]``."""
    padded = [_pad_bucket(p)[0] for p in planes]
    t, b, l, r = _pad_bucket(planes[0])[1]
    with torch.no_grad():
        out = net(*padded)
    net_calls[(name, planes[0].device.type)] += 1
    return out[0, :, t:b, l:r]



def build_inpaint_callables(weights_dir: str = "./models/3dphoto",
                            device="cuda") -> Optional[Dict]:
    """The three nets, loaded from ``weights_dir`` (``models/weights.py
    load_inpaint_nets``) onto ``device`` in f32, as the callables
    ``build_ldi`` takes: {"edge": (rgb01, disp, edge, context, mask),
    "depth": (depth, edge, context, mask), "color": (rgb01, edge, context,
    mask)}, numpy crops in and out.  None only when no checkpoint file is
    there (then ``build_ldi`` fills by diffusion)."""
    from depthmap_tpu_torch.device import resolve_device
    from depthmap_tpu_torch.models.weights import load_inpaint_nets
    from depthmap_tpu_torch.pipeline.depth import set_fp32_precision
    nets = load_inpaint_nets(weights_dir)
    if nets is None:
        return None
    dev = resolve_device(device)
    set_fp32_precision(dev)
    nets = {k: n.to(dev).eval() for k, n in nets.items()}

    def plane(a) -> torch.Tensor:
        """(h, w) -> (1, 1, h, w); (h, w, 3) -> (1, 3, h, w), f32."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
        return t[None, None] if t.ndim == 2 else t.permute(2, 0, 1)[None]

    def edge_fn(rgb01, disp, edge_in, context, mask):
        x = torch.cat([plane(rgb01),
                       plane(disp / max(float(np.max(disp)), 1e-8)),
                       plane(edge_in), plane(context), plane(mask)], dim=1)
        return run_net("edge", nets["edge"], x)[0].cpu().numpy()

    def depth_fn(depth, edge, context, mask):
        return run_net("depth", nets["depth"], plane(depth), plane(edge),
                       plane(context), plane(mask))[0].cpu().numpy()

    def color_fn(rgb01, edge, context, mask):
        out = run_net("color", nets["color"], plane(rgb01), plane(edge),
                      plane(context), plane(mask))
        return out.permute(1, 2, 0).cpu().numpy()

    return {"edge": edge_fn, "depth": depth_fn, "color": color_fn}


# ---------------------------------------------------------------------------
# mesh files (the reference's formats, byte-equal to the JAX writer's)
# ---------------------------------------------------------------------------

_PLY_VERTEX = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                        ("r", "u1"), ("g", "u1"), ("b", "u1"), ("a", "u1")])
_PLY_FACE = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"),
                      ("c", "<i4")])


def write_mesh_file(path: str, verts, colors, faces, H, W, hfov, vfov,
                    mean_loc_depth, fmt: str = "obj",
                    ply_fmt: str = "bin") -> str:
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    colors = np.asarray(colors)
    colors01 = colors / 255.0 if colors.max() > 1.0 + 1e-6 else colors
    if fmt == "obj":
        with open(path, "w", encoding="utf8") as f:
            f.write(MESH_MAGIC + "\n")
            f.write(f"# H {int(H)}\n# W {int(W)}\n")
            f.write(f"# hFov {float(hfov)}\n# vFov {float(vfov)}\n")
            f.write(f"# meanLoc {float(mean_loc_depth)}\n")
            f.write(f"# vertices {len(verts)}\n# faces {len(faces)}\n")
            f.write("o depthmap\n")
            f.writelines(f"v {x:.8f} {y:.8f} {z:.8f} {r:.4f} {g:.4f} {b:.4f}\n"
                         for (x, y, z), (r, g, b) in zip(verts.tolist(),
                                                         colors01.tolist()))
            f.writelines(f"f {a} {b} {c}\n"
                         for a, b, c in (faces + 1).tolist())
        return path
    if fmt == "ply":
        c255 = np.clip(colors01 * 255.0, 0, 255).astype(np.uint8)
        header = [
            "ply",
            "format binary_little_endian 1.0" if ply_fmt == "bin"
            else "format ascii 1.0",
            f"comment H {int(H)}", f"comment W {int(W)}",
            f"comment hFov {float(hfov)}", f"comment vFov {float(vfov)}",
            f"comment meanLoc {float(mean_loc_depth)}",
            f"element vertex {len(verts)}",
            "property float x", "property float y", "property float z",
            "property uchar red", "property uchar green",
            "property uchar blue", "property uchar alpha",
            f"element face {len(faces)}",
            "property list uchar int vertex_index", "end_header"]
        if ply_fmt == "bin":
            vrec = np.zeros(len(verts), _PLY_VERTEX)
            for i, k in enumerate("xyz"):
                vrec[k] = verts[:, i]
            for i, k in enumerate("rgb"):
                vrec[k] = c255[:, i]
            vrec["a"] = 255
            frec = np.zeros(len(faces), _PLY_FACE)
            frec["n"] = 3
            for i, k in enumerate("abc"):
                frec[k] = faces[:, i]
            with open(path, "wb") as f:
                f.write(("\n".join(header) + "\n").encode("ascii"))
                f.write(vrec.tobytes())
                f.write(frec.tobytes())
        else:
            with open(path, "w") as f:
                f.write("\n".join(header) + "\n")
                f.writelines(f"{x:.8f} {y:.8f} {z:.8f} {r} {g} {b} 255\n"
                             for (x, y, z), (r, g, b) in zip(
                                 verts.tolist(), c255.tolist()))
                f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces.tolist())
        return path
    raise ValueError(fmt)


def read_mesh(mesh_fi: str):
    """(verts, colors, faces, H, W, hFov, vFov, mean_loc_depth) of an OBJ
    or PLY mesh file this package wrote."""
    ext = os.path.splitext(mesh_fi)[1]
    if ext == ".obj":
        return _read_obj(mesh_fi)
    if ext == ".ply":
        return _read_ply(mesh_fi)
    raise ValueError(f"Unknown mesh file format {ext!r}")


def _read_obj(mesh_fi):
    meta = {}
    with open(mesh_fi, encoding="utf8") as f:
        first = f.readline()
        if not first.startswith("# depthmap-script"):
            raise ValueError("This requires a 3D inpainted mesh generated "
                             "by this extension.")
        lines = f.read().splitlines()
    vlines, flines = [], []
    for line in lines:
        if line.startswith("v "):
            vlines.append(line[2:])
        elif line.startswith("f "):
            flines.append(line[2:])
        elif line.startswith("#"):
            parts = line.split()
            if len(parts) >= 3:
                meta[parts[1]] = parts[-1]
    # every token parsed at once (the same correctly rounded values as
    # float() line by line)
    vals = np.array(" ".join(vlines).split(), np.float64).reshape(
        len(vlines), -1) if vlines else np.zeros((0, 6))
    faces = np.array(" ".join(flines).split(), np.int64).reshape(
        len(flines), -1)[:, :3] - 1 if flines else np.zeros((0, 3), np.int64)

    def get(key, cast):
        return cast(meta[key]) if key in meta else None
    return (vals[:, :3].astype(np.float32), vals[:, 3:6].astype(np.float32),
            faces, get("H", int), get("W", int), get("hFov", float),
            get("vFov", float), get("meanLoc", float))


def _read_ply(mesh_fi):
    with open(mesh_fi, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    meta = {}
    n_vert = n_face = 0
    binary = any("binary_little_endian" in h for h in header)
    for h in header:
        p = h.split()
        if h.startswith("comment") and len(p) >= 3:
            meta[p[1]] = p[2]
        elif h.startswith("element vertex"):
            n_vert = int(p[2])
        elif h.startswith("element face"):
            n_face = int(p[2])
    if binary:
        vrec = np.frombuffer(data, _PLY_VERTEX, n_vert, head_end)
        frec = np.frombuffer(data, _PLY_FACE, n_face,
                             head_end + n_vert * _PLY_VERTEX.itemsize)
        verts = np.stack([vrec[k] for k in "xyz"], -1).astype(np.float32)
        colors = (np.stack([vrec[k] for k in "rgb"], -1) / 255.0).astype(
            np.float32)
        faces = np.stack([frec[k] for k in "abc"], -1).astype(np.int64)
    else:
        lines = data[head_end:].decode("ascii").splitlines()
        vals = np.array([ln.split() for ln in lines[:n_vert]],
                        np.float64).reshape(n_vert, -1)
        verts = vals[:, :3].astype(np.float32)
        colors = (vals[:, 3:6] / 255.0).astype(np.float32)
        faces = np.array([ln.split()[1:4] for ln in
                          lines[n_vert:n_vert + n_face]],
                         np.int64).reshape(n_face, 3)
    return (verts, colors, faces, int(meta.get("H", 0)),
            int(meta.get("W", 0)), float(meta.get("hFov", 0.5)),
            float(meta.get("vFov", 0.5)), float(meta.get("meanLoc", 1.0)))


def write_mesh(img: np.ndarray, depth: np.ndarray, int_mtx: np.ndarray,
               mesh_fi: str, config: Dict, nets: Optional[Dict] = None):
    """The reference's write_mesh surface: builds the LDI and saves .obj
    (config['save_obj']) and / or .ply (config['save_ply'])."""
    verts, colors, faces, mean_loc_depth = build_ldi(img, depth, int_mtx,
                                                     config, nets)
    H, W = depth.shape
    hfov, vfov = fov_from_int_mtx(int_mtx, H, W)
    if config.get("save_obj", True):
        write_mesh_file(mesh_fi, verts, colors, faces, H, W, hfov, vfov,
                        mean_loc_depth, fmt="obj")
    if config.get("save_ply", False):
        write_mesh_file(os.path.splitext(mesh_fi)[0] + ".ply", verts,
                        colors, faces, H, W, hfov, vfov, mean_loc_depth,
                        fmt="ply", ply_fmt=config.get("ply_fmt", "bin"))
    return mesh_fi
