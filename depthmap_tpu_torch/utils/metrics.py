"""Depth evaluation metrics (torch).

Port of ``depthmap_tpu/utils/metrics.py``, the reference's metric
definitions (dzoedepth/utils/misc.py:159-249): a1 / a2 / a3 (delta <
1.25^n), abs_rel, sq_rel, rmse, rmse_log, log_10, silog, with the garg /
eigen evaluation crops.  ``compute_errors`` runs in f32 on the tensors'
device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def compute_errors(gt: torch.Tensor,
                   pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """gt, pred: same-shape tensors of positive depths (pre-masked)."""
    gt = torch.as_tensor(gt).to(torch.float32)
    pred = torch.as_tensor(pred).to(torch.float32)
    thresh = torch.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).to(torch.float32).mean()
    a2 = (thresh < 1.25 ** 2).to(torch.float32).mean()
    a3 = (thresh < 1.25 ** 3).to(torch.float32).mean()

    abs_rel = ((gt - pred).abs() / gt).mean()
    sq_rel = (((gt - pred) ** 2) / gt).mean()

    rmse = ((gt - pred) ** 2).mean().sqrt()
    rmse_log = ((gt.log() - pred.log()) ** 2).mean().sqrt()

    err_log = pred.log() - gt.log()
    silog = ((err_log ** 2).mean() - err_log.mean() ** 2).sqrt() * 100
    log_10 = (gt.log10() - pred.log10()).abs().mean()
    return dict(a1=a1, a2=a2, a3=a3, abs_rel=abs_rel, sq_rel=sq_rel,
                rmse=rmse, rmse_log=rmse_log, silog=silog, log_10=log_10)


def eval_crop_mask(shape, crop: Optional[str] = None) -> np.ndarray:
    """Evaluation masks: 'garg' or 'eigen' crops (reference misc.py:221-242)."""
    h, w = shape
    mask = np.ones((h, w), bool)
    if crop == "garg":
        mask[:] = False
        mask[int(0.40810811 * h):int(0.99189189 * h),
             int(0.03594771 * w):int(0.96405229 * w)] = True
    elif crop == "eigen":
        mask[:] = False
        mask[int(0.3324324 * h):int(0.91351351 * h),
             int(0.03594771 * w):int(0.96405229 * w)] = True
    return mask


def compute_metrics(gt: np.ndarray, pred: np.ndarray,
                    min_depth_eval: float = 1e-3,
                    max_depth_eval: float = 10.0,
                    crop: Optional[str] = None) -> Dict[str, float]:
    """Full evaluation path: clamp the prediction, validity and crop masks,
    then compute_errors (reference compute_metrics misc.py:202-249)."""
    gt = np.asarray(gt, np.float32)
    pred = np.array(pred, np.float32)
    pred = np.clip(pred, min_depth_eval, max_depth_eval)
    pred[np.isnan(pred)] = min_depth_eval
    pred[np.isinf(pred)] = max_depth_eval

    valid = (gt > min_depth_eval) & (gt < max_depth_eval)
    valid &= eval_crop_mask(gt.shape[-2:], crop)
    if not valid.any():
        return {}
    out = compute_errors(torch.from_numpy(gt[valid]),
                         torch.from_numpy(pred[valid]))
    return {k: float(v) for k, v in out.items()}
