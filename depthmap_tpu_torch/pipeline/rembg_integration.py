"""Background removal through the optional ``rembg`` package.

Port of ``depthmap_tpu/pipeline/rembg_integration.py`` (the reference's
src/core.py:675-692 and the mask of :219-236), on numpy arrays where the
JAX module returns PIL images: ``batched_background_removal`` gives (H, W,
4) uint8 RGBA arrays, ``foreground_mask_image`` an (H, W, 4) uint8 mask.
``rembg`` (U2Net / IS-Net with their own downloaded weights) is imported
only when background removal runs.
"""
from __future__ import annotations

from typing import List

import numpy as np

REMBG_MODELS = ("u2net", "u2netp", "u2net_human_seg", "silueta",
                "isnet-general-use", "isnet-anime")


def rembg_available() -> bool:
    try:
        import rembg  # noqa: F401
        return True
    except Exception:
        return False


def batched_background_removal(inimages: List,
                               model_name: str) -> List[np.ndarray]:
    """Each image (PIL or array) through one rembg session of
    ``model_name`` -> its (H, W, 4) uint8 RGBA array."""
    from PIL import Image
    from rembg import new_session, remove
    session = new_session(model_name)
    out = []
    for im in inimages:
        if not isinstance(im, Image.Image):
            im = Image.fromarray(np.asarray(im))
        out.append(np.array(remove(im, session=session)))
    del session
    return out


def background_mask(background_removed_image) -> np.ndarray:
    """Pixels that are pure black with alpha <= 0.2 (reference
    core.py:224-227)."""
    arr = np.asarray(background_removed_image)
    return ((arr[:, :, 0] == 0) & (arr[:, :, 1] == 0)
            & (arr[:, :, 2] == 0) & (arr[:, :, 3] <= 0.2))


def foreground_mask_image(bg_mask: np.ndarray) -> np.ndarray:
    """The save_background_removal_masks output (reference
    core.py:231-236): 255 on the foreground, 0 on the background, in 4
    channels."""
    bg_array = (1 - bg_mask.astype("int16")) * 255
    return np.stack([bg_array] * 4, axis=2).astype(np.uint8)
