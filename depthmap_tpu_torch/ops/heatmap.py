"""Depth heatmap colorization (numpy).

Restated from ``depthmap_tpu/ops/heatmap.py`` (held byte-equal by
tests/test_torch_port_outputs.py, with and without matplotlib): the
reference ``colorize`` as the funnel calls it (cmap 'inferno', defaults
otherwise): percentile 2 / 85 normalization, the colormap lookup with
``bytes=True``, invalid pixels (== -99) painted (128, 128, 128, 255).
Without matplotlib the bundled inferno table gives the same bytes.
"""
from __future__ import annotations

import functools

import numpy as np

try:
    import matplotlib
    import matplotlib.cm
    _HAVE_MPL = True
except Exception:  # pragma: no cover
    _HAVE_MPL = False


# matplotlib.colormaps['inferno'](np.arange(256), bytes=True), zlib +
# base64: the lookup without matplotlib emits the bytes matplotlib would
_INFERNO_B64 = (
    "eJwNwwlQVHUAwGEu2X37lhUQERDkkkPuS5BDTjkEOQIE5JBDbnY3xrTS0pFxKK10ZBwq"
    "xnSoGLscy8qxcsyxcswxx6zMMc0cM9IMY3c5dvdZv/7fzOfg4IyDg4voiqODCkdHSZRx"
    "ctTh5OSOs5MnLs5eojcLXHxwdVmKakEAatdAJNdgNKpQZFU4bupIdOooFkqxuEvxeGqS"
    "WKRJwUtOxVtOZ4mcia+cjZ+ci7+2gABtIYHaYoK0pYTI61guVxAuVxEhV7NCriVaU0es"
    "poE4TSMJmmaSpBZSpFZWSm2kSe2kSx1kSp1kSV1kS93kinlSDwWaXgo1fRSJJXI/pWKZ"
    "doBysdJNT5VYrdNTozOwfqGBerHB3UCjh4EmDyMtnkZaxbZFRjq8jGwSuxYb6RZ7vY30"
    "LzEyIBp8jBjFQV8jm30NPOVnYOtSA0+Lz/ob2C4+F6Bnh7hzmZ5dgQMMibuDBhgO6ueF"
    "4H72iHtD+nhZ3Bfax/7lvRwQR8J6OCiOhnfzqvh6RBdjkZ0cEt9YsYkj4nhUB29Gt/O2"
    "OBHTxtGYVt6JbeW9uI18ENfCsfhmjic08WFiEycSG/k4aQOfJjdwMrmeUyl1fLayji9S"
    "13M6rZYzaTV8uaqas+lPcC6jiq8yK/kmq4Lzq8u5kL2Ob7PLuJhTyqXctXyXV8Ll/GKu"
    "rCni+8I1XC0q4IfifH4qyePa2lx+Ls3helk2N8pX80tFJjcrM7hVlc6v1au4XZPGb7Wp"
    "3KlL4W59Mr83JHGvMZE/mhKYbI5jcmMsf7bGcL89mgcdUfzVGcnDrgj+7glnqjeMqf5Q"
    "HulD+McQzPSTgUwPLsO0OQDzFn/MW/2wPOOLZZsPM9u9mX1+MbM7vZjb5cnckAfzu92Z"
    "H9ZhfdEN6x4t1pdkbK9I2ParsR1QYx9RYT/oin1UfM0VZUw8JB4Wj6hQxsW31CgTGpSj"
    "Msq7bijv61COuaMc90T5yAvlhDfKJz4oJ/1QTvmjfL4M++lg7GdCsZ8Nw34uEtvXUdjO"
    "x2C7EI/1YiLWSylYL6cxfyWD+atZzP2Yw9y1fGavFzJ7o4SZm2XM3KrEcrsay506LHc3"
    "YL7XgnmyDdP9TkwPejE91GOaGsT0aAum6W2YzDswW4YwzwxjmdvLzPw+Zq0jzNlHmVfG"
    "sD0+jP3fcR7/N8H/k8Q5iw==")


@functools.lru_cache(maxsize=None)
def _cmap_table(cmap: str) -> np.ndarray:
    """(256, 4) uint8 table used without matplotlib: inferno, and
    grayscale for any other cmap (the funnel asks only for inferno)."""
    if cmap == "inferno":
        import base64
        import zlib
        raw = zlib.decompress(base64.b64decode(_INFERNO_B64))
        return np.frombuffer(raw, np.uint8).reshape(256, 4).copy()
    g = np.arange(256, dtype=np.uint8)
    return np.stack([g, g, g, np.full(256, 255, np.uint8)], axis=1)


def colorize(value: np.ndarray, vmin=None, vmax=None, cmap="inferno",
             invalid_val=-99, invalid_mask=None,
             background_color=(128, 128, 128, 255)) -> np.ndarray:
    """value: (H, W) array -> (H, W, 4) uint8 heatmap."""
    value = np.asarray(value, dtype=np.float64).squeeze()
    if invalid_mask is None:
        invalid_mask = value == invalid_val
    mask = np.logical_not(invalid_mask)

    vmin = np.percentile(value[mask], 2) if vmin is None else vmin
    vmax = np.percentile(value[mask], 85) if vmax is None else vmax
    if vmin != vmax:
        value = (value - vmin) / (vmax - vmin)
    else:
        value = value * 0.0

    value[invalid_mask] = np.nan
    if _HAVE_MPL:
        img = matplotlib.colormaps[cmap](value, bytes=True)
    else:
        # matplotlib's Colormap.__call__ index rule: xa = x * N,
        # xa[xa == N] = N - 1; under (< 0, -inf included) -> the first row,
        # over (>= N, +inf included) -> the last, NaN only -> (0, 0, 0, 0)
        tab = _cmap_table(cmap)
        xa = value * 256.0
        bad = np.isnan(xa)
        xa = np.where(xa == 256.0, 255.0, xa)
        xa = np.nan_to_num(xa, nan=0.0, posinf=255.0, neginf=0.0)
        idx = np.clip(xa, 0, 255).astype(np.int32)
        img = tab[idx]
        img[bad] = (0, 0, 0, 0)
    img[invalid_mask] = background_color
    return img
