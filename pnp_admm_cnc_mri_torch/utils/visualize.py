"""Zoom-box display helpers (reference ``utils/utils.py:58-109``, ``utils_image.py:33-47``).

A copy of the JAX package's ``utils/visualize.py``, which is numpy already:
``draw_box`` outlines a region (the reference's ``get_mask_image``,
cv2.drawContours thickness 2) and ``enlarge_region`` gives the region's
crop enlarged to the full image with a frame (``enlargement``, PIL resize),
on [0, 1] float or uint8 arrays, (H, W) or (H, W, C). ``imshow`` and
``surf`` import matplotlib inside the call; no solver path needs it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def draw_box(
    img: np.ndarray,
    top_left: Tuple[int, int],
    bottom_right: Tuple[int, int],
    value: float | None = None,
    thickness: int = 2,
) -> np.ndarray:
    """Return a copy of ``img`` with a rectangle outline drawn on it.

    ``top_left``/``bottom_right`` are ``(x, y)`` pixel coordinates like the
    reference's region anchors (``utils/utils.py:81-86``); the outline is
    ``thickness`` pixels wide and drawn *inside* the box bounds. ``value``
    defaults to white for the array's dtype (1.0 float / 255 uint)."""
    out = np.array(img, copy=True)
    if value is None:
        value = 255 if np.issubdtype(out.dtype, np.integer) else 1.0
    x1, y1 = top_left
    x2, y2 = bottom_right
    h, w = out.shape[:2]
    x1, x2 = sorted((int(np.clip(x1, 0, w)), int(np.clip(x2, 0, w))))
    y1, y2 = sorted((int(np.clip(y1, 0, h)), int(np.clip(y2, 0, h))))
    t = thickness
    out[y1:y2, x1:min(x1 + t, x2)] = value
    out[y1:y2, max(x2 - t, x1):x2] = value
    out[y1:min(y1 + t, y2), x1:x2] = value
    out[max(y2 - t, y1):y2, x1:x2] = value
    return out


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Plain bilinear resize (display affordance — the metric-exact MATLAB
    bicubic lives in ``ops/resize.imresize``)."""
    h, w = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)
    wx = np.clip(xs - x0, 0.0, 1.0)
    f = img.astype(np.float64)
    if img.ndim == 3:  # the weights broadcast over the channels (the JAX copy fails on (H, W, C))
        wx, wy = wx[:, None], wy[:, None, None]
    else:
        wy = wy[:, None]
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(out), 0, 255).astype(img.dtype)
    return out.astype(img.dtype)


def enlarge_region(
    img: np.ndarray,
    top_left: Tuple[int, int],
    bottom_right: Tuple[int, int],
    thickness: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference ``enlargement`` (``utils/utils.py:74-109``): returns
    ``(annotated, enlarged)`` — the image with the region outlined, and the
    region crop resized to the full image size with a frame around it."""
    h, w = img.shape[:2]
    annotated = draw_box(img, top_left, bottom_right, thickness=thickness)
    x1, y1 = top_left
    x2, y2 = bottom_right
    x1, x2 = sorted((int(x1), int(x2)))
    y1, y2 = sorted((int(y1), int(y2)))
    crop = np.asarray(img)[y1:y2, x1:x2]
    enlarged = _resize_bilinear(crop, h, w)
    enlarged = draw_box(enlarged, (0, 0), (w, h), thickness=thickness)
    return annotated, enlarged


def imshow(x, title=None, cbar=False, figsize=None, show=True):
    """Grayscale display helper (reference ``utils_image.py:33-40``).

    ``show=False`` returns the figure instead of blocking on plt.show()
    (headless/test use). Matplotlib is imported lazily — the solve paths
    never require it.
    """
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=figsize)
    plt.imshow(np.squeeze(np.asarray(x)), interpolation="nearest", cmap="gray")
    if title:
        plt.title(title)
    if cbar:
        plt.colorbar()
    if show:
        plt.show()
    return fig


def surf(z, show=True):
    """3-D surface display helper (reference ``utils_image.py:43-47``;
    the reference hardcodes a 25x25 grid — here the grid follows ``z``'s
    shape so any surface displays correctly)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    z = np.asarray(z)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    yy, xx = np.mgrid[0 : z.shape[0], 0 : z.shape[1]]
    ax.plot_surface(xx, yy, z, rstride=1, cstride=1, cmap="rainbow")
    fig.tight_layout()
    if show:
        plt.show()
    return fig
