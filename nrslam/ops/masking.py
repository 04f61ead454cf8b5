"""Image masking filters: border, brightness, and predefined masks.

Device-kernel re-design of /root/reference/modules/masking/: each filter
produces a bool [H, W] validity mask; the Masker ANDs all configured filters
plus a final erosion into the "Global" mask consumed by tracking
(masker.cc:161-182). All ops are jittable (reduce_window erosions).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import jax.numpy as jnp

from nrslam.ops import image as image_ops


def border_filter(gray: jnp.ndarray, rows: int = 0, cols: int = 0,
                  erode_size: int = 21) -> jnp.ndarray:
    """Crop a frame border + drop dead (zero) pixels, then erode.

    BorderFilter (border_filter.cc:24-38): rows/cols cropped from each side,
    zero-valued pixels masked out, 21x21 erosion.
    """
    h, w = gray.shape
    mask = jnp.ones((h, w), bool)
    if rows > 0:
        mask = mask.at[:rows].set(False).at[-rows:].set(False)
    if cols > 0:
        mask = mask.at[:, :cols].set(False).at[:, -cols:].set(False)
    mask = mask & (gray > 0)
    return image_ops.erode(mask, erode_size)


def bright_filter(gray: jnp.ndarray, threshold: float = 220.0,
                  erode_size: int = 11, blur_size: int = 11) -> jnp.ndarray:
    """Mask out specular/over-exposed regions.

    BrightFilter (bright_filter.cc:24-39): blur, inverse threshold (pixels
    above ``threshold`` invalid), elliptical erosion. The reference's
    elliptical structuring element is approximated by the square one (the
    11 px scale dominates; detections are gated far from mask borders anyway).
    """
    blurred = image_ops.gaussian_blur(gray, blur_size)
    mask = blurred < threshold
    return image_ops.erode(mask, erode_size)


def predefined_filter(static_mask: jnp.ndarray, erode_size: int = 20) -> Callable:
    """Fixed PNG-style mask (e.g. endoscope borders) + erosion
    (predefined_filter.cc:27-35). Returns a filter closure."""
    eroded = image_ops.erode(static_mask > 0, erode_size)

    def apply(gray: jnp.ndarray) -> jnp.ndarray:
        return eroded

    return apply


class Masker:
    """Combine named filters into per-filter masks + the eroded Global AND.

    Masker (masker.cc:99-182). Filter configs follow the reference's
    filters.txt lines: ("BorderFilter", rows, cols), ("BrightFilter", thr),
    ("PredefinedFilter", mask_array).
    """

    FINAL_ERODE = 10  # masker.cc:176

    def __init__(self, filter_specs: Sequence[tuple] = ()):
        self.filters: Dict[str, Callable] = {}
        for spec in filter_specs:
            name = spec[0]
            if name == "BorderFilter":
                rows, cols = (spec[1], spec[2]) if len(spec) > 2 else (0, 0)
                self.filters[name] = lambda g, r=rows, c=cols: border_filter(g, r, c)
            elif name == "BrightFilter":
                thr = spec[1] if len(spec) > 1 else 220.0
                self.filters[name] = lambda g, t=thr: bright_filter(g, t)
            elif name == "PredefinedFilter":
                self.filters[name] = predefined_filter(spec[1])
            else:
                raise ValueError(f"unknown filter {name}")

    def get_all_masks(self, gray: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        masks = {name: f(gray) for name, f in self.filters.items()}
        combined = jnp.ones(gray.shape, bool)
        for m in masks.values():
            combined = combined & m
        masks["Global"] = image_ops.erode(combined, self.FINAL_ERODE)
        return masks

    def __call__(self, gray: jnp.ndarray) -> jnp.ndarray:
        return self.get_all_masks(gray)["Global"]
