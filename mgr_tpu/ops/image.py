"""ROI crop + resize for the RGB stream — XLA re-design of
/root/reference/rgb_network/roi_extraction.py:18-80 (OpenCV crop +
INTER_CUBIC resize).

The reference crops a per-frame upper-body box from skeletal joints
(shcY-120 .. hipY+120, hipX-180 .. hipX+180, clipped to 640x480) and
bicubic-resizes to 60x60. A dynamic-size crop followed by a resize is
not expressible with static shapes, so the formulation here uses
``jax.image.scale_and_translate`` with a cubic (Keys) kernel: the resize
reads directly from the source box, output shape static, box parameters
traced — one fused XLA op per frame batch, vmappable over time.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def upper_body_box(
    hip_xy: jax.Array, shc_xy: jax.Array,
    width: int = 640, height: int = 480,
) -> jax.Array:
    """Per-frame crop box [up, down, left, right] with the reference's
    margins and clipping (roi_extraction.py:45-53)."""
    up = shc_xy[..., 1] - 120.0
    down = hip_xy[..., 1] + 120.0
    left = hip_xy[..., 0] - 180.0
    right = hip_xy[..., 0] + 180.0
    up = jnp.clip(up, 1.0, height - 1.0)
    down = jnp.clip(down, 1.0, height - 1.0)
    left = jnp.clip(left, 1.0, width - 1.0)
    right = jnp.clip(right, 1.0, width - 1.0)
    return jnp.stack([up, down, left, right], axis=-1)


FALLBACK_BOX = (0.0, 330.0, 0.0, 640.0)  # roi_extraction.py:62-69


def crop_resize_frame(
    frame: jax.Array, box: jax.Array, out_dim: int = 60
) -> jax.Array:
    """(H, W) grayscale frame + [up, down, left, right] -> (out_dim,
    out_dim) cubic-resampled crop."""
    up, down, left, right = box[0], box[1], box[2], box[3]
    h = jnp.maximum(down - up, 1.0)
    w = jnp.maximum(right - left, 1.0)
    scale = jnp.stack([out_dim / h, out_dim / w])
    translation = jnp.stack([-up * out_dim / h, -left * out_dim / w])
    return jax.image.scale_and_translate(
        frame.astype(jnp.float32), (out_dim, out_dim), (0, 1),
        scale, translation, method="cubic",
    )


def rgb_to_gray(frame: jax.Array) -> jax.Array:
    """(H, W, 3) BGR/RGB -> (H, W) luma (OpenCV BGR2GRAY weights,
    roi_extraction.py:43)."""
    r, g, b = frame[..., 2], frame[..., 1], frame[..., 0]
    return 0.299 * r + 0.587 * g + 0.114 * b


def extract_upper_body_video(
    video: jax.Array,
    hip: jax.Array,
    shc: jax.Array,
    out_dim: int = 60,
    valid: Optional[jax.Array] = None,
) -> jax.Array:
    """(T, H, W) gray video + (T, 2) hip/shc tracks -> (T, out_dim,
    out_dim, 1) cropped frames.

    ``valid`` (T,) marks frames with usable skeletal data; invalid
    frames use the fixed fallback box (roi_extraction.py:62-69)."""
    boxes = upper_body_box(hip, shc)
    if valid is not None:
        fb = jnp.asarray(FALLBACK_BOX)
        boxes = jnp.where(valid[:, None], boxes, fb[None, :])
    out = jax.vmap(lambda f, b: crop_resize_frame(f, b, out_dim))(
        video, boxes
    )
    return out[..., None]
