"""On-device MRAW unpacking: raw packed bytes → pixels, on the device.

The host-to-device transfer is a first-order cost of the pipeline, so the
staging path ships the *packed* MRAW payload to device memory (1.5 bytes/px for
12-bit — a 1.33× transfer saving over decoded uint16, 2.67× over float32)
and unpacks on-device with vectorized integer ops. Parity oracle:
:func:`hsip_tpu.io.mraw.unpack_12bit` (host numpy) and the C++ decoder.

The fused entry (:func:`packed_centerline_profiles`) goes straight from
packed bytes to centerline profiles without materializing full decoded
frames in device memory: with byte-aligned rows only the band rows are decoded (the
full-frame decode feeding the empty-frame counts fuses into the count
reduction); rows that straddle byte boundaries gather the band from the
flat full-frame decode instead.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .preprocess import (
    _check_band_exactness,
    band_margin,
    band_to_profiles,
    reflect_indices,
)

__all__ = [
    "unpack_12bit_device",
    "unpack_10bit_device",
    "unpack_16bit_device",
    "unpack_8bit_device",
    "packed_centerline_profiles",
    "packed_band_profiles",
]


def unpack_12bit_device(packed: jnp.ndarray, out_dtype=jnp.uint16) -> jnp.ndarray:
    """Decode MSB-first 12-bit packed bytes (..., 3k) → pixels (..., 2k)."""
    b = packed.reshape(*packed.shape[:-1], -1, 3).astype(jnp.int32)
    p0 = (b[..., 0] << 4) | (b[..., 1] >> 4)
    p1 = ((b[..., 1] & 0x0F) << 8) | b[..., 2]
    out = jnp.stack([p0, p1], axis=-1)
    return out.reshape(*packed.shape[:-1], -1).astype(out_dtype)


def unpack_16bit_device(packed: jnp.ndarray, out_dtype=jnp.uint16) -> jnp.ndarray:
    """Decode little-endian 16-bit bytes (..., 2k) → pixels (..., k)."""
    b = packed.reshape(*packed.shape[:-1], -1, 2).astype(jnp.int32)
    out = b[..., 0] | (b[..., 1] << 8)
    return out.astype(out_dtype)


def unpack_8bit_device(packed: jnp.ndarray, out_dtype=jnp.uint16) -> jnp.ndarray:
    """8-bit payload bytes ARE the pixels — a cast, but shipping uint8
    halves the transfer vs decoded uint16 (quarters it vs float32)."""
    return packed.astype(out_dtype)


def unpack_10bit_device(packed: jnp.ndarray, out_dtype=jnp.uint16) -> jnp.ndarray:
    """Decode MSB-first 10-bit packed bytes (..., 5k) → pixels (..., 4k)."""
    b = packed.reshape(*packed.shape[:-1], -1, 5).astype(jnp.int32)
    p0 = (b[..., 0] << 2) | (b[..., 1] >> 6)
    p1 = ((b[..., 1] & 0x3F) << 4) | (b[..., 2] >> 4)
    p2 = ((b[..., 2] & 0x0F) << 6) | (b[..., 3] >> 2)
    p3 = ((b[..., 3] & 0x03) << 8) | b[..., 4]
    out = jnp.stack([p0, p1, p2, p3], axis=-1)
    return out.reshape(*packed.shape[:-1], -1).astype(out_dtype)


_UNPACKERS = {
    8: unpack_8bit_device,
    10: unpack_10bit_device,
    12: unpack_12bit_device,
    16: unpack_16bit_device,
}


def _unpack_rows(packed: jnp.ndarray, rows: jnp.ndarray, height: int,
                 width: int, bit_depth: int) -> jnp.ndarray:
    """Decode only selected ROWS from packed frames.

    ``packed`` is (N, frame_nbytes); each row of ``width`` pixels occupies
    ``width * bit_depth // 8`` contiguous bytes (callers gate on byte-aligned
    rows), so a row gather on the packed axis decodes just the band — the
    full frame never exists.
    """
    row_nbytes = width * bit_depth // 8
    n = packed.shape[0]
    per_row = packed.reshape(n, height, row_nbytes)
    band_rows = per_row[:, rows, :]  # (N, B, row_nbytes)
    return _UNPACKERS[bit_depth](band_rows, out_dtype=jnp.float32)


def rows_byte_aligned(width: int, bit_depth: int) -> bool:
    """True when each image row spans a whole number of packed bytes (so a
    row gather can happen on the byte axis before decoding)."""
    return (width * bit_depth) % 8 == 0


@partial(
    jax.jit,
    static_argnames=(
        "morphology_kernel_size", "gaussian_sigma", "bit_depth",
    ),
)
def packed_band_profiles(
    band_bytes: jnp.ndarray,
    background_scalar: jnp.ndarray,
    prior_index: jnp.ndarray,
    frame_diff_threshold: jnp.ndarray,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
    bit_depth: int = 12,
):
    """Packed BAND bytes (N, B, row_nbytes) → centerline profiles.

    The minimal-transfer path: the host ships only the 2M+1 band rows
    (~15% of a 128-row frame) and computes the empty-frame counts itself
    (C++ fused pass); the device decodes the band and runs the fused chain.
    Returns (sobel, gradient, intensity, raw_center) — all (N, W) f32.
    """
    band_pixels = _UNPACKERS[bit_depth](band_bytes, out_dtype=jnp.float32)  # (N, B, W)
    band = jnp.maximum(band_pixels - background_scalar, 0.0)
    margin = (band.shape[1] - 1) // 2
    raw_center_lines = band[:, margin, :]

    sobel_lines, gradient_lines, intensity_lines = band_to_profiles(
        band, prior_index, frame_diff_threshold,
        morphology_kernel_size, gaussian_sigma,
    )
    return sobel_lines, gradient_lines, intensity_lines, raw_center_lines


@partial(
    jax.jit,
    static_argnames=(
        "height", "width", "morphology_kernel_size", "gaussian_sigma",
        "center_row", "bit_depth",
    ),
)
def packed_centerline_profiles(
    packed: jnp.ndarray,
    height: int,
    width: int,
    background_scalar: jnp.ndarray,
    prior_index: jnp.ndarray,
    frame_diff_threshold: jnp.ndarray,
    noise_threshold: jnp.ndarray,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
    center_row: Optional[int] = None,
    bit_depth: int = 12,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Packed bytes (N, frame_nbytes) → centerline profiles + counts.

    Same contract as :func:`hsip_tpu.kernels.preprocess.
    batch_centerline_profiles` but the input is the raw MRAW payload
    (10/12-bit packing or raw 16-bit, per ``bit_depth``); the band (2M+1
    rows) is decoded on-device and the empty-frame signal count is computed
    from the full decoded frame (one cheap pass).
    """
    if center_row is None:
        center_row = height // 2
    margin = band_margin(morphology_kernel_size, gaussian_sigma)
    _check_band_exactness(morphology_kernel_size, center_row, margin, height)
    rows = jnp.asarray(reflect_indices(center_row, margin, height))

    # Empty-frame counts need the whole frame: decode once, count, discard.
    # (XLA fuses the decode+compare+reduce into one pass over the bytes.)
    full = _UNPACKERS[bit_depth](packed, out_dtype=jnp.float32)
    sub_full = jnp.maximum(full - background_scalar, 0.0)
    counts = jnp.sum((sub_full > noise_threshold).astype(jnp.int32), axis=-1)

    if rows_byte_aligned(width, bit_depth):
        band_pixels = _unpack_rows(packed, rows, height, width, bit_depth)
    else:
        # Rows straddle byte boundaries (e.g. odd-width 12-bit): the frame
        # is still byte-aligned as a flat pixel stream, and the full decode
        # above already exists for the counts — gather the band from it.
        band_pixels = full.reshape(full.shape[0], height, width)[:, rows, :]
    band = jnp.maximum(band_pixels - background_scalar, 0.0)
    raw_center_lines = band[:, margin, :]

    sobel_lines, gradient_lines, intensity_lines = band_to_profiles(
        band, prior_index, frame_diff_threshold,
        morphology_kernel_size, gaussian_sigma,
    )
    return sobel_lines, gradient_lines, intensity_lines, raw_center_lines, counts
