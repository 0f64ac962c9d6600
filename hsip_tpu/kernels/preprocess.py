"""Batched preprocess: fused frame-diff → opening → blur → Sobel/gradient.

This is the hot compute path. The reference runs scipy filters over full
frames, one frame at a time, per MPI rank (``scripts/process_videos.py:
398-413``). Here the whole chain runs batched over frames on the device
with a **centerline-band optimization**: detection only ever reads the
centerline row of the Sobel/gradient outputs, and every op in the chain has
a bounded vertical footprint —

    opening (k×k):      ±(k-1)
    Gaussian blur (σ):  ±int(4σ + 0.5)
    Sobel row smooth:   ±1

so only ``2*margin + 1`` rows around the centerline (19 rows for default
config) are ever computed, instead of the full frame height. Rows are
gathered with reflect indexing, which reproduces scipy's 'reflect' boundary
exactly even when the band folds over the image edge, so band results are
bit-comparable (in float32) to full-frame scipy.

Everything is pure jnp under ``jax.jit`` — static shapes, no Python control
flow on traced values — so XLA fuses the chain into a few memory-bound
elementwise/window loops.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "band_margin",
    "band_folds",
    "reflect_indices",
    "gaussian_taps",
    "grey_opening_band",
    "blur_band",
    "sobel_gradient_lines",
    "diff_profiles_from_band",
    "band_to_profiles",
    "batch_centerline_profiles",
    "subtract_background",
    "signal_count",
]


def band_margin(morphology_kernel_size: int, gaussian_sigma: float, truncate: float = 4.0) -> int:
    """Vertical half-extent of rows the centerline result depends on."""
    r_open = morphology_kernel_size - 1
    r_gauss = int(truncate * float(gaussian_sigma) + 0.5)
    r_sobel = 1
    return r_open + r_gauss + r_sobel


def band_folds(center: int, margin: int, n: int) -> bool:
    """True when the centerline band extends past the image rows.

    Folding is handled exactly by reflect row-gathering for SYMMETRIC
    vertical windows (odd morphology kernels, Gaussian, Sobel). For EVEN
    morphology kernels the erosion/dilation windows are asymmetric and do
    not commute with reflection, so folding configurations must use the
    per-stage-repadding host ops instead (see scan.compute_profiles_batched).
    """
    return center - margin < 0 or center + margin > n - 1


def _check_band_exactness(k: int, center: int, margin: int, n: int) -> None:
    """Refuse the one configuration the band kernels cannot reproduce.

    Even morphology kernels have asymmetric vertical windows that do not
    commute with the reflect row-gathering when the band folds over the
    image edge; the kernel would silently return non-scipy-parity profiles.
    All in-tree callers route this case to the float64 host fallback first
    (track/scan.py); this guard protects direct users of the kernel API.
    All arguments are static, so the check costs nothing under jit.
    """
    if k % 2 == 0 and band_folds(center, margin, n):
        raise ValueError(
            f"even morphology kernel (k={k}) with a folding centerline band "
            f"(margin {margin} at row {center} of {n}) is not exactly "
            f"representable by the band kernels; use the float64 host ops "
            f"(hsip_tpu.kernels.reference) for this geometry"
        )


def reflect_indices(center: int, margin: int, n: int) -> np.ndarray:
    """Row indices [center-margin, center+margin] with scipy 'reflect'
    (symmetric) folding into [0, n): triangle wave of period 2n."""
    idx = np.arange(center - margin, center + margin + 1)
    period = 2 * n
    idx = np.mod(idx, period)  # non-negative: np.mod keeps the divisor's sign
    return np.where(idx >= n, period - 1 - idx, idx).astype(np.int32)


def gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Normalized Gaussian taps: the host reference's kernel in float32.

    Delegates to :func:`hsip_tpu.kernels.reference.gaussian_kernel1d` so the
    tap radius can never drift from ``band_margin``'s ``r_gauss`` formula or
    the scipy-parity oracle — a drifted copy would mis-size the band while
    both copies still looked individually correct.
    """
    from .reference import gaussian_kernel1d

    return gaussian_kernel1d(sigma, truncate).astype(np.float32)


def _pad_w(x: jnp.ndarray, left: int, right: int) -> jnp.ndarray:
    """Symmetric (scipy 'reflect') padding along the last (width) axis."""
    if left == 0 and right == 0:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(left, right)], mode="symmetric")


def _sliding_extremum_w(x: jnp.ndarray, k: int, op, dilation: bool) -> jnp.ndarray:
    """Running min/max along width with reflect boundary (static k taps)."""
    if k <= 1:
        return x
    if not dilation:
        left = k // 2
    else:
        left = k - 1 - k // 2
    right = k - 1 - left
    padded = _pad_w(x, left, right)
    w = x.shape[-1]
    out = jax.lax.slice_in_dim(padded, 0, w, axis=-1)
    for off in range(1, k):
        out = op(out, jax.lax.slice_in_dim(padded, off, off + w, axis=-1))
    return out


def _sliding_extremum_rows(x: jnp.ndarray, k: int, op) -> jnp.ndarray:
    """Running min/max along the row (second-to-last) axis, VALID — shrinks
    the band by k-1 rows (window origin is absorbed by the VALID crop
    accounting in band_margin, so rows need no erosion/dilation flag)."""
    if k <= 1:
        return x
    nrows = x.shape[-2]
    out = jax.lax.slice_in_dim(x, 0, nrows - k + 1, axis=-2)
    for off in range(1, k):
        out = op(out, jax.lax.slice_in_dim(x, off, off + nrows - k + 1, axis=-2))
    return out


def grey_opening_band(band: jnp.ndarray, k: int) -> jnp.ndarray:
    """Grey opening (erosion→dilation, k×k flat) on a row band.

    Horizontal: reflect boundary (full width preserved). Vertical: VALID —
    the output band loses k-1 rows at each end, consistent with
    :func:`band_margin` accounting.
    """
    # Erosion: min filter. scipy centers even windows left for erosion.
    ero = _sliding_extremum_w(band, k, jnp.minimum, dilation=False)
    ero = _sliding_extremum_rows(ero, k, jnp.minimum)
    # Dilation: max filter with flipped (mirrored) window placement.
    dil = _sliding_extremum_w(ero, k, jnp.maximum, dilation=True)
    dil = _sliding_extremum_rows(dil, k, jnp.maximum)
    return dil


def blur_band(band: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Separable Gaussian: reflect along width, VALID along rows."""
    ntaps = taps.shape[0]
    radius = (ntaps - 1) // 2
    # Horizontal with reflect.
    padded = _pad_w(band, radius, radius)
    w = band.shape[-1]
    out_h = taps[0] * jax.lax.slice_in_dim(padded, 0, w, axis=-1)
    for j in range(1, ntaps):
        out_h = out_h + taps[j] * jax.lax.slice_in_dim(padded, j, j + w, axis=-1)
    # Vertical VALID.
    nrows = band.shape[-2]
    out = taps[0] * jax.lax.slice_in_dim(out_h, 0, nrows - ntaps + 1, axis=-2)
    for j in range(1, ntaps):
        out = out + taps[j] * jax.lax.slice_in_dim(
            out_h, j, j + nrows - ntaps + 1, axis=-2
        )
    return out


def sobel_gradient_lines(
    blurred3: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Centerline (Sobel, gradient, intensity) from a 3-row blurred band.

    ``blurred3`` is (..., 3, W): rows center-1, center, center+1.
    Sobel(axis=1) = [-1,0,1] along width ∘ [1,2,1] along rows;
    gradient = np.gradient along width (central diff, one-sided edges);
    intensity = the blurred center row itself (input to the threshold /
    half_maximum / gradient profile detectors).
    """
    w = blurred3.shape[-1]
    # Vertical [1, 2, 1] smoothing onto the center row.
    smoothed = (
        blurred3[..., 0, :] + 2.0 * blurred3[..., 1, :] + blurred3[..., 2, :]
    )
    # Horizontal [-1, 0, 1] with reflect boundary.
    padded = _pad_w(smoothed, 1, 1)
    sobel_line = jax.lax.slice_in_dim(padded, 2, w + 2, axis=-1) - jax.lax.slice_in_dim(
        padded, 0, w, axis=-1
    )
    # np.gradient on the center row.
    center = blurred3[..., 1, :]
    interior = (center[..., 2:] - center[..., :-2]) * 0.5
    left = (center[..., 1:2] - center[..., 0:1])
    right = (center[..., -1:] - center[..., -2:-1])
    gradient_line = jnp.concatenate([left, interior, right], axis=-1)
    return sobel_line, gradient_line, center


def diff_profiles_from_band(
    diff_band: jnp.ndarray,
    morphology_kernel_size: int,
    taps: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Thresholded diff band (..., 2M+1, W) → centerline
    (sobel, gradient, intensity)."""
    opened = grey_opening_band(diff_band, morphology_kernel_size)
    blurred = blur_band(opened, taps)
    return sobel_gradient_lines(blurred)


def band_to_profiles(
    band: jnp.ndarray,
    prior_index: jnp.ndarray,
    frame_diff_threshold,
    morphology_kernel_size: int,
    gaussian_sigma: float,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """BG-subtracted band (N, 2M+1, W) → masked (sobel, gradient, intensity)
    centerline profiles: prior gather → diff → threshold → fused chain →
    zero rows without a prior. The single semantic core shared by every
    band entry point (full-frame gather, packed full-frame, packed band).

    Validates the band height against ``band_margin``: a band built for
    different (k, sigma) would otherwise silently produce profiles
    centered off the centerline.
    """
    expected = 2 * band_margin(morphology_kernel_size, gaussian_sigma) + 1
    if band.shape[-2] != expected:
        raise ValueError(
            f"band has {band.shape[-2]} rows; k={morphology_kernel_size}, "
            f"sigma={gaussian_sigma} needs {expected}"
        )
    taps = jnp.asarray(gaussian_taps(gaussian_sigma))
    prior_band = band[jnp.maximum(prior_index, 0)]
    diff = band - prior_band
    diff = jnp.where(diff < frame_diff_threshold, 0.0, diff)
    sob, grad, intens = diff_profiles_from_band(
        diff, morphology_kernel_size, taps
    )
    valid = (prior_index >= 0)[:, None]
    return (
        jnp.where(valid, sob, 0.0),
        jnp.where(valid, grad, 0.0),
        jnp.where(valid, intens, 0.0),
    )


def subtract_background(frames: jnp.ndarray, background_scalar: float) -> jnp.ndarray:
    """Scalar background subtraction clamped at zero (float32)."""
    return jnp.maximum(frames.astype(jnp.float32) - background_scalar, 0.0)


def signal_count(sub: jnp.ndarray, noise_threshold: float) -> jnp.ndarray:
    """Per-frame COUNT of above-noise pixels (int32, exact).

    The empty-frame decision (count / size < min_signal_fraction) is made on
    host in float64 so it is bit-identical to the reference's numpy check;
    pixel values are integers so the f32 comparison itself is exact.
    """
    return jnp.sum((sub > noise_threshold).astype(jnp.int32), axis=(-2, -1))


@partial(
    jax.jit,
    static_argnames=(
        "morphology_kernel_size", "gaussian_sigma", "center_row",
    ),
)
def batch_centerline_profiles(
    frames: jnp.ndarray,
    background_scalar: jnp.ndarray,
    prior_index: jnp.ndarray,
    frame_diff_threshold: jnp.ndarray,
    noise_threshold: jnp.ndarray,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
    center_row: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full batched preprocess: frames → centerline profiles + empty stats.

    Args:
        frames: (N, H, W) raw frames (any integer/float dtype).
        background_scalar: scalar background (from frame 0's max).
        prior_index: (N,) int32 — index of each frame's differencing prior
            (previous processed frame); -1 marks "no prior" (profiles for
            those frames are zeros; callers ignore them).
        frame_diff_threshold: scalar; diff values below it are zeroed.
        noise_threshold: scalar for the empty-frame signal fraction.
        morphology_kernel_size, gaussian_sigma: chain parameters (static).
        center_row: centerline row (defaults to H // 2; static).

    Returns:
        (sobel_lines (N, W), gradient_lines (N, W), intensity_lines (N, W) —
        the blurred diff centerline consumed by the threshold/half_maximum/
        gradient profile detectors, raw_center_lines (N, W) — the BG-
        subtracted centerline, signal_counts (N,) i32). Diff-derived rows
        with prior_index < 0 are zero.
    """
    n, h, w = frames.shape
    if center_row is None:
        center_row = h // 2
    margin = band_margin(morphology_kernel_size, gaussian_sigma)
    _check_band_exactness(morphology_kernel_size, center_row, margin, h)
    rows = jnp.asarray(reflect_indices(center_row, margin, h))

    sub = subtract_background(frames, background_scalar)
    counts = signal_count(sub, noise_threshold)

    band = sub[:, rows, :]  # (N, 2M+1, W)
    raw_center_lines = band[:, margin, :]
    sobel_lines, gradient_lines, intensity_lines = band_to_profiles(
        band, prior_index, frame_diff_threshold,
        morphology_kernel_size, gaussian_sigma,
    )
    return sobel_lines, gradient_lines, intensity_lines, raw_center_lines, counts
