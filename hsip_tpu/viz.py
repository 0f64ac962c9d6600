"""Visualization: per-frame diagnostic figures and stacked-sequence plots.

Parity target: reference ``scripts/process_videos.py:783-1270`` — the
12-panel per-frame diagnostic (pipeline stages, centerline profiles, result
overlay, position history + spline, velocity comparison) and the paper-style
stacked sequences.

Design note: the hot tracking path never materializes full-frame
intermediates (it runs the band-optimized kernel); when diagnostics are
requested, :func:`save_frame_image_from_video` recomputes the full-frame
stages on host for the frames being rendered. Rendering is matplotlib/Agg on
host, fed asynchronously from the tracking loop.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import List, Optional

import numpy as np

try:
    import matplotlib
except ImportError as exc:  # only figure paths import this module
    raise ImportError(
        "hsip figures need matplotlib (pip install 'hsip-tpu[viz]'); "
        "run with --no-images --no-sequences to skip them"
    ) from exc

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .kernels import reference as hostops  # noqa: E402
from .track.config import FlameDetectionResult, FlameDetectorConfig  # noqa: E402

__all__ = [
    "save_frame_image",
    "save_frame_image_compact",
    "save_frame_image_from_video",
    "render_diagnostics_parallel",
    "generate_stacked_sequence",
    "generate_stacked_sequence_single_column",
]


def _imshow_panel(ax, img, title, cmap, center_row, symmetric=False):
    """One image panel with a centerline marker and 99th-pct scaling."""
    if img is None:
        ax.text(0.5, 0.5, "N/A", ha="center", va="center",
                transform=ax.transAxes, fontsize=12)
        ax.set_facecolor("lightgray")
    else:
        if symmetric:
            vmax = np.percentile(np.abs(img), 99) if np.any(img != 0) else 1
            ax.imshow(img, cmap=cmap, aspect="auto", vmin=-vmax, vmax=vmax)
        elif cmap == "gray":
            ax.imshow(img, cmap=cmap, aspect="auto")
        else:
            vmax = np.percentile(img, 99) if np.any(img > 0) else 1
            ax.imshow(img, cmap=cmap, aspect="auto", vmin=0, vmax=vmax)
        line_color = "black" if symmetric else "cyan"
        ax.axhline(y=center_row, color=line_color, linestyle="--",
                   linewidth=0.5, alpha=0.5)
    ax.set_title(title, fontsize=10)
    ax.set_ylabel("Y")


def _position_markers(ax, result: FlameDetectionResult, show_final=True):
    if result.search_bounds:
        ax.axvline(x=result.search_bounds[0], color="lime", linestyle="--",
                   linewidth=1.5, alpha=0.8)
        ax.axvline(x=result.search_bounds[1], color="lime", linestyle=":",
                   linewidth=1.5, alpha=0.8)
    if result.pos_min_gradient is not None:
        ax.axvline(x=result.pos_min_gradient, color="purple", linestyle="-",
                   linewidth=2, alpha=0.7)
    if result.pos_rightmost_sobel is not None:
        ax.axvline(x=result.pos_rightmost_sobel, color="orange", linestyle="-",
                   linewidth=2, alpha=0.7)
    if show_final and result.final_position is not None:
        ax.axvline(x=result.final_position, color="red", linestyle="-",
                   linewidth=3, alpha=0.9)


def save_frame_image(
    frame: np.ndarray,
    result: FlameDetectionResult,
    output_path: Path,
    source_name: str,
    detector=None,
) -> Path:
    """Render the 12-panel per-frame diagnostic figure.

    Panels: 6 pipeline-stage images (BG-sub, frame diff, opening, blur,
    Sobel, gradient), 3 centerline profiles with detection markers, result
    overlay with all candidates, position history + spline, velocity
    comparison (3 stencils + DDT marker). ``detector`` may be a
    FlameDetector or FlameTracker (history/spline/velocity source).
    """
    height, width = frame.shape[:2]
    center_row = height // 2
    x_pixels = np.arange(width)

    img_h, plot_h = 1.5, 2.5
    fig = plt.figure(figsize=(14, 6 * img_h + 6 * plot_h))
    ratios = [img_h] * 6 + [plot_h] * 3 + [img_h, plot_h, plot_h]
    gs = fig.add_gridspec(12, 1, height_ratios=ratios, hspace=0.3)
    axes = [fig.add_subplot(gs[i, 0]) for i in range(12)]

    velocity_str = ""
    if detector is not None and detector.last_velocity is not None:
        velocity_str = f" | v={detector.last_velocity:.1f} m/s"

    # 1-6: pipeline stages.
    _imshow_panel(
        axes[0], result.frame_subtracted,
        f"1. BG Subtracted - Frame {result.frame_idx} | "
        f"t={result.time_s * 1e6:.1f} µs{velocity_str}",
        "gray", center_row,
    )
    _imshow_panel(axes[1], result.frame_diff, "2. Frame Diff (current - prior)",
                  "hot", center_row)
    _imshow_panel(axes[2], result.noise_removed,
                  "3. Noise Removed (morphological opening)", "hot", center_row)
    _imshow_panel(axes[3], result.blurred, "4. Gaussian Blur", "hot", center_row)
    _imshow_panel(axes[4], result.sobel_output, "5. Sobel Filter (horizontal)",
                  "RdBu", center_row, symmetric=True)
    _imshow_panel(axes[5], result.gradient_output,
                  "6. Gradient Filter (np.gradient)",
                  "RdBu", center_row, symmetric=True)
    for i in range(6):
        if [result.frame_subtracted, result.frame_diff, result.noise_removed,
                result.blurred, result.sobel_output, result.gradient_output][i] is not None:
            _position_markers(axes[i], result)

    # 7: frame-diff centerline.
    ax = axes[6]
    if result.frame_diff is not None:
        diff_line = result.frame_diff[center_row, :]
        ax.plot(x_pixels, diff_line, "r-", linewidth=1.5, label="Frame Diff")
        ax.fill_between(x_pixels, 0, diff_line, alpha=0.3, color="red")
    if result.search_bounds:
        ax.axvline(x=result.search_bounds[0], color="lime", linestyle="--",
                   linewidth=2,
                   label=f"Search: {result.search_bounds[0]}-{result.search_bounds[1]}")
        ax.axvline(x=result.search_bounds[1], color="lime", linestyle=":", linewidth=2)
    if result.pos_min_gradient is not None:
        ax.axvline(x=result.pos_min_gradient, color="purple", linestyle="-",
                   linewidth=2, label=f"Min Grad: {result.pos_min_gradient}")
    if result.pos_rightmost_sobel is not None:
        ax.axvline(x=result.pos_rightmost_sobel, color="orange", linestyle="-",
                   linewidth=2, label=f"R-Sobel: {result.pos_rightmost_sobel}")
    if result.final_position is not None:
        ax.axvline(x=result.final_position, color="red", linestyle="-",
                   linewidth=3, label=f"FINAL: {result.final_position}")
    ax.set_xlim(0, width)
    ax.set_ylabel("Intensity")
    ax.set_title("7. Frame Diff Centerline", fontsize=10)
    ax.legend(loc="upper right", fontsize=8, ncol=3)
    ax.grid(True, alpha=0.3)

    # 8: Sobel centerline; 9: gradient centerline.
    for ax, img, pos, title, line_color, marker_color, marker_label in (
        (axes[7], result.sobel_output, result.pos_rightmost_sobel,
         "8. Sobel Centerline", "b", "orange", "Rightmost Sobel"),
        (axes[8], result.gradient_output, result.pos_min_gradient,
         "9. Gradient Centerline (min = leading edge)", "purple", "purple",
         "Min Gradient"),
    ):
        if img is not None:
            ax.plot(x_pixels, img[center_row, :], color=line_color, linewidth=1)
            ax.axhline(y=0, color="gray", linestyle="-", linewidth=0.5)
        if result.search_bounds:
            ax.axvline(x=result.search_bounds[0], color="lime", linestyle="--", linewidth=2)
            ax.axvline(x=result.search_bounds[1], color="lime", linestyle=":", linewidth=2)
        if pos is not None:
            ax.axvline(x=pos, color=marker_color, linestyle="-", linewidth=2,
                       label=f"{marker_label}: {pos}")
        if result.final_position is not None:
            ax.axvline(x=result.final_position, color="red", linestyle="-",
                       linewidth=3, label=f"FINAL: {result.final_position}")
        ax.set_xlim(0, width)
        ax.set_title(title, fontsize=10)
        ax.legend(loc="upper right", fontsize=8)
        ax.grid(True, alpha=0.3)

    # 10: result overlay with candidate markers.
    ax = axes[9]
    if result.frame_subtracted is not None:
        ax.imshow(result.frame_subtracted, cmap="gray", aspect="auto")
    ax.axhline(y=center_row, color="cyan", linestyle="--", linewidth=0.5, alpha=0.5)
    if result.search_bounds:
        ax.axvline(x=result.search_bounds[0], color="lime", linestyle="--",
                   linewidth=2, alpha=0.8)
        ax.axvline(x=result.search_bounds[1], color="lime", linestyle=":",
                   linewidth=2, alpha=0.8)
    if result.pos_min_gradient is not None:
        ax.plot(result.pos_min_gradient, center_row, "p", color="purple",
                markersize=6, label=f"Min Grad: {result.pos_min_gradient}")
    if result.pos_rightmost_sobel is not None:
        ax.plot(result.pos_rightmost_sobel, center_row, "s", color="orange",
                markersize=6, label=f"R-Sobel: {result.pos_rightmost_sobel}")
    if result.pos_spline_predicted is not None:
        ax.plot(result.pos_spline_predicted, center_row, "^", color="cyan",
                markersize=6, label=f"Spline: {result.pos_spline_predicted}")
    if result.final_position is not None:
        ax.plot(result.final_position, center_row, "o", color="red", markersize=8,
                markeredgecolor="yellow", markeredgewidth=1,
                label=f"FINAL: {result.final_position}")
    ax.legend(loc="upper right", fontsize=8, ncol=2)
    title = (f"FINAL: x={result.final_position} px"
             if result.final_position else "No detection")
    ax.set_title(f"10. Result: {title}{velocity_str}", fontsize=10)
    ax.set_ylabel("Y")

    # 11: position history + spline.
    ax = axes[10]
    if detector is not None and len(detector.position_history) > 0:
        pts = [(f, p) for f, p in detector.position_history if p is not None]
        if pts:
            fh, ph = zip(*pts)
            ax.scatter(fh, ph, c="blue", s=20, alpha=0.7,
                       label="Detected positions", zorder=3)
            spline_data = detector.get_spline_curve()
            if spline_data is not None:
                ax.plot(spline_data[0], spline_data[1], "g-", linewidth=2,
                        label="Spline estimator", zorder=2)
            ax.axvline(x=result.frame_idx, color="red", linestyle="--",
                       linewidth=1.5, alpha=0.7)
            if result.final_position is not None:
                ax.scatter([result.frame_idx], [result.final_position], c="red",
                           s=60, marker="*", zorder=5,
                           label=f"Current: {result.final_position}")
            if result.pos_spline_predicted is not None:
                ax.scatter([result.frame_idx], [result.pos_spline_predicted],
                           c="cyan", s=40, marker="^", zorder=4,
                           label=f"Spline pred: {result.pos_spline_predicted}")
            ax.legend(loc="upper left", fontsize=8)
    else:
        ax.text(0.5, 0.5, "No history yet", ha="center", va="center",
                transform=ax.transAxes, fontsize=12)
    ax.set_ylabel("Position (pixels)")
    ax.set_title("11. Position History + Spline Estimator", fontsize=10)
    ax.grid(True, alpha=0.3)

    # 12: velocity comparison.
    ax = axes[11]
    vel_hist = detector.get_velocity_history() if detector is not None else []
    if vel_hist:
        frames_v = [e[0] for e in vel_hist]
        v1 = [e[1] for e in vel_hist]
        ax.plot(frames_v, v1, "b-", linewidth=1.5, alpha=0.8,
                label="1st-order backward")
        fb2 = [(e[0], e[2]) for e in vel_hist if e[2] is not None]
        if fb2:
            ax.plot(*zip(*fb2), "g--", linewidth=1.5, alpha=0.8,
                    label="2nd-order backward")
        fc = [(e[0], e[3]) for e in vel_hist if e[3] is not None]
        if fc:
            ax.plot(*zip(*fc), "r:", linewidth=2, alpha=0.8,
                    label="2nd-order central")
        ax.axhline(y=0, color="gray", linestyle="-", linewidth=0.5)
        if detector.ddt_detected:
            ax.axvline(x=detector.ddt_frame, color="magenta", linestyle="--",
                       linewidth=2, label=f"DDT @ frame {detector.ddt_frame}")
        lv = detector.last_velocity
        if lv is not None:
            ax.scatter([result.frame_idx], [lv], c="blue", s=40, marker="*", zorder=5)
        ax.legend(loc="upper left", fontsize=7)
    else:
        ax.text(0.5, 0.5, "No velocity data yet", ha="center", va="center",
                transform=ax.transAxes, fontsize=12)
    ax.set_xlabel("Frame Index")
    ax.set_ylabel("Velocity (m/s)")
    ddt_str = (f" | DDT @ {detector.ddt_frame}"
               if detector is not None and detector.ddt_detected else "")
    ax.set_title(f"12. Velocity Comparison{ddt_str}", fontsize=10)
    ax.grid(True, alpha=0.3)

    output_file = Path(output_path) / f"{source_name}-Frame-{result.frame_idx:06d}.png"
    plt.savefig(output_file, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_file


def save_frame_image_compact(
    frame_subtracted: np.ndarray,
    result: FlameDetectionResult,
    output_path: Path,
    source_name: str,
    detector=None,
) -> Path:
    """Render a 4-panel compact diagnostic (~10x faster than the full
    12-panel figure): BG-subtracted overlay with detection markers,
    frame-diff centerline, position history, velocity comparison."""
    height, width = frame_subtracted.shape[:2]
    center_row = height // 2
    fig, axes = plt.subplots(4, 1, figsize=(10, 9),
                             gridspec_kw={"height_ratios": [1, 1.6, 1.6, 1.6]})

    ax = axes[0]
    ax.imshow(frame_subtracted, cmap="gray", aspect="auto")
    ax.axhline(y=center_row, color="cyan", linestyle="--", linewidth=0.5, alpha=0.5)
    _position_markers(ax, result)
    v = detector.last_velocity if detector is not None else None
    vstr = f" | v={v:.1f} m/s" if v is not None else ""
    ax.set_title(
        f"Frame {result.frame_idx} | t={result.time_s * 1e6:.1f} µs | "
        f"x={result.final_position}{vstr}", fontsize=10,
    )
    ax.set_xticks([]); ax.set_yticks([])

    ax = axes[1]
    if result.frame_diff is not None:
        ax.plot(np.arange(width), result.frame_diff[center_row, :], "r-",
                linewidth=1)
    _position_markers(ax, result)
    ax.set_xlim(0, width)
    ax.set_title("Diff centerline", fontsize=9)
    ax.grid(True, alpha=0.3)

    ax = axes[2]
    if detector is not None:
        pts = [(f, p) for f, p in detector.position_history if p is not None]
        if pts:
            fh, ph = zip(*pts)
            ax.scatter(fh, ph, s=12, c="blue", alpha=0.7)
    if result.final_position is not None:
        ax.scatter([result.frame_idx], [result.final_position], c="red",
                   marker="*", s=50, zorder=5)
    ax.set_title("Position history (px)", fontsize=9)
    ax.grid(True, alpha=0.3)

    ax = axes[3]
    vel = detector.get_velocity_history() if detector is not None else []
    if vel:
        ax.plot([e[0] for e in vel], [e[1] for e in vel], "b-", linewidth=1.2)
        if detector.ddt_detected:
            ax.axvline(x=detector.ddt_frame, color="magenta", linestyle="--",
                       linewidth=1.5, label=f"DDT @ {detector.ddt_frame}")
            ax.legend(fontsize=8)
    ax.set_title("Velocity v1 (m/s)", fontsize=9)
    ax.set_xlabel("Frame")
    ax.grid(True, alpha=0.3)

    fig.tight_layout()
    output_file = Path(output_path) / f"{source_name}-Frame-{result.frame_idx:06d}.png"
    plt.savefig(output_file, dpi=80)
    plt.close(fig)
    return output_file


def save_frame_image_from_video(
    video,
    result: FlameDetectionResult,
    tracker,
    background_scalar: float,
    output_path: Path,
    source_name: str,
    config: Optional[FlameDetectorConfig] = None,
    style: str = "full",
) -> Path:
    """Diagnostic figure for a band-path result: recompute full-frame
    intermediates on host (the hot path never materializes them).
    ``style``: 'full' (12 panels) or 'compact' (4 panels, ~10x faster)."""
    config = config or FlameDetectorConfig()
    if result.frame_subtracted is None:
        sub = hostops.subtract_scalar_background(
            video[result.frame_idx], background_scalar
        )
        result.frame_subtracted = sub
        # The differencing prior: recorded exactly on the result (includes
        # empty frames); fall back to the previous history entry.
        prior_idx = result.prior_frame_idx
        if prior_idx is None:
            hist = tracker.position_history
            for f, _ in reversed(hist[:-1] if hist else []):
                if f < result.frame_idx:
                    prior_idx = f
                    break
        if prior_idx is not None:
            prior_sub = hostops.subtract_scalar_background(
                video[prior_idx], background_scalar
            )
            result.frame_diff = hostops.subtract_prior_frame(
                sub, prior_sub, config.frame_diff_threshold
            )
            if style != "compact":
                # Only the full 12-panel figure shows the later pipeline
                # stages; skip their full-frame recompute otherwise.
                k = config.morphology_kernel_size
                result.noise_removed = hostops.grey_opening(
                    result.frame_diff, (k, k)
                )
                result.blurred = hostops.gaussian_filter(
                    result.noise_removed, config.gaussian_sigma
                )
                result.sobel_output = hostops.sobel(result.blurred, axis=1)
                result.gradient_output = hostops.gradient_x(result.blurred)
    if style == "compact":
        return save_frame_image_compact(
            result.frame_subtracted, result, Path(output_path), source_name,
            tracker,
        )
    return save_frame_image(
        result.frame_subtracted, result, Path(output_path), source_name, tracker
    )


def generate_stacked_sequence(
    video,
    frame_indices: List[int],
    background_scalar: float,
    output_path: Path,
    title: str = "",
    show_frame_diff: bool = True,
    figsize_width: float = 10.0,
) -> Path:
    """Paper-style vertical frame stack (optionally BG-sub + frame-diff
    columns), numbered rows, black background, dpi=300."""
    n_frames = len(frame_indices)
    height, width = video.frame_shape
    n_cols = 2 if show_frame_diff else 1

    aspect = width / height
    panel_h = (figsize_width / n_cols) / aspect
    fig, axes = plt.subplots(
        n_frames, n_cols, figsize=(figsize_width, panel_h * n_frames)
    )
    axes = np.atleast_2d(axes)
    if axes.shape != (n_frames, n_cols):
        axes = axes.reshape(n_frames, n_cols)

    prior = None
    for i, frame_idx in enumerate(frame_indices):
        frame = video[frame_idx]
        sub = hostops.subtract_scalar_background(frame, background_scalar)
        diff = (
            hostops.subtract_prior_frame(frame, prior, 0.0)
            if prior is not None
            else np.zeros_like(sub)
        )
        axes[i, 0].imshow(sub, cmap="gray", aspect="equal", vmin=0)
        axes[i, 0].set_ylabel(f"{i + 1}", rotation=0, labelpad=20, fontsize=10,
                              fontweight="bold", color="white")
        axes[i, 0].set_xticks([])
        axes[i, 0].set_yticks([])
        if n_cols > 1:
            axes[i, 1].imshow(diff, cmap="gray", aspect="equal", vmin=0)
            axes[i, 1].set_xticks([])
            axes[i, 1].set_yticks([])
        prior = frame.copy()

    plt.subplots_adjust(wspace=0.02, hspace=0)
    if title:
        fig.suptitle(title, fontsize=12, fontweight="bold", color="white")
    plt.savefig(output_path, dpi=300, bbox_inches="tight",
                facecolor="black", edgecolor="none")
    plt.close(fig)
    print(f"Saved stacked sequence: {output_path}")
    return Path(output_path)


def generate_stacked_sequence_single_column(
    video,
    frame_indices: List[int],
    background_scalar: float,
    output_path: Path,
    use_frame_diff: bool = False,
    title: str = "",
    figsize_width: float = 6.0,
) -> Path:
    """Compact single-column stack: frames composited into one tall image
    with numbered separators."""
    n_frames = len(frame_indices)
    height, width = video.frame_shape
    center_row = height // 2

    stacked = np.zeros((height * n_frames, width), dtype=np.float64)
    prior = None
    for i, frame_idx in enumerate(frame_indices):
        frame = video[frame_idx]
        sub = hostops.subtract_scalar_background(frame, background_scalar)
        diff = (
            hostops.subtract_prior_frame(frame, prior, 0.0)
            if prior is not None
            else np.zeros_like(sub)
        )
        stacked[i * height : (i + 1) * height, :] = diff if use_frame_diff else sub
        prior = frame.copy()

    aspect = width / stacked.shape[0]
    fig, ax = plt.subplots(figsize=(figsize_width, figsize_width / aspect))
    ax.imshow(stacked, cmap="gray", aspect="equal", vmin=0)
    for i in range(n_frames):
        ax.text(-width * 0.02, i * height + center_row, f"{i + 1}", color="white",
                fontsize=8, fontweight="bold", ha="right", va="center")
        if i > 0:
            ax.axhline(y=i * height - 0.5, color="white", linewidth=0.5, alpha=0.5)
    ax.set_xlim(-width * 0.05, width)
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_facecolor("black")
    if title:
        ax.set_title(title, color="white", fontsize=10, fontweight="bold")
    plt.savefig(output_path, dpi=300, bbox_inches="tight",
                facecolor="black", edgecolor="none")
    plt.close(fig)
    print(f"Saved stacked sequence: {output_path}")
    return Path(output_path)


# ---------------------------------------------------------------------------
# Parallel diagnostic rendering
# ---------------------------------------------------------------------------
#
# Figure rendering dominates image-enabled runs (matplotlib, ~seconds per
# 12-panel figure — also true of the reference, SURVEY.md §3.1). Rendering is
# embarrassingly parallel across frames, so it fans out over worker
# PROCESSES: each worker opens the recording itself (memory-mapped),
# recomputes the full-frame intermediates for its frames, reconstructs the
# tracker's state *as of that frame* from the position history prefix, and
# renders. Workers never touch JAX devices (pure numpy + matplotlib).

_WORKER_VIDEOS: dict = {}
_WORKER_ENTRIES: list = []


def _render_worker_init(entries=None):
    """Initializer for SPAWNED render workers only (never the parent).

    Workers must never open an accelerator: rendering is numpy +
    matplotlib, and a JAX backend on the card would reserve most of its
    memory. Hide the cards and pin JAX to the CPU before anything in the
    worker can initialize a backend.
    """
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.environ["JAX_PLATFORMS"] = "cpu"
    _set_worker_entries(entries)


@contextlib.contextmanager
def _main_module_hidden():
    """Start spawned workers without re-running the parent's ``__main__``.

    ``spawn`` children import the parent's main script before they run
    anything else. A script without an ``if __name__ == "__main__"`` guard
    then runs again in every worker — for ``hsip --distributed`` driven
    from such a script, each worker re-joined the distributed runtime
    under its parent's rank, and the coordination service aborted the
    whole job. The workers need nothing from ``__main__`` (tasks and
    initializer live in this module), so it is swapped for a bare module
    while the pool starts its processes.
    """
    import sys
    import types

    saved = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        sys.modules["__main__"] = saved


def _set_worker_entries(entries):
    if entries is not None:
        # The full position history ships ONCE per worker; tasks carry only
        # a cutoff index (a per-task prefix copy would be O(F^2)).
        _WORKER_ENTRIES.clear()
        _WORKER_ENTRIES.extend(entries)


class _RenderHistory:
    """Tracker-state view at a single frame, rebuilt from a history prefix."""

    def __init__(self, entries, frame_rate, calibration, config):
        from .track.velocity import (
            ddt_frame_from_velocities,
            velocity_entries_from_positions,
        )

        self._entries = entries
        self._config = config
        self._vel = velocity_entries_from_positions(entries, frame_rate, calibration)
        self._ddt = ddt_frame_from_velocities(
            self._vel, config.ddt_velocity_jump_m_s
        )

    @property
    def position_history(self):
        return list(self._entries)

    @property
    def last_velocity(self):
        return self._vel[-1][1] if self._vel else None

    @property
    def ddt_frame(self):
        return self._ddt

    @property
    def ddt_detected(self):
        return self._ddt is not None

    def get_velocity_history(self):
        return [tuple(e) for e in self._vel]

    def get_spline_curve(self, frame_range=None):
        from .track.spline import fit_smoothing_spline

        valid = [(f, p) for f, p in self._entries if p is not None]
        if len(valid) < self._config.min_points_for_spline:
            return None
        fr = np.array([f for f, _ in valid], dtype=np.float64)
        po = np.array([p for _, p in valid], dtype=np.float64)
        spline = fit_smoothing_spline(
            fr, po, s=self._config.spline_smoothing * len(fr)
        )
        if spline is None:
            return None
        xs = np.linspace(fr.min(), fr.max(), 100)
        return xs, spline(xs)


def _render_one(args) -> str:
    (video_path, task, entries_upto, frame_rate, calibration,
     background_scalar, output_dir, source_name, config, style) = args
    from . import open_video
    from .track.config import FlameDetectionResult

    video = _WORKER_VIDEOS.get(video_path)
    if video is None:
        video = open_video(video_path)
        _WORKER_VIDEOS[video_path] = video

    result = FlameDetectionResult(**task)
    history = _RenderHistory(
        _WORKER_ENTRIES[:entries_upto], frame_rate, calibration, config
    )
    out = save_frame_image_from_video(
        video, result, history, background_scalar,
        Path(output_dir), source_name, config, style=style,
    )
    return str(out)


def render_diagnostics_parallel(
    video_path,
    tasks,
    entries,
    frame_rate: float,
    calibration: float,
    background_scalar: float,
    output_dir,
    source_name: str,
    config: Optional[FlameDetectorConfig] = None,
    workers: Optional[int] = None,
    style: str = "full",
) -> List[str]:
    """Render per-frame diagnostics for many frames across worker processes.

    ``tasks``: per-frame field dicts (FlameDetectionResult kwargs, images
    omitted). ``entries``: the FULL ordered position history
    [(frame, pos|None), ...]; each frame's figure sees only its prefix,
    reproducing the live tracker state. ``style``: 'full' (12-panel) or
    'compact' (4-panel, ~10x cheaper). Returns written paths in frame order.
    """
    import os
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    config = config or FlameDetectorConfig()
    if workers is None:
        workers = min(8, os.cpu_count() or 1)

    Path(output_dir).mkdir(parents=True, exist_ok=True)
    entries = list(entries)
    frame_of = {e[0]: i for i, e in enumerate(entries)}
    job_args = []
    for task in tasks:
        upto = frame_of.get(task["frame_idx"])
        upto = (upto + 1) if upto is not None else len(entries)
        job_args.append(
            (str(video_path), task, upto, frame_rate, calibration,
             background_scalar, str(output_dir), source_name, config, style)
        )

    if workers <= 1 or len(job_args) <= 1:
        # Serial fallback runs IN the caller's process: set only the entries
        # global — never the platform env/config (that would silently pin a
        # library user's whole process to CPU).
        _set_worker_entries(entries)
        try:
            return [_render_one(a) for a in job_args]
        finally:
            for v in _WORKER_VIDEOS.values():
                v.close()
            _WORKER_VIDEOS.clear()

    with ProcessPoolExecutor(
        max_workers=workers,
        mp_context=get_context("spawn"),
        initializer=_render_worker_init,
        initargs=(entries,),
    ) as pool:
        # map() submits every task at once, which starts every worker.
        with _main_module_hidden():
            results = pool.map(_render_one, job_args, chunksize=4)
        return list(results)
