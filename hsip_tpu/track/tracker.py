"""Flame-front tracking: sequential state machine + full-frame detector API.

Two layers, split at the device-design seam (SURVEY.md §7):

* :class:`FlameTracker` — the *state machine*: consumes per-frame centerline
  profiles (tiny width-length vectors, produced in parallel on device by
  :mod:`hsip_tpu.kernels.preprocess` or on host) and carries all sequential
  state: search bounds, position/velocity history, spline, DDT latch. Runs in
  float64 on host so output tables are exact.
* :class:`FlameDetector` — reference-API-compatible stateful detector
  (parity: ``scripts/process_videos.py:220-663``): ``detect(frame, frame_idx,
  background_scalar)`` performs the full-frame float64 pipeline (frame diff →
  opening → blur → Sobel + gradient) and delegates selection/state to
  :class:`FlameTracker`, returning a :class:`FlameDetectionResult` with all
  intermediates for visualization.

Tracking semantics (identical to the reference serial run):
search bounds assume monotone rightward motion from the last valid position;
candidates are (a) the most-negative-gradient location and (b) the rightmost
|Sobel| above a fraction of its max; the final position is the rightmost
candidate — the spline prediction is informational only and never overrides
detection. Velocities use three finite-difference stencils; DDT latches on a
first-order-backward velocity jump.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..kernels import reference as hostops
from .config import FlameDetectionResult, FlameDetectorConfig
from .spline import SmoothingSpline, fit_smoothing_spline

__all__ = ["FlameTracker", "FlameDetector"]


class FlameTracker:
    """Sequential tracking state machine over per-frame centerline profiles.

    The profile inputs are full-width 1-D arrays: ``sobel_line`` (horizontal
    Sobel response on the centerline) and ``gradient_line`` (central-difference
    gradient). Pass None for both on frames with no prior frame (no motion
    signal yet) — the tracker still records the frame in its history.
    """

    def __init__(
        self,
        config: FlameDetectorConfig,
        frame_rate: float,
        calibration_m_per_px: float,
        quantize_thresholds: bool = False,
    ):
        self.config = config
        self.frame_rate = frame_rate
        self.calibration = calibration_m_per_px
        #: The f32-profile scan paths set this True: config thresholds and
        #: fraction×peak products quantize to float32 so decisions are
        #: BIT-IDENTICAL to the on-device lax.scan (which computes in f32).
        #: The full-frame float64 FlameDetector keeps pure f64 thresholds —
        #: its anchor is the scipy oracle, not the device scan. Profile
        #: values are f32-exact in the scan paths, so quantization moves
        #: thresholds by <= 2^-24 relative — far below detection margins.
        self.quantize_thresholds = quantize_thresholds

        # (frame_idx, position | None), appended every step.
        self._position_history: List[Tuple[int, Optional[int]]] = []
        # [frame_idx, v_backward1, v_backward2 | None, v_central | None];
        # v_central is retro-filled one frame later.
        self._velocity_history: List[List] = []
        self._spline: Optional[SmoothingSpline] = None
        self._spline_dirty: bool = True
        self._ddt_frame_idx: Optional[int] = None

        self._max_displacement_px = self._compute_max_displacement()

    def _compute_max_displacement(self) -> int:
        """Max allowed pixel displacement per frame from the velocity cap."""
        if self.frame_rate <= 0 or self.calibration <= 0:
            return 1000  # unconstrained when parameters unknown
        dt = 1.0 / self.frame_rate
        max_displacement_m = self.config.max_velocity_change_m_s * dt
        return int(np.ceil(max_displacement_m / self.calibration)) + 1

    @property
    def max_displacement_px(self) -> int:
        return self._max_displacement_px

    def reset(self) -> None:
        """Clear all state for a new video."""
        self._position_history.clear()
        self._velocity_history.clear()
        self._spline = None
        self._spline_dirty = True
        self._ddt_frame_idx = None

    # -- search bounds ------------------------------------------------------

    def _last_valid(self) -> Tuple[Optional[int], Optional[int]]:
        for f_idx, pos in reversed(self._position_history):
            if pos is not None:
                return pos, f_idx
        return None, None

    def get_search_bounds(self, frame_idx: int, width: int) -> Tuple[int, int]:
        """Velocity-constrained [start, end) search window for this frame.

        No history → full width minus edge margins. Otherwise the window
        starts at the last position (monotone rightward motion) and extends
        by the velocity cap plus a fixed search pad, clipped to the margin.
        """
        margin = self.config.edge_margin_px
        last_position, last_frame_idx = self._last_valid()
        if last_position is None:
            return (margin, width - margin)
        frames_elapsed = frame_idx - last_frame_idx
        max_displacement = self._max_displacement_px * max(1, frames_elapsed)
        search_end = min(
            width - margin,
            last_position + max_displacement + self.config.search_window_px,
        )
        return (last_position, search_end)

    # -- spline -------------------------------------------------------------

    def _update_spline(self) -> None:
        """Refit the smoothing spline to the valid position history.

        Fitting is LAZY: the spline never participates in position selection
        (it is plot/prediction-only, reference behavior), so the fit is
        deferred until a prediction or curve is actually requested — an
        every-frame refit would make the scan O(N^2).
        """
        if not self._spline_dirty:
            return
        self._spline_dirty = False
        valid = [(f, p) for f, p in self._position_history if p is not None]
        if len(valid) < self.config.min_points_for_spline:
            self._spline = None
            return
        frames = np.array([f for f, _ in valid], dtype=np.float64)
        positions = np.array([p for _, p in valid], dtype=np.float64)
        self._spline = fit_smoothing_spline(
            frames, positions, s=self.config.spline_smoothing * len(frames)
        )

    def predict_with_spline(self, frame_idx: int) -> Optional[int]:
        """Spline-extrapolated position (informational; never drives
        final_position)."""
        self._update_spline()
        if self._spline is None:
            return None
        try:
            return max(0, int(self._spline(frame_idx)))
        except Exception:  # noqa: BLE001 — silent-fail contract
            return None

    def get_spline_curve(
        self, frame_range: Optional[Tuple[int, int]] = None
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """100-point sampled spline curve for plotting, or None."""
        self._update_spline()
        if self._spline is None:
            return None
        valid = [(f, p) for f, p in self._position_history if p is not None]
        if not valid:
            return None
        if frame_range is None:
            f_min = min(f for f, _ in valid)
            f_max = max(f for f, _ in valid)
        else:
            f_min, f_max = frame_range
        frames = np.linspace(f_min, f_max, 100)
        try:
            return frames, self._spline(frames)
        except Exception:  # noqa: BLE001
            return None

    # -- candidate selection --------------------------------------------------

    def _find_candidates(
        self,
        sobel_line: np.ndarray,
        gradient_line: np.ndarray,
        search_start: int,
        search_end: int,
    ) -> Tuple[Optional[int], Optional[int]]:
        """(pos_min_gradient, pos_rightmost_sobel) within the search window.

        Method A: location of the most negative gradient, when stronger than
        -min_gradient_strength (the leading edge is an intensity DROP).
        Method B: rightmost |Sobel| above sobel_threshold_fraction of the
        window max, when the max clears min_gradient_strength.
        """
        pos_min_gradient = None
        pos_rightmost_sobel = None

        search_sobel = sobel_line[search_start:search_end]
        search_gradient = gradient_line[search_start:search_end]
        if len(search_sobel) == 0 or len(search_gradient) == 0:
            return None, None

        min_strength = self.config.min_gradient_strength
        fraction = self.config.sobel_threshold_fraction
        if self.quantize_thresholds:
            min_strength = float(np.float32(min_strength))

        if np.min(search_gradient) < -min_strength:
            pos_min_gradient = search_start + int(np.argmin(search_gradient))

        abs_sobel = np.abs(search_sobel)
        sobel_max = np.max(abs_sobel)
        if sobel_max > min_strength:
            if self.quantize_thresholds:
                # Mirror the device's f32 product exactly (f32 inputs).
                thr = float(np.float32(np.float32(sobel_max)
                                       * np.float32(fraction)))
            else:
                thr = sobel_max * fraction
            above = np.nonzero(abs_sobel > thr)[0]
            if above.size:
                pos_rightmost_sobel = search_start + int(above[-1])

        return pos_min_gradient, pos_rightmost_sobel

    # -- the step ------------------------------------------------------------------

    def step(
        self,
        frame_idx: int,
        width: int,
        sobel_line: Optional[np.ndarray],
        gradient_line: Optional[np.ndarray],
        predict_spline: bool = True,
        intensity_line: Optional[np.ndarray] = None,
        method: str = "combined",
    ) -> FlameDetectionResult:
        """Advance the tracker by one frame given its centerline profiles.

        Returns a result carrying positions/bounds only (no images); callers
        doing full-frame detection attach intermediates themselves.
        ``predict_spline=False`` skips the (plot-only) spline prediction —
        the hot path uses this since the prediction never affects selection.

        ``method`` selects the detector: 'combined' (min-gradient +
        rightmost-Sobel, the reference tracker) or one of the named profile
        methods 'threshold' / 'gradient' / 'half_maximum', which run on
        ``intensity_line`` (the denoised frame-diff centerline).
        """
        time_s = frame_idx / self.frame_rate if self.frame_rate > 0 else 0

        search_start, search_end = self.get_search_bounds(frame_idx, width)

        pos_min_gradient = None
        pos_rightmost_sobel = None
        final_position = None
        if method == "combined":
            if sobel_line is not None and gradient_line is not None:
                pos_min_gradient, pos_rightmost_sobel = self._find_candidates(
                    sobel_line, gradient_line, search_start, search_end
                )
            # Final position: rightmost candidate (the leading edge for
            # left-to-right propagation); detection trusted over prediction.
            candidates = [
                p for p in (pos_min_gradient, pos_rightmost_sobel) if p is not None
            ]
            final_position = max(candidates) if candidates else None
        else:
            from .detectors import detect_profile

            if intensity_line is not None:
                final_position = detect_profile(
                    intensity_line,
                    method,
                    self.config,
                    bounds=(search_start, search_end),
                    quantize=self.quantize_thresholds,
                )

        pos_spline_predicted = None
        if self.config.use_spline_estimator and predict_spline:
            pos_spline_predicted = self.predict_with_spline(frame_idx)

        self._position_history.append((frame_idx, final_position))
        self._spline_dirty = True
        self._update_velocities(frame_idx, final_position)

        return FlameDetectionResult(
            frame_idx=frame_idx,
            time_s=time_s,
            pos_min_gradient=pos_min_gradient,
            pos_rightmost_sobel=pos_rightmost_sobel,
            pos_spline_predicted=pos_spline_predicted,
            search_bounds=(search_start, search_end),
            final_position=final_position,
        )

    def _update_velocities(self, frame_idx: int, final_position: Optional[int]) -> None:
        """Append velocity entry + DDT latch after a position was recorded.

        Three stencils (positions in px, calibration in m/px, dt from the
        actual frame gap):
          v_backward1 (1st-order backward):  (x_n - x_{n-1}) / dt
          v_backward2 (2nd-order backward):  (3x_n - 4x_{n-1} + x_{n-2}) / 2dt
          v_central (2nd-order central, for the PRIOR step, retro-filled):
                                             (x_n - x_{n-2}) / 2dt
        """
        if final_position is None or len(self._position_history) < 2:
            return
        curr_frame, curr_pos = self._position_history[-1]
        prev_frame, prev_pos = self._position_history[-2]
        if prev_pos is None or self.frame_rate <= 0:
            return
        dt = (curr_frame - prev_frame) / self.frame_rate
        if dt <= 0:
            return

        v_backward1 = (curr_pos - prev_pos) * self.calibration / dt

        v_backward2 = None
        v_central = None
        if len(self._position_history) >= 3:
            _, prev2_pos = self._position_history[-3]
            if prev2_pos is not None:
                v_backward2 = (
                    (3 * curr_pos - 4 * prev_pos + prev2_pos) * self.calibration / (2 * dt)
                )
                v_central = (curr_pos - prev2_pos) * self.calibration / (2 * dt)
                if self._velocity_history:
                    # Central difference evaluates at the PRIOR time step.
                    self._velocity_history[-1][3] = v_central

        self._velocity_history.append([frame_idx, v_backward1, v_backward2, None])

        if self._ddt_frame_idx is None and len(self._velocity_history) >= 2:
            prev_vel = self._velocity_history[-2][1]
            if v_backward1 - prev_vel > self.config.ddt_velocity_jump_m_s:
                self._ddt_frame_idx = frame_idx

    # -- inspection ---------------------------------------------------------------------

    @property
    def position_history(self) -> List[Tuple[int, Optional[int]]]:
        return self._position_history

    @property
    def last_position(self) -> Optional[int]:
        pos, _ = self._last_valid()
        return pos

    @property
    def last_velocity(self) -> Optional[float]:
        """Most recent first-order-backward velocity (m/s)."""
        if self._velocity_history:
            return self._velocity_history[-1][1]
        return None

    @property
    def last_velocities(self) -> Tuple[Optional[float], Optional[float], Optional[float]]:
        """(v_backward1, v_backward2, v_central) of the latest entry."""
        if self._velocity_history:
            e = self._velocity_history[-1]
            return (e[1], e[2], e[3])
        return (None, None, None)

    @property
    def ddt_frame(self) -> Optional[int]:
        return self._ddt_frame_idx

    @property
    def ddt_detected(self) -> bool:
        return self._ddt_frame_idx is not None

    def get_velocity_history(self) -> List[Tuple]:
        """Full velocity history as (frame, v1, v2, vc) tuples."""
        return [tuple(e) for e in self._velocity_history]

    def last_two_v1(self) -> Tuple[Optional[float], Optional[float]]:
        """(second-latest v1, latest v1) in O(1) — the velocity-drop check
        reads this every frame; copying the whole history would make the
        scan O(N^2)."""
        if len(self._velocity_history) >= 2:
            return self._velocity_history[-2][1], self._velocity_history[-1][1]
        if self._velocity_history:
            return None, self._velocity_history[-1][1]
        return None, None

    def get_pre_ddt_velocities(self) -> List[Tuple]:
        if self._ddt_frame_idx is None:
            return self.get_velocity_history()
        return [tuple(e) for e in self._velocity_history if e[0] < self._ddt_frame_idx]

    def get_post_ddt_velocities(self) -> List[Tuple]:
        if self._ddt_frame_idx is None:
            return []
        return [tuple(e) for e in self._velocity_history if e[0] >= self._ddt_frame_idx]

    def clear_last_central_difference(self) -> None:
        """Invalidate the central difference of the second-to-last entry.

        Called when the flame exits the domain: v_central at frame n-1 was
        computed from the (invalid, at-edge) position at frame n.
        """
        if len(self._velocity_history) >= 2:
            self._velocity_history[-2][3] = None

    def validate_position(
        self, candidate_position: int, frame_idx: int
    ) -> Optional[int]:
        """Constrain a candidate against the tracking model (optional API).

        Returns None when the candidate moves backwards (the flame only
        propagates rightward), clamps displacements beyond the velocity cap,
        and passes everything else through. The default pipeline trusts
        detection and never calls this (reference behavior — its analogue was
        dead code at ``process_videos.py:538-568``); it is exposed for
        callers that want conservative tracking.
        """
        last_position, last_frame_idx = self._last_valid()
        if last_position is None:
            return candidate_position
        if candidate_position < last_position:
            return None
        frames_elapsed = frame_idx - last_frame_idx
        if frames_elapsed > 0:
            max_displacement = self._max_displacement_px * frames_elapsed
            if candidate_position - last_position > max_displacement:
                return last_position + max_displacement
        return candidate_position


class FlameDetector:
    """Stateful full-frame flame detector (reference-compatible API).

    Pipeline per frame (all float64 host ops, scipy-parity):
      1. scalar background subtraction (clamped at 0)
      2. frame differencing against the prior BG-subtracted frame, thresholded
      3. grey opening (isolated-pixel removal)
      4. Gaussian blur
      5. horizontal Sobel + central-difference gradient
      6. centerline candidate selection within velocity-constrained bounds

    The device pipeline (:mod:`hsip_tpu.track.scan`) produces identical results
    by computing steps 1-5 batched on device and feeding the profiles to the
    same :class:`FlameTracker`.
    """

    def __init__(
        self,
        config: FlameDetectorConfig,
        frame_rate: float,
        calibration_m_per_px: float,
        keep_results: bool = True,
        detection_method: str = "combined",
        use_frame_diff: bool = True,
    ):
        self.config = config
        self.frame_rate = frame_rate
        self.calibration = calibration_m_per_px
        self.detection_method = detection_method
        self.use_frame_diff = use_frame_diff
        self.tracker = FlameTracker(config, frame_rate, calibration_m_per_px)
        self._prior_frame: Optional[np.ndarray] = None
        self._prior_frame_idx: Optional[int] = None
        self._keep_results = keep_results
        self._detection_results: List[FlameDetectionResult] = []

    def reset(self) -> None:
        """Reset all tracking state for a new video."""
        self.tracker.reset()
        self._prior_frame = None
        self._prior_frame_idx = None
        self._detection_results.clear()

    def update_prior_frame(
        self, frame_subtracted: np.ndarray, frame_idx: Optional[int] = None
    ) -> None:
        """Advance the frame-differencing chain without detecting (used for
        empty/noise-only frames, which still shift the motion baseline)."""
        self._prior_frame = np.array(frame_subtracted, dtype=np.float64)
        self._prior_frame_idx = frame_idx

    def detect(
        self,
        frame: np.ndarray,
        frame_idx: int,
        background_scalar: float,
    ) -> FlameDetectionResult:
        """Run the full detection pipeline on one raw frame."""
        height, width = frame.shape[:2]
        center_row = height // 2

        frame_subtracted = hostops.subtract_scalar_background(frame, background_scalar)

        frame_diff = None
        noise_removed = None
        blurred = None
        sobel_output = None
        gradient_output = None
        sobel_line = None
        gradient_line = None
        intensity_line = None

        # Named profile methods never read the Sobel/gradient images; skip
        # those full-frame float64 passes unless they feed the combined
        # tracker or the caller keeps intermediates for visualization.
        need_edges = self.detection_method == "combined" or self._keep_results
        need_diff = self.use_frame_diff or need_edges
        if self._prior_frame is not None and need_diff:
            frame_diff = hostops.subtract_prior_frame(
                frame_subtracted, self._prior_frame, self.config.frame_diff_threshold
            )
            k = self.config.morphology_kernel_size
            noise_removed = hostops.grey_opening(frame_diff, (k, k))
            blurred = hostops.gaussian_filter(noise_removed, self.config.gaussian_sigma)
            if need_edges:
                sobel_output = hostops.sobel(blurred, axis=1)
                gradient_output = hostops.gradient_x(blurred)
                sobel_line = sobel_output[center_row, :]
                gradient_line = gradient_output[center_row, :]
            intensity_line = blurred[center_row, :]
        if not self.use_frame_diff:
            # Named methods read the raw BG-subtracted centerline instead of
            # the motion-isolated one (Mini-style strong static signal).
            intensity_line = frame_subtracted[center_row, :]

        result = self.tracker.step(
            frame_idx,
            width,
            sobel_line,
            gradient_line,
            intensity_line=intensity_line,
            method=self.detection_method,
        )

        result.prior_frame_idx = self._prior_frame_idx
        self._prior_frame = frame_subtracted.copy()
        self._prior_frame_idx = frame_idx

        result.frame_subtracted = frame_subtracted
        result.frame_diff = frame_diff
        result.noise_removed = noise_removed
        result.blurred = blurred
        result.sobel_output = sobel_output
        result.gradient_output = gradient_output
        if self._keep_results:
            self._detection_results.append(result)
        return result

    # -- delegated inspection API ------------------------------------------------

    @property
    def detection_results(self) -> List[FlameDetectionResult]:
        return self._detection_results

    @property
    def position_history(self):
        return self.tracker.position_history

    @property
    def last_position(self):
        return self.tracker.last_position

    @property
    def last_velocity(self):
        return self.tracker.last_velocity

    @property
    def last_velocities(self):
        return self.tracker.last_velocities

    @property
    def ddt_frame(self):
        return self.tracker.ddt_frame

    @property
    def ddt_detected(self):
        return self.tracker.ddt_detected

    def get_search_bounds(self, frame_idx: int, width: int):
        return self.tracker.get_search_bounds(frame_idx, width)

    def predict_with_spline(self, frame_idx: int):
        return self.tracker.predict_with_spline(frame_idx)

    def get_spline_curve(self, frame_range=None):
        return self.tracker.get_spline_curve(frame_range)

    def get_velocity_history(self):
        return self.tracker.get_velocity_history()

    def get_pre_ddt_velocities(self):
        return self.tracker.get_pre_ddt_velocities()

    def get_post_ddt_velocities(self):
        return self.tracker.get_post_ddt_velocities()

    def clear_last_central_difference(self):
        return self.tracker.clear_last_central_difference()
