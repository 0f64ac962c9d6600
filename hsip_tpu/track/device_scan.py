"""On-device tracking scan: the full state machine as a ``jax.lax.scan``.

The north-star scale path (BASELINE.json): flame-exit detection and result
truncation WITHOUT host round-trips. The sequential tracker — search bounds,
candidate selection, velocity stencils, DDT latch, domain-exit and
velocity-drop truncation — runs as a ``lax.scan`` over the per-frame
centerline profiles, entirely on device, and is ``vmap``-able over a video
axis: a whole library of videos tracks in one dispatch (see
:func:`hsip_tpu.track.batch.track_collection_device`).

Division of labor with the host scan (:mod:`hsip_tpu.track.scan`):

* positions, candidate choices, truncation and DDT come from the device in
  int32/f32 (integer positions are exact; the float compares have huge
  margins relative to f32 eps);
* the velocity COLUMNS of the output table are recomputed on host in float64
  from the integer positions (:func:`velocities_from_positions`) so tables
  stay bit-identical to the serial reference — velocities are tiny
  per-row arithmetic, not a bandwidth concern.

The spline predictor is absent by design: it never influences selection
(reference behavior) and exists for plots only.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .velocity import (  # noqa: F401 — re-exported for back-compat
    ddt_frame_from_velocities,
    velocities_from_positions,
    velocity_entries_from_positions,
)

__all__ = [
    "device_tracking_scan",
    "velocities_from_positions",
    "velocity_entries_from_positions",
    "ddt_frame_from_velocities",
    "DeviceScanResult",
]

_NEG = jnp.float32(-3.0e38)
_POS = jnp.float32(3.0e38)


def _detect_window_threshold(profile, in_window, cols, fraction, min_intensity):
    """Device 'threshold' detector: rightmost edge of the contiguous
    above-threshold region containing the window peak."""
    masked = jnp.where(in_window, profile, _NEG)
    peak = jnp.max(masked)
    peak_idx = jnp.argmax(masked).astype(jnp.int32)
    thr = fraction * peak
    below = jnp.logical_not(in_window & (profile >= thr))
    # First below-threshold column at or right of the peak.
    first_below = jnp.min(
        jnp.where((cols >= peak_idx) & below, cols, jnp.int32(2**30))
    ).astype(jnp.int32)
    window_end = jnp.max(jnp.where(in_window, cols, -1)).astype(jnp.int32)
    edge = jnp.where(first_below > window_end, window_end, first_below - 1)
    ok = (peak > min_intensity) & (edge >= peak_idx)
    return jnp.where(ok, edge, -1)


def _detect_window_half_maximum(profile, in_window, cols, fraction, min_intensity):
    """Device 'half_maximum' detector: last column at/above fraction×peak
    before the first falling-edge crossing right of the peak."""
    masked = jnp.where(in_window, profile, _NEG)
    peak = jnp.max(masked)
    peak_idx = jnp.argmax(masked).astype(jnp.int32)
    level = fraction * peak
    below = in_window & (cols >= peak_idx) & (profile < level)
    first_below = jnp.min(
        jnp.where(below, cols, jnp.int32(2**30))
    ).astype(jnp.int32)
    window_end = jnp.max(jnp.where(in_window, cols, -1)).astype(jnp.int32)
    edge = jnp.where(first_below > window_end, window_end, first_below - 1)
    # edge >= peak_idx rejects the no-crossing case (the peak itself below
    # the level, fraction > 1) — the host returns None there; peak_idx-1
    # would be a position LEFT of the window (and -1 at column 0 would
    # collide with the no-detection sentinel).
    ok = (peak > min_intensity) & (edge >= peak_idx)
    return jnp.where(ok, edge, -1)


def _two_sum(a, b):
    """Knuth TwoSum: (s, e) with s + e == a + b EXACTLY (s = fl(a+b))."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _detect_window_gradient(profile, in_window, cols, s0, s1, min_strength):
    """Device 'gradient' detector: steepest drop of the WINDOWED profile
    (one-sided differences at the window edges, matching np.gradient of the
    sliced window in the host detector).

    The host computes the finite differences in float64 of float32 profile
    values — EXACT arithmetic — so a plain f32 subtraction here can round
    differently and flip argmin at f64 ties (confirmed on locally-linear
    blurred profiles). The differences are therefore carried as exact
    double-float (hi, lo) pairs via TwoSum, and the argmin/threshold compares
    are lexicographic over (hi, lo) — bit-equivalent to the host's float64.
    """
    w = profile.shape[0]
    left = jnp.concatenate([profile[:1], profile[:-1]])
    right = jnp.concatenate([profile[1:], profile[-1:]])
    c_hi, c_lo = _two_sum(right, -left)
    c_hi, c_lo = c_hi * 0.5, c_lo * 0.5  # *0.5 is exact
    # One-sided at the window boundary columns.
    p_s0 = profile[jnp.clip(s0, 0, w - 1)]
    p_s0n = profile[jnp.clip(s0 + 1, 0, w - 1)]
    p_e = profile[jnp.clip(s1 - 1, 0, w - 1)]
    p_ep = profile[jnp.clip(s1 - 2, 0, w - 1)]
    l_hi, l_lo = _two_sum(p_s0n, -p_s0)
    r_hi, r_lo = _two_sum(p_e, -p_ep)
    g_hi = jnp.where(cols == s0, l_hi, c_hi)
    g_lo = jnp.where(cols == s0, l_lo, c_lo)
    g_hi = jnp.where(cols == s1 - 1, r_hi, g_hi)
    g_lo = jnp.where(cols == s1 - 1, r_lo, g_lo)
    g_hi = jnp.where(in_window, g_hi, _POS)
    g_lo = jnp.where(in_window, g_lo, _POS)

    # Lexicographic argmin over (hi, lo): the true f64 minimum location.
    m_hi = jnp.min(g_hi)
    tie = g_hi == m_hi
    m_lo = jnp.min(jnp.where(tie, g_lo, _POS))
    winners = tie & (g_lo == m_lo)
    pos = jnp.argmax(winners).astype(jnp.int32)  # first index among winners

    # f64 value (hi + lo) < T, with |lo| <= ulp(hi)/2 and T exactly f32:
    def _lt(threshold):
        return (m_hi < threshold) | ((m_hi == threshold) & (m_lo < 0))

    # Window must have >= 2 columns for a gradient (host returns None below).
    ok = _lt(-min_strength) & _lt(jnp.float32(0.0)) & (s1 - s0 >= 2)
    return jnp.where(ok, pos, -1)


class DeviceScanResult(NamedTuple):
    """Per-frame outputs of the device scan (arrays of length M).

    Only ``final_position`` feeds the results tables: truncation, DDT and
    row labels are recomputed in float64 from the integer positions on
    host (``build_device_scan_output``). Everything below the positions is
    an ADVISORY f32 latch kept for kernel-vs-kernel bit-identity tests —
    an f32 v1 can sit on the other side of the reference's strict
    ``prev_v1 > 100`` gate than the float64 value, so reconstructing
    tables from these fields reintroduces exactly that boundary bug.
    """

    final_position: jnp.ndarray   # int32, -1 = no detection
    recorded: jnp.ndarray         # bool — advisory (f32 stop gate)
    is_post_ddt: jnp.ndarray      # bool — advisory (f32 DDT latch)
    search_start: jnp.ndarray     # int32
    search_end: jnp.ndarray       # int32
    stop_step: jnp.ndarray        # int32 scalar, -1 = none latched; advisory
    stop_reason: jnp.ndarray      # int32 scalar: 0/1 exit/2 vdrop; advisory
    ddt_frame: jnp.ndarray        # int32 scalar, -1 = none; advisory
    clear_vc_entry: jnp.ndarray   # int32 scalar: velocity-entry ordinal at
                                  # the first advisory stop (-1 none)


@partial(
    jax.jit,
    static_argnames=(
        "width",
        "edge_margin_px",
        "search_window_px",
        "exit_margin_px",
        "method",
        "unroll",
    ),
)
def device_tracking_scan(
    frame_indices: jnp.ndarray,     # (M,) int32
    sobel_lines: jnp.ndarray,       # (M, W) f32
    gradient_lines: jnp.ndarray,    # (M, W) f32
    empty: jnp.ndarray,             # (M,) bool — empty-frame skip
    has_prior: jnp.ndarray,         # (M,) bool — gates detection (False only
                                    # for the first frame with diff profiles;
                                    # pass all-True for raw-profile methods)
    width: int,
    min_gradient_strength: jnp.ndarray,
    sobel_threshold_fraction: jnp.ndarray,
    ddt_velocity_jump: jnp.ndarray,
    calibration: jnp.ndarray,       # m/px, f32
    frame_rate: jnp.ndarray,        # fps, f32
    max_displacement_px: jnp.ndarray = 3,  # traced (per-video under vmap)
    edge_margin_px: int = 10,
    search_window_px: int = 100,
    exit_margin_px: int = 15,
    method: str = "combined",
    intensity_lines: jnp.ndarray = None,   # (M, W) f32 — named methods only
    method_fraction: jnp.ndarray = 0.5,    # threshold/half_maximum fraction
    unroll: int = 1,
) -> DeviceScanResult:
    """Run the tracking state machine on device.

    ``method`` (static) selects the detector: 'combined' (min-gradient +
    rightmost-Sobel over sobel/gradient lines, the reference tracker) or a
    named profile method ('threshold' | 'half_maximum' | 'gradient') over
    ``intensity_lines``. Semantics mirror
    :class:`hsip_tpu.track.tracker.FlameTracker` + the pipeline truncation
    checks (reference loop ``process_videos.py:1441-1527``), in float32.
    ``unroll`` (static) is ``lax.scan``'s unroll factor; it changes the
    compiled loop, never the outputs.
    """
    m, w = sobel_lines.shape
    cols = jax.lax.broadcasted_iota(jnp.int32, (w,), 0)
    if method != "combined" and intensity_lines is None:
        raise ValueError(f"method {method!r} requires intensity_lines")
    if intensity_lines is None:
        intensity_lines = jnp.zeros_like(sobel_lines)

    class S(NamedTuple):
        lv_pos: jnp.ndarray       # last VALID position (search bounds), -1
        lv_frame: jnp.ndarray
        p1_frame: jnp.ndarray     # history[-1] (every step appends)
        p1_pos: jnp.ndarray       # -1 = None
        p2_frame: jnp.ndarray     # history[-2]
        p2_pos: jnp.ndarray
        v_latest: jnp.ndarray     # last appended v1 (f32)
        v_latest_ok: jnp.ndarray  # bool
        v_prev: jnp.ndarray       # second-last appended v1
        v_prev_ok: jnp.ndarray
        n_entries: jnp.ndarray    # appended velocity entries so far
        last_entry_step: jnp.ndarray   # step idx of entry[-1], -1
        prev_entry_step: jnp.ndarray   # step idx of entry[-2], -1
        ddt_frame: jnp.ndarray    # -1
        stopped: jnp.ndarray      # bool
        stop_step: jnp.ndarray
        stop_reason: jnp.ndarray
        clear_vc_entry: jnp.ndarray

    init = S(
        lv_pos=jnp.int32(-1), lv_frame=jnp.int32(0),
        p1_frame=jnp.int32(0), p1_pos=jnp.int32(-1),
        p2_frame=jnp.int32(0), p2_pos=jnp.int32(-1),
        v_latest=jnp.float32(0), v_latest_ok=jnp.bool_(False),
        v_prev=jnp.float32(0), v_prev_ok=jnp.bool_(False),
        n_entries=jnp.int32(0),
        last_entry_step=jnp.int32(-1), prev_entry_step=jnp.int32(-1),
        ddt_frame=jnp.int32(-1),
        stopped=jnp.bool_(False), stop_step=jnp.int32(-1),
        stop_reason=jnp.int32(0), clear_vc_entry=jnp.int32(-1),
    )

    def step(state: S, inputs):
        step_idx, frame, sob, grad, intens, is_empty, prior_ok = inputs
        # Tracking continues past the f32 stop decision: the authoritative
        # exit/velocity-drop truncation is recomputed on host in float64
        # from the emitted integer positions (build_device_scan_output), and
        # the two can disagree at exact compare boundaries (e.g. a v1 that
        # is 100.0 in f64 but 100.00001 in f32 flips the strict `> 100`
        # velocity-drop gate). The in-scan stop/DDT latches below are
        # advisory only; freezing the scan on them would lose the rows the
        # f64 decision still needs.
        active = jnp.logical_not(is_empty)

        # ---- search bounds (velocity-constrained, monotone rightward) ----
        no_hist = state.lv_pos < 0
        frames_elapsed = jnp.maximum(1, frame - state.lv_frame)
        s0 = jnp.where(no_hist, edge_margin_px, state.lv_pos)
        s1 = jnp.where(
            no_hist,
            width - edge_margin_px,
            jnp.minimum(
                width - edge_margin_px,
                state.lv_pos + max_displacement_px * frames_elapsed
                + search_window_px,
            ),
        )
        in_window = (cols >= s0) & (cols < s1)
        window_nonempty = s1 > s0

        # ---- candidates (method chosen statically at trace time) ----
        if method == "combined":
            grad_m = jnp.where(in_window, grad, _POS)
            gmin = jnp.min(grad_m)
            pos_g = jnp.argmin(grad_m).astype(jnp.int32)
            g_ok = window_nonempty & (gmin < -min_gradient_strength)

            abs_sob = jnp.where(in_window, jnp.abs(sob), _NEG)
            smax = jnp.max(abs_sob)
            above = in_window & (abs_sob > smax * sobel_threshold_fraction)
            pos_s = jnp.max(jnp.where(above, cols, -1)).astype(jnp.int32)
            s_ok = window_nonempty & (smax > min_gradient_strength) & (pos_s >= 0)

            final = jnp.maximum(
                jnp.where(g_ok, pos_g, -1), jnp.where(s_ok, pos_s, -1)
            )
        elif method == "threshold":
            final = _detect_window_threshold(
                intens, in_window, cols, method_fraction, min_gradient_strength
            )
        elif method == "half_maximum":
            final = _detect_window_half_maximum(
                intens, in_window, cols, method_fraction, min_gradient_strength
            )
        elif method == "gradient":
            final = _detect_window_gradient(
                intens, in_window, cols, s0, s1, min_gradient_strength
            )
        else:
            raise ValueError(f"Unknown detection method: {method!r}")
        final = jnp.where(window_nonempty, final, -1)
        final = jnp.where(active & prior_ok, final, -1)
        detected = active & (final >= 0)

        # ---- history append (every active step) ----
        new_p2_frame = jnp.where(active, state.p1_frame, state.p2_frame)
        new_p2_pos = jnp.where(active, state.p1_pos, state.p2_pos)
        new_p1_frame = jnp.where(active, frame, state.p1_frame)
        new_p1_pos = jnp.where(active, final, state.p1_pos)
        new_lv_pos = jnp.where(detected, final, state.lv_pos)
        new_lv_frame = jnp.where(detected, frame, state.lv_frame)

        # ---- velocities ----
        # Conditions mirror FlameTracker._update_velocities: need a detection,
        # a previous history entry with a valid position, positive dt.
        have_prev_entry = active & (state.p1_pos >= 0) & detected
        dt = (frame - state.p1_frame).astype(jnp.float32) / frame_rate
        # frame_rate > 0 mirrors the host reconstruction, which records no
        # velocity entries at all for frame_rate <= 0 (a missing 'Record
        # Rate(fps)' header defaults it to 0); without the gate dt = gap/0
        # = +inf passes dt > 0 and the entry counts drift between backends.
        vel_ok = have_prev_entry & (dt > 0) & (frame_rate > 0)
        v1 = jnp.where(
            vel_ok,
            (final - state.p1_pos).astype(jnp.float32) * calibration / dt,
            0.0,
        )
        # (v_central is reconstructed on host from positions, so the scan
        # carries no central-difference state.)
        new_v_prev = jnp.where(vel_ok, state.v_latest, state.v_prev)
        new_v_prev_ok = jnp.where(vel_ok, state.v_latest_ok, state.v_prev_ok)
        new_v_latest = jnp.where(vel_ok, v1, state.v_latest)
        new_v_latest_ok = vel_ok | state.v_latest_ok
        new_n_entries = state.n_entries + jnp.where(vel_ok, 1, 0)
        new_prev_entry_step = jnp.where(
            vel_ok, state.last_entry_step, state.prev_entry_step
        )
        new_last_entry_step = jnp.where(vel_ok, step_idx, state.last_entry_step)

        # ---- DDT latch (first v1 jump above threshold) ----
        ddt_hit = (
            vel_ok
            & (state.ddt_frame < 0)
            & state.v_latest_ok
            & (v1 - state.v_latest > ddt_velocity_jump)
        )
        new_ddt = jnp.where(ddt_hit, frame, state.ddt_frame)

        # ---- exit check (before recording) ----
        exit_hit = detected & (final >= width - exit_margin_px)
        # ---- velocity-drop check ----
        vel_now = new_v_latest
        vel_now_ok = new_v_latest_ok & (new_n_entries >= 1)
        prev_v1 = new_v_prev
        prev_ok = new_v_prev_ok & (new_n_entries >= 2)
        vdrop_hit = (
            active
            & jnp.logical_not(exit_hit)
            & vel_now_ok
            & prev_ok
            & (prev_v1 > 100.0)
            & ((prev_v1 - vel_now) / prev_v1 > 0.5)
        )

        stopped_now = exit_hit | vdrop_hit
        first_stop = stopped_now & jnp.logical_not(state.stopped)
        # clear_last_central_difference targets velocity entry[-2] (ordinal);
        # latch at the FIRST stop only (the scan keeps running afterwards).
        clear_entry = jnp.where(
            first_stop & (new_n_entries >= 2),
            new_n_entries - 2,
            state.clear_vc_entry,
        )

        recorded = detected & jnp.logical_not(stopped_now)
        is_post = (new_ddt >= 0) & (frame >= new_ddt)

        new_state = S(
            lv_pos=new_lv_pos, lv_frame=new_lv_frame,
            p1_frame=new_p1_frame, p1_pos=new_p1_pos,
            p2_frame=new_p2_frame, p2_pos=new_p2_pos,
            v_latest=new_v_latest, v_latest_ok=new_v_latest_ok,
            v_prev=new_v_prev, v_prev_ok=new_v_prev_ok,
            n_entries=new_n_entries,
            last_entry_step=new_last_entry_step,
            prev_entry_step=new_prev_entry_step,
            ddt_frame=new_ddt,
            stopped=state.stopped | stopped_now,
            stop_step=jnp.where(first_stop, step_idx, state.stop_step),
            stop_reason=jnp.where(
                first_stop, jnp.where(exit_hit, 1, 2), state.stop_reason
            ),
            clear_vc_entry=clear_entry,
        )
        outputs = (final, recorded, is_post, s0, s1)
        return new_state, outputs

    steps = jnp.arange(m, dtype=jnp.int32)
    final_state, (finals, recs, posts, s0s, s1s) = jax.lax.scan(
        step,
        init,
        (steps, frame_indices.astype(jnp.int32), sobel_lines, gradient_lines,
         intensity_lines, empty, has_prior),
        unroll=unroll,
    )
    return DeviceScanResult(
        final_position=finals,
        recorded=recs,
        is_post_ddt=posts,
        search_start=s0s,
        search_end=s1s,
        stop_step=final_state.stop_step,
        stop_reason=final_state.stop_reason,
        ddt_frame=final_state.ddt_frame,
        clear_vc_entry=final_state.clear_vc_entry,
    )


