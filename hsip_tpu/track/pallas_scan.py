"""Pallas (Triton) kernel for the tracking state machine.

Under XLA the ``lax.scan`` tracker (:mod:`hsip_tpu.track.device_scan`)
becomes a device while loop: every frame pays kernel launches and a
loop-condition round trip, so a 2048-frame recording costs 2048 steps of
launch latency rather than of work. This module runs the same state
machine as ONE kernel launch, written for the GPU's block model:

* grid ``(V,)`` — one program per video; videos are independent, so they
  run concurrently on separate SMs;
* the frame loop runs inside the program (``lax.fori_loop``) and the
  tracker state is a tuple of loop scalars held in registers;
* each frame's profile row is loaded as one power-of-two block
  (``block_w``) with a mask for the logical ``width``; columns past the
  width sit outside every search window, so the masked reductions never
  see them;
* the next frame's rows and per-frame scalars are loaded one iteration
  ahead (they depend only on the frame index, never on the state), so the
  load latency overlaps the current frame's reductions;
* the ``gradient`` detector reads its neighbour columns by offset
  (index loads clamped into ``[0, width)``) and its one-sided window-edge
  differences as scalar loads.

Bit-parity contract: every float32 compare and reduction mirrors
``device_tracking_scan``'s step function (min/max reductions are exact;
``argmin``/``argmax`` take the first occurrence on both sides, and the
``gradient`` detector keeps its TwoSum double-float carry and
lexicographic ``(hi, lo)`` tie ordering). Triton's ``/`` on float32 is the
approximate ``div.full.f32``; the velocity and velocity-drop divisions use
``div.rn.f32`` instead, so they round like XLA's. Outputs are REQUIRED to
be bit-identical to the lax.scan backend for all four detectors — tested
in interpret mode on the CPU and compiled on the GPU by ``chip_smoke.py``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .device_scan import DeviceScanResult, _two_sum

__all__ = [
    "INTERPRET",
    "kernel_enabled",
    "pallas_tracking_scan",
    "pallas_tracking_scan_batched",
]

# Set by tests to run the kernel in Pallas interpret mode on the CPU; the
# pipeline otherwise takes the kernel only on a GPU backend.
INTERPRET = False

# Warps per program, chosen by measurement on an H100 (2048 frames,
# W=1024, V=1/8/16, combined and gradient): 4 warps were fastest or tied
# everywhere (1.30-1.45 us/step); 1 warp lost up to 1.7x at V>=8.
NUM_WARPS = 4

# numpy scalars (not jnp): jnp constants would be captured as traced
# closure consts, which pallas_call rejects.
_NEG = np.float32(-3.0e38)
_POS = np.float32(3.0e38)
_BIG_I = np.int32(2**30)
# jnp.where's branches are typed int32 scalars: the Triton lowering of
# select_n gives a weakly typed Python literal the predicate's type (i1).
_NONE = np.int32(-1)
_ONE = np.int32(1)

# Per-frame flag bits (one int32 load per frame instead of two).
_EMPTY, _PRIOR = 1, 2

_METHODS = ("combined", "threshold", "half_maximum", "gradient")


def kernel_enabled() -> bool:
    """True when the pipeline should run this kernel: on a GPU backend,
    or anywhere once a test has set :data:`INTERPRET`."""
    from ..utils.backend import is_gpu_backend

    return INTERPRET or is_gpu_backend()


def _block_width(width: int) -> int:
    return 1 << max(0, (width - 1).bit_length())


def _div_rn(a, b):
    """IEEE round-to-nearest float32 division (XLA's rounding); Triton's
    own ``/`` is the approximate ``div.full.f32``. The inline-asm op takes
    blocks, not scalars, so the scalars go through shape (1,)."""
    (q,) = plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;",
        args=[jnp.broadcast_to(a, (1,)), jnp.broadcast_to(b, (1,))],
        constraints="=r,r,r",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct((1,), jnp.float32)],
    )
    return jnp.max(q)


def _make_kernel(*, m, width, block_w, edge_margin_px, search_window_px,
                 exit_margin_px, method, interpret):
    n_prof = 2 if method == "combined" else 1
    w = width
    margin = np.int32(edge_margin_px)
    w_in = np.int32(width - edge_margin_px)

    def div(a, b):
        # Interpret mode runs on the CPU, where '/' already rounds to nearest.
        return a / b if interpret else _div_rn(a, b)

    def kernel(params_ref, fidx_ref, flags_ref, cal_ref, fr_ref, md_ref,
               *refs):
        prof_refs = refs[:n_prof]
        (out_final, out_rec, out_post, out_s0, out_s1,
         out_latch) = refs[n_prof:]
        v = pl.program_id(0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (block_w,), 0)
        col_ok = cols < w
        min_grad = params_ref[0]
        sobel_frac = params_ref[1]
        ddt_jump = params_ref[2]
        method_frac = params_ref[3]
        calibration = cal_ref[v]
        frame_rate = fr_ref[v]
        max_disp = md_ref[v]

        def fetch(j):
            """Frame j's inputs; independent of the tracker state."""
            rows = tuple(
                plgpu.load(r.at[v, j, pl.ds(0, block_w)], mask=col_ok,
                           other=0.0)
                for r in prof_refs
            )
            if method == "gradient":
                # Neighbour columns by offset, clamped into the row (the
                # clamped edge values are never read: columns 0 and w-1
                # only enter a window as its one-sided boundary columns).
                p = prof_refs[0]
                rows += (p[v, j, jnp.clip(cols - 1, 0, w - 1)],
                         p[v, j, jnp.clip(cols + 1, 0, w - 1)])
            return rows, fidx_ref[v, j], flags_ref[v, j]

        def detect(j, rows, s0, s1, in_window):
            if method == "combined":
                sob, grad = rows
                grad_m = jnp.where(in_window, grad, _POS)
                gmin = jnp.min(grad_m)
                pos_g = jnp.argmin(grad_m).astype(jnp.int32)
                g_ok = gmin < -min_grad
                abs_sob = jnp.where(in_window, jnp.abs(sob), _NEG)
                smax = jnp.max(abs_sob)
                above = in_window & (abs_sob > smax * sobel_frac)
                pos_s = jnp.max(jnp.where(above, cols, _NONE))
                s_ok = (smax > min_grad) & (pos_s >= 0)
                return jnp.maximum(jnp.where(g_ok, pos_g, _NONE),
                                   jnp.where(s_ok, pos_s, _NONE))
            # Largest window column: the window is [s0, s1) clipped to the
            # row (integer arithmetic, equal to the reference's max-reduce).
            hi = jnp.minimum(s1, w)
            window_end = jnp.where(hi > jnp.maximum(s0, 0), hi - 1, _NONE)
            if method in ("threshold", "half_maximum"):
                (prof,) = rows
                masked = jnp.where(in_window, prof, _NEG)
                peak = jnp.max(masked)
                peak_idx = jnp.argmax(masked).astype(jnp.int32)
                level = method_frac * peak
                if method == "threshold":
                    below = jnp.logical_not(in_window & (prof >= level))
                    below = (cols >= peak_idx) & below
                else:
                    below = in_window & (cols >= peak_idx) & (prof < level)
                first_below = jnp.min(jnp.where(below, cols, _BIG_I))
                edge = jnp.where(first_below > window_end, window_end,
                                 first_below - 1)
                ok = (peak > min_grad) & (edge >= peak_idx)
                return jnp.where(ok, edge, _NONE)
            # gradient: TwoSum double-float differences, lexicographic argmin
            prof, left, right = rows
            c_hi, c_lo = _two_sum(right, -left)
            c_hi, c_lo = c_hi * 0.5, c_lo * 0.5  # *0.5 is exact
            p = prof_refs[0]

            def at(idx):
                return p[v, j, jnp.clip(idx, 0, w - 1)]

            l_hi, l_lo = _two_sum(at(s0 + 1), -at(s0))
            r_hi, r_lo = _two_sum(at(s1 - 1), -at(s1 - 2))
            g_hi = jnp.where(cols == s0, l_hi, c_hi)
            g_lo = jnp.where(cols == s0, l_lo, c_lo)
            g_hi = jnp.where(cols == s1 - 1, r_hi, g_hi)
            g_lo = jnp.where(cols == s1 - 1, r_lo, g_lo)
            g_hi = jnp.where(in_window, g_hi, _POS)
            g_lo = jnp.where(in_window, g_lo, _POS)
            m_hi = jnp.min(g_hi)
            tie = g_hi == m_hi
            m_lo = jnp.min(jnp.where(tie, g_lo, _POS))
            pos = jnp.min(jnp.where(tie & (g_lo == m_lo), cols, _BIG_I))

            def lt(threshold):
                return (m_hi < threshold) | ((m_hi == threshold) & (m_lo < 0))

            ok = lt(-min_grad) & lt(np.float32(0.0)) & (s1 - s0 >= 2)
            return jnp.where(ok, pos, _NONE)

        def step(j, carry):
            state, (rows, frame, flags) = carry
            nxt = fetch(jnp.minimum(j + 1, m - 1))
            (lv_pos, lv_frame, p1_frame, p1_pos, vl_ok, vp_ok, n_entries,
             ddt, v_latest, v_prev, stop_step, stop_reason, clear_vc) = state
            # Tracking continues past the f32 stop decision (advisory only):
            # the authoritative truncation is recomputed on host in float64
            # from the integer positions (build_device_scan_output).
            active = (flags & _EMPTY) == 0
            prior_ok = (flags & _PRIOR) != 0

            # ---- search bounds (velocity-constrained, monotone right) ----
            no_hist = lv_pos < 0
            frames_elapsed = jnp.maximum(1, frame - lv_frame)
            s0 = jnp.where(no_hist, margin, lv_pos)
            s1 = jnp.where(
                no_hist,
                w_in,
                jnp.minimum(
                    w_in,
                    lv_pos + max_disp * frames_elapsed + search_window_px,
                ),
            )
            window_nonempty = s1 > s0
            in_window = (cols >= s0) & (cols < s1)

            final = detect(j, rows, s0, s1, in_window)
            final = jnp.where(window_nonempty & active & prior_ok, final, _NONE)
            detected = active & (final >= 0)

            # ---- history append (every active step) ----
            new_p1_frame = jnp.where(active, frame, p1_frame)
            new_p1_pos = jnp.where(active, final, p1_pos)
            new_lv_pos = jnp.where(detected, final, lv_pos)
            new_lv_frame = jnp.where(detected, frame, lv_frame)

            # ---- velocities (mirrors FlameTracker._update_velocities) ----
            have_prev_entry = active & (p1_pos >= 0) & detected
            dt = div((frame - p1_frame).astype(jnp.float32), frame_rate)
            vel_ok = have_prev_entry & (dt > 0) & (frame_rate > 0)
            v1 = jnp.where(
                vel_ok,
                div((final - p1_pos).astype(jnp.float32) * calibration, dt),
                np.float32(0.0),
            )
            new_v_prev = jnp.where(vel_ok, v_latest, v_prev)
            new_vp_ok = jnp.where(vel_ok, vl_ok, vp_ok)
            new_v_latest = jnp.where(vel_ok, v1, v_latest)
            new_vl_ok = jnp.where(vel_ok, _ONE, vl_ok)
            new_n_entries = jnp.where(vel_ok, n_entries + 1, n_entries)

            # ---- DDT latch ----
            ddt_hit = (vel_ok & (ddt < 0) & (vl_ok != 0)
                       & (v1 - v_latest > ddt_jump))
            new_ddt = jnp.where(ddt_hit, frame, ddt)

            # ---- exit / velocity-drop truncation ----
            exit_hit = detected & (final >= w - exit_margin_px)
            vel_now_ok = (new_vl_ok != 0) & (new_n_entries >= 1)
            prev_ok = (new_vp_ok != 0) & (new_n_entries >= 2)
            vdrop_hit = (
                active
                & jnp.logical_not(exit_hit)
                & vel_now_ok
                & prev_ok
                & (new_v_prev > 100.0)
                & (div(new_v_prev - new_v_latest, new_v_prev) > 0.5)
            )
            stopped_now = exit_hit | vdrop_hit
            recorded = detected & jnp.logical_not(stopped_now)
            is_post = (new_ddt >= 0) & (frame >= new_ddt)

            out_final[v, j] = final
            out_rec[v, j] = recorded.astype(jnp.int32)
            out_post[v, j] = is_post.astype(jnp.int32)
            out_s0[v, j] = s0
            out_s1[v, j] = s1

            # ---- write-once event latches ----
            first_stop = stopped_now & (stop_step < 0)
            new_stop_step = jnp.where(first_stop, j, stop_step)
            new_stop_reason = jnp.where(
                first_stop, jnp.where(exit_hit, _ONE, np.int32(2)), stop_reason
            )
            new_clear_vc = jnp.where(
                first_stop & (new_n_entries >= 2), new_n_entries - 2,
                clear_vc,
            )
            state = (new_lv_pos, new_lv_frame, new_p1_frame, new_p1_pos,
                     new_vl_ok, new_vp_ok, new_n_entries, new_ddt,
                     new_v_latest, new_v_prev, new_stop_step,
                     new_stop_reason, new_clear_vc)
            return state, nxt

        i32 = jnp.int32
        init = (i32(-1), i32(0), i32(0), i32(-1), i32(0), i32(0), i32(0),
                i32(-1), np.float32(0.0), np.float32(0.0), i32(-1), i32(0),
                i32(-1))
        state, _ = jax.lax.fori_loop(0, m, step, (init, fetch(0)))
        out_latch[v, 0] = state[10]   # stop_step
        out_latch[v, 1] = state[11]   # stop_reason
        out_latch[v, 2] = state[7]    # ddt_frame
        out_latch[v, 3] = state[12]   # clear_vc_entry

    return kernel


@partial(
    jax.jit,
    static_argnames=(
        "width",
        "edge_margin_px",
        "search_window_px",
        "exit_margin_px",
        "interpret",
        "method",
        "num_warps",
    ),
)
def pallas_tracking_scan_batched(
    frame_indices: jnp.ndarray,     # (V, M) int32
    sobel_lines: jnp.ndarray,       # (V, M, W) f32
    gradient_lines: jnp.ndarray,    # (V, M, W) f32
    empty: jnp.ndarray,             # (V, M) bool
    has_prior: jnp.ndarray,         # (V, M) bool
    width: int,
    min_gradient_strength: jnp.ndarray,
    sobel_threshold_fraction: jnp.ndarray,
    ddt_velocity_jump: jnp.ndarray,
    calibration: jnp.ndarray,       # (V,) f32 — per video
    frame_rate: jnp.ndarray,        # (V,) f32
    max_displacement_px: jnp.ndarray,   # (V,) i32
    edge_margin_px: int = 10,
    search_window_px: int = 100,
    exit_margin_px: int = 15,
    interpret: bool = False,
    method: str = "combined",
    intensity_lines: jnp.ndarray = None,   # (V, M, W) f32 — named methods
    method_fraction: jnp.ndarray = 0.5,    # threshold/half_maximum fraction
    num_warps: int = NUM_WARPS,
) -> DeviceScanResult:
    """Whole-batch tracking scan: one kernel, one program per video, state
    reset per video. Result fields are (V, M) / (V,) — the same structure
    as ``vmap(device_tracking_scan)``, to which it is bit-identical.

    ``method`` (static) selects the detector, mirroring
    :func:`hsip_tpu.track.device_scan.device_tracking_scan`: 'combined'
    consumes the sobel/gradient rows; the named profile methods
    ('threshold' | 'half_maximum' | 'gradient') consume
    ``intensity_lines`` and ignore the sobel/gradient arguments.
    """
    n_videos, m, w = sobel_lines.shape
    if w != width:
        raise ValueError(f"width {width} != profile width {w}")
    if m == 0 or n_videos == 0:
        raise ValueError("empty scan (caller handles zero-size batches)")
    if method not in _METHODS:
        raise ValueError(f"Unknown detection method: {method!r}")
    if method == "combined":
        profiles = [sobel_lines, gradient_lines]
    else:
        if intensity_lines is None:
            raise ValueError(f"method {method!r} requires intensity_lines")
        profiles = [intensity_lines]
    profiles = [jnp.asarray(p, jnp.float32) for p in profiles]

    params = jnp.stack([
        jnp.asarray(min_gradient_strength, jnp.float32),
        jnp.asarray(sobel_threshold_fraction, jnp.float32),
        jnp.asarray(ddt_velocity_jump, jnp.float32),
        jnp.asarray(method_fraction, jnp.float32),
    ])
    flags = (jnp.where(jnp.asarray(empty), _EMPTY, 0)
             | jnp.where(jnp.asarray(has_prior), _PRIOR, 0)).astype(jnp.int32)

    kernel = _make_kernel(
        m=m, width=width, block_w=_block_width(width),
        edge_margin_px=edge_margin_px, search_window_px=search_window_px,
        exit_margin_px=exit_margin_px, method=method, interpret=interpret,
    )
    step_shape = jax.ShapeDtypeStruct((n_videos, m), jnp.int32)
    (finals, recs, posts, s0s, s1s, latch) = pl.pallas_call(
        kernel,
        grid=(n_videos,),
        out_shape=[step_shape] * 5 + [
            jax.ShapeDtypeStruct((n_videos, 4), jnp.int32)
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="hsip_tracking_scan",
    )(
        params,
        jnp.asarray(frame_indices, jnp.int32),
        flags,
        jnp.asarray(calibration, jnp.float32).reshape(n_videos),
        jnp.asarray(frame_rate, jnp.float32).reshape(n_videos),
        jnp.asarray(max_displacement_px, jnp.int32).reshape(n_videos),
        *profiles,
    )
    return DeviceScanResult(
        final_position=finals,
        recorded=recs.astype(bool),
        is_post_ddt=posts.astype(bool),
        search_start=s0s,
        search_end=s1s,
        stop_step=latch[:, 0],
        stop_reason=latch[:, 1],
        ddt_frame=latch[:, 2],
        clear_vc_entry=latch[:, 3],
    )


def pallas_tracking_scan(
    frame_indices: jnp.ndarray,     # (M,) int32
    sobel_lines: jnp.ndarray,       # (M, W) f32
    gradient_lines: jnp.ndarray,    # (M, W) f32
    empty: jnp.ndarray,             # (M,) bool
    has_prior: jnp.ndarray,         # (M,) bool
    width: int,
    min_gradient_strength: jnp.ndarray,
    sobel_threshold_fraction: jnp.ndarray,
    ddt_velocity_jump: jnp.ndarray,
    calibration: jnp.ndarray,
    frame_rate: jnp.ndarray,
    max_displacement_px: jnp.ndarray = 3,
    edge_margin_px: int = 10,
    search_window_px: int = 100,
    exit_margin_px: int = 15,
    interpret: bool = False,
    method: str = "combined",
    intensity_lines: jnp.ndarray = None,   # (M, W) f32 — named methods
    method_fraction: jnp.ndarray = 0.5,
) -> DeviceScanResult:
    """Single-video kernel scan, lax.scan-bit-identical.

    Same argument contract as :func:`hsip_tpu.track.device_scan.
    device_tracking_scan` (all four detectors) — the V=1 case of
    :func:`pallas_tracking_scan_batched`. ``interpret`` runs the kernel in
    Pallas interpret mode (CPU parity tests).
    """
    m = frame_indices.shape[0]
    res = pallas_tracking_scan_batched(
        jnp.asarray(frame_indices).reshape(1, m),
        jnp.asarray(sobel_lines)[None],
        jnp.asarray(gradient_lines)[None],
        jnp.asarray(empty).reshape(1, m),
        jnp.asarray(has_prior).reshape(1, m),
        width=width,
        min_gradient_strength=min_gradient_strength,
        sobel_threshold_fraction=sobel_threshold_fraction,
        ddt_velocity_jump=ddt_velocity_jump,
        calibration=jnp.asarray(calibration, jnp.float32).reshape(1),
        frame_rate=jnp.asarray(frame_rate, jnp.float32).reshape(1),
        max_displacement_px=jnp.asarray(
            max_displacement_px, jnp.int32
        ).reshape(1),
        edge_margin_px=edge_margin_px,
        search_window_px=search_window_px,
        exit_margin_px=exit_margin_px,
        interpret=interpret,
        method=method,
        intensity_lines=(
            None if intensity_lines is None
            else jnp.asarray(intensity_lines)[None]
        ),
        method_fraction=method_fraction,
    )
    return DeviceScanResult(*(x[0] for x in res))
