"""Map-then-scan tracking driver: batched device profiles → host tracker.

The execution model for one video (SURVEY.md §7 design):

1. **Map phase (parallel, device):** decode + background-subtract + frame-diff
   + opening + blur + Sobel/gradient centerline extraction for ALL frames,
   batched and band-optimized (:func:`hsip_tpu.kernels.preprocess.
   batch_centerline_profiles`). Frames are streamed in chunks with one frame
   of overlap so each chunk carries its differencing priors.
2. **Scan phase (sequential, host, float64):** the :class:`FlameTracker`
   state machine consumes the tiny (W,)-profiles per frame, applying the
   reference's serial semantics exactly: empty-frame skipping, search bounds,
   candidate selection, velocities, DDT latch, domain-exit and velocity-drop
   truncation (parity: ``scripts/process_videos.py:1441-1527``).

This split fixes the reference's MPI semantic quirks (rank-local detector
state, §2.6 of SURVEY.md): results are defined as *identical to a serial
run*, while the heavy pixel work is fully parallel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .config import FlameDetectorConfig
from .tracker import FlameTracker

__all__ = [
    "FrameProfiles",
    "TrackingOutput",
    "compute_profiles_batched",
    "run_tracking_scan",
    "run_tracking_scan_device",
    "track_video",
]

# Empty-frame test constants (reference process_videos.py:1458-1459).
MIN_SIGNAL_FRACTION = 0.0005
NOISE_THRESHOLD_FLOOR = 10.0


@dataclass
class FrameProfiles:
    """Per-video precomputed detection inputs (the map-phase output)."""

    frame_indices: np.ndarray      # (M,) processed frame indices, ascending
    sobel_lines: np.ndarray        # (M, W) float
    gradient_lines: np.ndarray     # (M, W) float
    intensity_lines: np.ndarray    # (M, W) denoised diff centerline (profile
                                   # detector input when use_frame_diff)
    raw_center_lines: np.ndarray   # (M, W) BG-subtracted centerline (profile
                                   # detector input when not use_frame_diff)
    signal_counts: np.ndarray      # (M,) int — above-noise pixel counts
    has_prior: np.ndarray          # (M,) bool — False only for the first
    width: int
    total_pixels: int              # H * W, for the empty-frame fraction

    def select_intensity(self, method: str, use_frame_diff: bool):
        """(profile_lines, has_prior) for a detection method — the single
        source of truth shared by the host scan, the device scan and the
        collection batch path. Named methods on raw (non-diff) profiles
        detect from the very first frame, so has_prior is all-True there.
        """
        if method != "combined" and not use_frame_diff:
            ones = np.ones(self.frame_indices.size, dtype=bool)
            return self.raw_center_lines, ones
        if method == "combined":
            return None, self.has_prior
        return self.intensity_lines, self.has_prior


@dataclass
class TrackingOutput:
    """Scan-phase output for one video."""

    rows: List[Tuple]              # (frame, time_s, pos_px, pos_m, is_post_ddt)
    tracker: FlameTracker
    empty_frame_count: int = 0
    break_frame: Optional[int] = None
    break_reason: Optional[str] = None   # 'exit' | 'velocity_drop' | None
    total_frames: int = 0                # frames in the recording
    #: wall-clock phase attribution: {'map_s', 'scan_s'}. The map phase
    #: free-runs (dispatch without blocking), so device waits it hides are
    #: paid by — and attributed to — the scan phase.
    phase_timings: Optional[dict] = None

    def merged_rows(self) -> List[Tuple]:
        """Rows with velocities merged from the final tracker history:
        (frame, time_s, pos_px, pos_m, v1, v2, vc, is_post_ddt)."""
        vel = {e[0]: (e[1], e[2], e[3]) for e in self.tracker.get_velocity_history()}
        out = []
        for f, t, px, m, is_post in self.rows:
            v1, v2, vc = vel.get(f, (None, None, None))
            out.append((f, t, px, m, v1, v2, vc, is_post))
        return out


def compute_profiles_batched(
    read_batch: Callable[[int, int], np.ndarray],
    n_frames: int,
    frame_shape: Tuple[int, int],
    background_scalar: float,
    config: FlameDetectorConfig,
    skip_frames: Sequence[int] = (),
    chunk_size: int = 256,
    device_fn=None,
    read_packed: Optional[Callable[[int, int], np.ndarray]] = None,
    read_band: Optional[Callable] = None,
    count_fn: Optional[Callable] = None,
    read_band_counts: Optional[Callable] = None,
    band_bit_depth: int = 12,
    keep_device: bool = False,
    need_intensity: bool = True,
    need_raw: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    stage_times=None,
) -> FrameProfiles:
    """Map phase: batched device computation of per-frame centerline profiles.

    Args:
        read_batch: callable (start, stop) -> (n, H, W) decoded frames.
        n_frames: total frames in the video.
        frame_shape: (H, W).
        background_scalar: max of frame 0 (reference behavior).
        config: detector configuration (thresholds, kernel, sigma).
        skip_frames: explicitly excluded frame indices.
        chunk_size: frames per device dispatch (static shape; last chunk pads).
        device_fn: override for the batched kernel (testing/backends).
        read_packed: callable (start, stop) -> (n, frame_nbytes) PACKED bytes.
            When given (10/12/16-bit containers with byte-aligned rows), raw
            bytes ship to the device and decode there — no host decode, and
            for packed 10/12-bit 1.6-2.67x less transfer.
        read_band: callable (start, stop, rows) -> (n, B, row_nbytes) packed
            BAND bytes. With ``count_fn`` (native empty-frame counts on
            host), only the centerline band ever crosses to the device —
            the minimal-transfer path (~15 percent of the payload at H=128).
            8/10/12/16-bit containers supported (``band_bit_depth``, the
            storage depth — also used by the full-frame packed path).
        keep_device: return the (N, W) profile lines as DEVICE-resident jnp
            arrays (for the on-device scan) instead of fetched numpy; only
            the signal counts come back to host.
        need_intensity / need_raw: skip the device->host fetch of profile
            line sets the caller's detection method never reads (their
            arrays stay zero). Ignored when keep_device=True.
        count_fn: callable (start, stop, background, threshold) -> (n,) int
            above-noise pixel counts computed host-side (C++ fast pass).
        read_band_counts: callable (start, stop, rows, background, threshold,
            out=None) -> (band, counts) | None — the FUSED native staging
            pass (band rows AND counts in ONE sweep over the packed payload;
            half the host DRAM traffic of ``read_band`` + ``count_fn``).
            ``None`` results (stale .so, exotic container) degrade to the
            two-pass shape transparently.
        progress: callable (staged, total) invoked after each chunk
            dispatch — the map-then-scan analogue of the reference's
            per-50-frame progress prints (process_videos.py:1524-1527).
            "Staged" counts processed frames whose device work has been
            DISPATCHED (the map phase free-runs; results arrive later).
        stage_times: optional :class:`~hsip_tpu.utils.StageTimes` that
            accumulates host wall-clock per stage (``read_gather``,
            ``h2d``, ``device_dispatch``, ``counts_host``, ``drain``) so
            a bench/regression can attribute end-to-end time to disk/host
            staging vs transfer vs device waits.

    The differencing prior of each processed frame is the previous processed
    frame (empty frames included — they advance the motion baseline).
    Chunks overlap by one processed frame so priors never cross host↔device.
    """
    import jax

    from ..kernels.preprocess import (
        band_folds,
        band_margin,
        batch_centerline_profiles,
        reflect_indices,
    )
    from ..kernels.unpack import packed_band_profiles, packed_centerline_profiles

    if device_fn is None:
        device_fn = batch_centerline_profiles

    skip = set(int(s) for s in skip_frames)
    processed = np.array([i for i in range(n_frames) if i not in skip], dtype=np.int64)
    m = processed.size
    h, w = frame_shape
    noise_threshold = max(NOISE_THRESHOLD_FLOOR, background_scalar * 0.5)
    use_band = read_band is not None and count_fn is not None
    margin = band_margin(config.morphology_kernel_size, config.gaussian_sigma)
    band_rows = reflect_indices(h // 2, margin, h)

    # Even morphology kernels have asymmetric vertical windows that do not
    # commute with the reflect row-gathering, so when the band would fold
    # over the image edge the device band path is NOT exact — route this
    # (rare: non-default even k on short frames) configuration through the
    # per-stage-repadding float64 host ops.
    if config.morphology_kernel_size % 2 == 0 and band_folds(h // 2, margin, h):
        return _compute_profiles_host_exact(
            read_batch, n_frames, frame_shape, background_scalar, config,
            skip_frames, progress=progress,
        )

    sobel_lines = np.zeros((m, w), dtype=np.float32)
    gradient_lines = np.zeros((m, w), dtype=np.float32)
    intensity_lines = np.zeros((m, w), dtype=np.float32)
    raw_center_lines = np.zeros((m, w), dtype=np.float32)
    signal_counts = np.zeros(m, dtype=np.int64)

    # Chunk plan over the PROCESSED index list; each chunk includes the
    # previous processed frame at its head (prior overlap), chunk j covers
    # processed positions [start, stop). Batches are COMPACTED to the frames
    # actually needed (head prior + processed): skipped frames never enter a
    # batch, so a long skip run can neither blow up host/transfer footprint
    # nor mint a novel bucket shape (a fresh shape costs a remote compile).
    # Row j's differencing prior is row j-1 by construction.
    chunks = []  # (pos, stop, needed, row0, row1, prior_index_full)
    pos = 0
    while pos < m:
        # Interior chunks take chunk_size-1 NEW frames: with the one-frame
        # prior overlap their batch spans exactly chunk_size rows, landing
        # on the power-of-two bucket. chunk_size frames would span
        # chunk_size+1 rows and bucket-pad to DOUBLE the transfer.
        stop = min(m, pos + (chunk_size if pos == 0 else chunk_size - 1))
        if pos > 0:
            needed = np.concatenate(
                [processed[pos - 1 : pos], processed[pos:stop]]
            )
            offset = 1
        else:
            needed = processed[pos:stop].copy()
            offset = 0
        n_rows = needed.size
        # This chunk's processed frames sit at batch rows [row0, row1):
        # everything after the optional head prior. Carried as explicit
        # slice bounds so the drain selects rows structurally (no index
        # arrays to keep contiguous by convention).
        prior_index_full = np.arange(-1, n_rows - 1, dtype=np.int32)
        chunks.append((pos, stop, needed, offset, n_rows, prior_index_full))
        pos = stop

    def _multi_read(read, needed):
        """Read the needed raw frames as one batch, splitting the read at
        skip gaps so skipped frames are never decoded or staged."""
        runs = np.split(needed, np.where(np.diff(needed) != 1)[0] + 1)
        parts = [read(int(r[0]), int(r[-1]) + 1) for r in runs]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _multi_read_fused(needed):
        """Fused band+counts staging over the needed frames (skip-gap
        aware). Returns (band, counts) or None when the fused native pass
        is unavailable — the caller then degrades to the two-pass shape."""
        runs = np.split(needed, np.where(np.diff(needed) != 1)[0] + 1)
        bands, cnts = [], []
        for r in runs:
            res = read_band_counts(
                int(r[0]), int(r[-1]) + 1, band_rows,
                background_scalar, noise_threshold,
            )
            if res is None:
                return None
            bands.append(res[0])
            cnts.append(res[1])
        if len(runs) == 1:
            return bands[0], cnts[0]
        return np.concatenate(bands), np.concatenate(cnts)

    # Streaming dispatch: read host chunk → device_put → dispatch kernel →
    # DROP the input device reference immediately; block only once at the
    # end, so transfers and device work overlap the next chunk's host read.
    #
    # Batch shapes are BUCKETED to the next power of two (padding rows carry
    # prior_index = -1, i.e. inert): without this every distinct chunk tail
    # and every differently-sized video would trigger a fresh compile.
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _pad_batch(host: np.ndarray, prior: np.ndarray):
        n = host.shape[0]
        b = _bucket(n)
        if b == n:
            return host, prior
        pad_host = np.zeros((b - n,) + host.shape[1:], dtype=host.dtype)
        return (
            np.concatenate([host, pad_host]),
            np.concatenate([prior, np.full(b - n, -1, dtype=np.int32)]),
        )

    pending = []  # (pos, stop, row0, row1, sob, grad, intens, rawc, counts)

    from concurrent.futures import ThreadPoolExecutor

    from ..utils.profiling import StageTimes

    if stage_times is None:
        stage_times = StageTimes()  # unobserved; keeps the code one-path

    count_pool = ThreadPoolExecutor(max_workers=1) if use_band else None
    try:
        for ci, (pos, stop, needed, row0, row1,
                 prior_index_full) in enumerate(chunks):
            if use_band:
                # Minimal-transfer path: only band rows ship. Preferred
                # staging is the FUSED native pass (band + counts in ONE
                # sweep — half the host DRAM traffic; the host is
                # memory-bound, so two overlapped passes still pay twice).
                counts = None
                if read_band_counts is not None:
                    with stage_times.stage("read_gather"):
                        fused_rc = _multi_read_fused(needed)
                    if fused_rc is None:
                        read_band_counts = None  # stale .so: stop probing
                    else:
                        host, counts = fused_rc
                if counts is None:
                    # Two-pass fallback: counts on host (C++ pass over the
                    # memmap, releases the GIL) run CONCURRENTLY with band
                    # gathering and the host->device transfer.
                    counts = count_pool.submit(
                        stage_times.wrap("counts_host", _multi_read),
                        lambda a, b: count_fn(a, b, background_scalar,
                                              noise_threshold),
                        needed,
                    )
                    with stage_times.stage("read_gather"):
                        host = np.ascontiguousarray(_multi_read(
                            lambda a, b: read_band(a, b, band_rows), needed
                        ))
                with stage_times.stage("read_gather"):
                    host, prior_index_full = _pad_batch(host, prior_index_full)
                with stage_times.stage("h2d"):
                    dev = jax.device_put(host)
                with stage_times.stage("device_dispatch"):
                    sob, grad, intens, rawc = packed_band_profiles(
                        dev,
                        np.float32(background_scalar),
                        prior_index_full,
                        np.float32(config.frame_diff_threshold),
                        morphology_kernel_size=config.morphology_kernel_size,
                        gaussian_sigma=config.gaussian_sigma,
                        bit_depth=band_bit_depth,
                    )
                del dev, host
                # counts is a Future: resolved in the drain loop so chunk i's
                # host count pass overlaps chunk i+1's gather/transfer.
                pending.append((pos, stop, row0, row1, sob, grad, intens, rawc,
                                counts))
                if progress is not None:
                    progress(stop, m)
                continue
            with stage_times.stage("read_gather"):
                host = (
                    np.ascontiguousarray(_multi_read(read_packed, needed))
                    if read_packed is not None
                    else _multi_read(read_batch, needed)
                )
                host, prior_index_full = _pad_batch(host, prior_index_full)
            with stage_times.stage("h2d"):
                dev = jax.device_put(host)
            with stage_times.stage("device_dispatch"):
                if read_packed is not None:
                    sob, grad, intens, rawc, counts = packed_centerline_profiles(
                        dev,
                        h,
                        w,
                        np.float32(background_scalar),
                        prior_index_full,
                        np.float32(config.frame_diff_threshold),
                        np.float32(noise_threshold),
                        morphology_kernel_size=config.morphology_kernel_size,
                        gaussian_sigma=config.gaussian_sigma,
                        bit_depth=band_bit_depth,
                    )
                else:
                    sob, grad, intens, rawc, counts = device_fn(
                        dev,
                        np.float32(background_scalar),
                        prior_index_full,
                        np.float32(config.frame_diff_threshold),
                        np.float32(noise_threshold),
                        morphology_kernel_size=config.morphology_kernel_size,
                        gaussian_sigma=config.gaussian_sigma,
                    )
            del dev, host
            pending.append((pos, stop, row0, row1, sob, grad, intens, rawc,
                                counts))
            if progress is not None:
                progress(stop, m)

    finally:
        if count_pool is not None:
            # Tear the worker down deterministically (queued count futures
            # still execute and stay resolvable; wait=False so a raise in
            # the dispatch loop doesn't block on them).
            count_pool.shutdown(wait=False)

    def _counts_of(c):
        return c.result() if hasattr(c, "result") else c

    if keep_device:
        # Device-resident profiles for the on-device scan: only the tiny
        # signal counts come back to host; the (N, W) lines never do.
        import jax.numpy as jnp

        if not pending:  # zero processed frames (e.g. everything skipped)
            z = jnp.zeros((0, w), dtype=jnp.float32)
            sobel_lines = gradient_lines = intensity_lines = z
            raw_center_lines = z
            signal_counts = np.zeros(0, dtype=np.int64)
            return FrameProfiles(
                frame_indices=processed,
                sobel_lines=sobel_lines,
                gradient_lines=gradient_lines,
                intensity_lines=intensity_lines,
                raw_center_lines=raw_center_lines,
                signal_counts=signal_counts,
                has_prior=np.ones(0, dtype=bool),
                width=w,
                total_pixels=h * w,
            )
        # Row selection is a STATIC slice — an integer-array index would
        # lower to a device gather per chunk per array (index buffer
        # upload + gather dispatch), which dominated the whole library
        # map phase on slow-dispatch backends.
        sel = [
            (row0, row1, sob, grad, intens, rawc)
            for pos, stop, row0, row1, sob, grad, intens, rawc, counts
            in pending
        ]
        with stage_times.stage("drain"):
            sobel_lines = jnp.concatenate([s[a:b] for a, b, s, g, i, r in sel])
            gradient_lines = jnp.concatenate(
                [g[a:b] for a, b, s, g, i, r in sel]
            )
            intensity_lines = jnp.concatenate(
                [i[a:b] for a, b, s, g, i, r in sel]
            )
            raw_center_lines = jnp.concatenate(
                [r[a:b] for a, b, s, g, i, r in sel]
            )
            cnt = np.zeros(m, dtype=np.int64)
            for pos, stop, row0, row1, _s, _g, _i, _r, counts in pending:
                cnt[pos:stop] = np.asarray(_counts_of(counts))[row0:row1]
            signal_counts = cnt
    else:
        with stage_times.stage("drain"):
            for pos, stop, a, b, sob, grad, intens, rawc, counts in pending:
                # The kernel computed profiles for every batch row; keep the
                # processed ones (a contiguous slice — a fancy-index here
                # would mint an extra full-chunk copy on the bandwidth-
                # starved host). Skip device->host fetches the caller's
                # detection method never reads.
                sobel_lines[pos:stop] = np.asarray(sob)[a:b]
                gradient_lines[pos:stop] = np.asarray(grad)[a:b]
                if need_intensity:
                    intensity_lines[pos:stop] = np.asarray(intens)[a:b]
                if need_raw:
                    raw_center_lines[pos:stop] = np.asarray(rawc)[a:b]
                signal_counts[pos:stop] = np.asarray(_counts_of(counts))[a:b]

    has_prior = np.ones(m, dtype=bool)
    if m:
        has_prior[0] = False
    return FrameProfiles(
        frame_indices=processed,
        sobel_lines=sobel_lines,
        gradient_lines=gradient_lines,
        intensity_lines=intensity_lines,
        raw_center_lines=raw_center_lines,
        signal_counts=signal_counts,
        has_prior=has_prior,
        width=w,
        total_pixels=h * w,
    )


def _compute_profiles_host_exact(
    read_batch,
    n_frames: int,
    frame_shape: Tuple[int, int],
    background_scalar: float,
    config: FlameDetectorConfig,
    skip_frames: Sequence[int] = (),
    progress: Optional[Callable[[int, int], None]] = None,
) -> FrameProfiles:
    """Float64 host map phase (kernels.reference): the exactness fallback
    for geometries the band kernels cannot reproduce (even morphology
    kernels with a folding band)."""
    from ..kernels import reference as hostops

    skip = set(int(s) for s in skip_frames)
    processed = np.array(
        [i for i in range(n_frames) if i not in skip], dtype=np.int64
    )
    m = processed.size
    h, w = frame_shape
    noise_threshold = max(NOISE_THRESHOLD_FLOOR, background_scalar * 0.5)
    center = h // 2
    k = config.morphology_kernel_size

    sobel_lines = np.zeros((m, w), dtype=np.float32)
    gradient_lines = np.zeros((m, w), dtype=np.float32)
    intensity_lines = np.zeros((m, w), dtype=np.float32)
    raw_center_lines = np.zeros((m, w), dtype=np.float32)
    signal_counts = np.zeros(m, dtype=np.int64)

    prior_sub = None
    for j, frame_idx in enumerate(processed):
        if progress is not None and j and j % 50 == 0:
            progress(j, m)
        frame = read_batch(int(frame_idx), int(frame_idx) + 1)[0]
        sub = hostops.subtract_scalar_background(frame, background_scalar)
        signal_counts[j] = int(np.sum(sub > noise_threshold))
        raw_center_lines[j] = sub[center]
        if prior_sub is not None:
            diff = hostops.subtract_prior_frame(
                sub, prior_sub, config.frame_diff_threshold
            )
            opened = hostops.grey_opening(diff, (k, k))
            blurred = hostops.gaussian_filter(opened, config.gaussian_sigma)
            sobel_lines[j] = hostops.sobel(blurred, axis=1)[center]
            gradient_lines[j] = hostops.gradient_x(blurred)[center]
            intensity_lines[j] = blurred[center]
        prior_sub = sub

    has_prior = np.ones(m, dtype=bool)
    if m:
        has_prior[0] = False
    return FrameProfiles(
        frame_indices=processed,
        sobel_lines=sobel_lines,
        gradient_lines=gradient_lines,
        intensity_lines=intensity_lines,
        raw_center_lines=raw_center_lines,
        signal_counts=signal_counts,
        has_prior=has_prior,
        width=w,
        total_pixels=h * w,
    )


def run_tracking_scan(
    profiles: FrameProfiles,
    config: FlameDetectorConfig,
    frame_rate: float,
    calibration_m_per_px: float,
    position_offset_m: float = 0.0,
    time_fn: Optional[Callable[[int], float]] = None,
    on_result=None,
    detection_method: str = "combined",
    use_frame_diff: bool = True,
) -> TrackingOutput:
    """Scan phase: sequential tracker over precomputed profiles.

    Replicates the reference frame loop exactly (empty skip → detect → exit
    check → velocity-drop check → record), in float64 on host.

    ``on_result(result, tracker)`` is invoked per detection (for viz hooks).

    Thresholds quantize to float32 here (profiles are f32), making every
    threshold decision bit-identical to the on-device lax.scan backend —
    the two scans differ by construction in NOTHING, not just "within
    margins". The full-frame float64 ``FlameDetector`` (exact backend)
    keeps pure f64 thresholds; its anchor is the scipy oracle.
    """
    tracker = FlameTracker(
        config, frame_rate, calibration_m_per_px, quantize_thresholds=True
    )
    rows: List[Tuple] = []
    empty_count = 0
    break_frame = None
    break_reason = None

    if time_fn is None:
        time_fn = lambda i: i / frame_rate if frame_rate > 0 else 0.0  # noqa: E731

    width = profiles.width
    total_px = profiles.total_pixels
    # Single source of truth for profile selection (shared with the device
    # and collection scans).
    intensity_lines, detect_gate = profiles.select_intensity(
        detection_method, use_frame_diff
    )

    for j, frame_idx in enumerate(profiles.frame_indices):
        frame_idx = int(frame_idx)
        time_s = time_fn(frame_idx)

        # Empty-frame skip: advances the prior chain (already baked into the
        # precomputed diffs) but never touches tracker state.
        if profiles.signal_counts[j] / total_px < MIN_SIGNAL_FRACTION:
            empty_count += 1
            continue

        if profiles.has_prior[j]:
            sobel_line = np.asarray(profiles.sobel_lines[j], dtype=np.float64)
            gradient_line = np.asarray(profiles.gradient_lines[j], dtype=np.float64)
        else:
            sobel_line = None
            gradient_line = None
        intensity_line = (
            np.asarray(intensity_lines[j], dtype=np.float64)
            if intensity_lines is not None and detect_gate[j]
            else None
        )

        # Spline prediction is plot-only; skip it unless a viz hook consumes
        # the result (an every-frame refit would make the scan O(N^2)).
        result = tracker.step(
            frame_idx, width, sobel_line, gradient_line,
            predict_spline=on_result is not None,
            intensity_line=intensity_line,
            method=detection_method,
        )
        if on_result is not None:
            if j > 0:
                result.prior_frame_idx = int(profiles.frame_indices[j - 1])
            on_result(result, tracker)

        flame_position = result.final_position
        velocity = tracker.last_velocity

        # Domain-exit check BEFORE recording: at-edge positions carry
        # artificially low velocity and must not enter the table.
        if (
            flame_position is not None
            and flame_position >= width - config.exit_margin_px
        ):
            tracker.clear_last_central_difference()
            break_frame, break_reason = frame_idx, "exit"
            break

        # Sudden >50% velocity drop (edge artifact short of the margin).
        prev_v1, _latest = tracker.last_two_v1()
        if velocity is not None and prev_v1 is not None and prev_v1 > 100:
            if (prev_v1 - velocity) / prev_v1 > 0.5:
                tracker.clear_last_central_difference()
                break_frame, break_reason = frame_idx, "velocity_drop"
                break

        if flame_position is not None:
            pos_m = flame_position * calibration_m_per_px + position_offset_m
            is_post_ddt = tracker.ddt_detected and frame_idx >= tracker.ddt_frame
            rows.append((frame_idx, time_s, flame_position, pos_m, is_post_ddt))

    return TrackingOutput(
        rows=rows,
        tracker=tracker,
        empty_frame_count=empty_count,
        break_frame=break_frame,
        break_reason=break_reason,
    )


def run_tracking_scan_device(
    profiles: FrameProfiles,
    config: FlameDetectorConfig,
    frame_rate: float,
    calibration_m_per_px: float,
    position_offset_m: float = 0.0,
    time_fn=None,
    detection_method: str = "combined",
    use_frame_diff: bool = True,
    stage_times=None,
) -> TrackingOutput:
    """Scan phase ON DEVICE: one-kernel tracker over device-resident profiles.

    Only the per-frame positions/masks (a few KB) cross back to host; exact
    float64 velocity columns are reconstructed from the integer positions.
    Proven row-identical to :func:`run_tracking_scan` (tests/test_device_scan).

    On a GPU every detector ('combined' and the three named profile
    methods) runs as one Pallas (Triton) kernel launch
    (:mod:`hsip_tpu.track.pallas_scan`); other backends use the
    ``lax.scan`` implementation. Both are bit-identical by contract. A
    kernel failure raises: there is no silent fallback.
    """

    from .batch import ScanHistory, build_device_scan_output
    from .device_scan import device_tracking_scan
    from . import pallas_scan
    from ..utils.profiling import StageTimes

    if stage_times is None:
        stage_times = StageTimes()  # unobserved; keeps the code one-path
    if time_fn is None:
        time_fn = lambda i: i / frame_rate if frame_rate > 0 else 0.0  # noqa: E731

    m = profiles.frame_indices.size
    if m == 0:
        return TrackingOutput(rows=[], tracker=ScanHistory([], {}, None))
    empty = profiles.signal_counts / profiles.total_pixels < MIN_SIGNAL_FRACTION
    intensity, has_prior = profiles.select_intensity(
        detection_method, use_frame_diff
    )
    # The detector branch is chosen statically, so the unused profile set
    # never crosses to the device: 'combined' leaves intensity as None
    # (the scan substitutes on-device zeros) and named methods send
    # device-created zeros in place of sobel/gradient.
    if detection_method == "combined":
        sob_in, grad_in = profiles.sobel_lines, profiles.gradient_lines
    else:
        import jax.numpy as _jnp

        sob_in = grad_in = _jnp.zeros(
            (m, profiles.width), dtype=_jnp.float32
        )
    fraction = (
        config.threshold_fraction
        if detection_method == "threshold"
        else config.half_maximum_fraction
    )
    max_disp = FlameTracker(
        config, frame_rate, calibration_m_per_px
    ).max_displacement_px

    import jax

    scan_args = (
        np.asarray(profiles.frame_indices, dtype=np.int32),
        sob_in,
        grad_in,
        empty,
        has_prior,
    )
    scan_kwargs = dict(
        width=profiles.width,
        min_gradient_strength=np.float32(config.min_gradient_strength),
        sobel_threshold_fraction=np.float32(config.sobel_threshold_fraction),
        ddt_velocity_jump=np.float32(config.ddt_velocity_jump_m_s),
        calibration=np.float32(calibration_m_per_px),
        frame_rate=np.float32(frame_rate),
        max_displacement_px=np.int32(max_disp),
        edge_margin_px=config.edge_margin_px,
        search_window_px=config.search_window_px,
        exit_margin_px=config.exit_margin_px,
        method=detection_method,
        intensity_lines=intensity,
        method_fraction=np.float32(fraction),
    )
    _scan_t = stage_times.stage("scan_dispatch")
    _scan_t.__enter__()
    if pallas_scan.kernel_enabled():
        res = pallas_scan.pallas_tracking_scan(
            *scan_args, interpret=pallas_scan.INTERPRET, **scan_kwargs
        )
    else:
        res = device_tracking_scan(*scan_args, **scan_kwargs)

    _scan_t.__exit__(None, None, None)
    # Only the integer positions come back: the truncation/DDT decisions
    # are recomputed in float64 on host (the in-scan f32 latches are
    # advisory — see build_device_scan_output). ONE transfer, not
    # per-field fetches (each blocks separately on a high-latency link).
    # This is also the pipeline's ONE blocking device wait: every free-run
    # map transfer/dispatch still in flight drains here (stage "d2h").
    with stage_times.stage("d2h"):
        finals = jax.device_get(res.final_position)
    with stage_times.stage("tables"):
        out = build_device_scan_output(
            np.asarray(profiles.frame_indices),
            empty,
            finals,
            width=profiles.width,
            exit_margin_px=config.exit_margin_px,
            ddt_velocity_jump=config.ddt_velocity_jump_m_s,
            frame_rate=frame_rate,
            calibration=calibration_m_per_px,
            position_offset=position_offset_m,
            time_fn=time_fn,
            total_frames=0,  # caller (track_video) fills the length
        )
    return out


def track_video(
    video,
    config: FlameDetectorConfig,
    calibration_m_per_px: float,
    position_offset_m: float = 0.0,
    skip_frames: Sequence[int] = (),
    use_absolute_time: bool = True,
    chunk_size: Optional[int] = None,
    background_scalar: Optional[float] = None,
    on_result=None,
    detection_method: str = "combined",
    use_frame_diff: bool = True,
    scan: str = "host",
    mesh=None,
    progress: Optional[Callable[[int, int], None]] = None,
    stage_times=None,
) -> TrackingOutput:
    """End-to-end tracking of one :class:`~hsip_tpu.video.PhotonVideo`.

    Map phase on device; ``scan`` selects where the sequential tracker runs:
    'host' (float64 numpy — supports viz hooks and all methods) or 'device'
    (one device kernel — profiles never leave the device; proven
    row-identical, velocities reconstructed in float64 from positions).
    Background taken from frame 0's max (reference behavior) unless given.

    With ``mesh`` (a Mesh carrying a 'frame' axis), the map phase shards the
    video's frames across devices with a one-band ``ppermute`` halo for the
    differencing priors — the shard_map replacement for the reference's MPI
    frame scatter, with serial-identical results at any device count; it
    composes with either scan backend.
    """
    if scan not in ("host", "device"):
        raise ValueError(f"Unknown scan backend {scan!r} ('host' or 'device')")
    if scan == "device" and on_result is not None:
        # Validate BEFORE the (potentially minutes-long) map phase runs.
        raise ValueError("viz hooks require scan='host'")
    if background_scalar is None:
        background_scalar = float(np.max(video[0]))

    if mesh is not None:
        sharded_kwargs = {}
        if chunk_size is not None:
            # Honor the caller's host-memory bound: chunk_size total frames
            # per streamed chunk ≈ frames_per_shard × n_shards.
            n_shards = mesh.shape["frame"]
            sharded_kwargs["frames_per_shard"] = max(1, chunk_size // n_shards)
        profiles = _compute_profiles_sharded(
            video, background_scalar, config, skip_frames, mesh,
            progress=progress,
            **sharded_kwargs,
        )
        time_fn = (
            video.get_absolute_time if use_absolute_time else video.get_time
        )
        scan_fn = run_tracking_scan_device if scan == "device" else run_tracking_scan
        kwargs = {} if scan == "device" else {"on_result": on_result}
        out = scan_fn(
            profiles,
            config,
            frame_rate=video.frame_rate,
            calibration_m_per_px=calibration_m_per_px,
            position_offset_m=position_offset_m,
            time_fn=time_fn,
            detection_method=detection_method,
            use_frame_diff=use_frame_diff,
            **kwargs,
        )
        out.total_frames = len(video)
        return out

    # Packed recordings decode on-device from raw payload bytes; with the
    # native codec, only band rows ship (counts computed host-side).
    read_packed, read_band, count_fn, storage_depth = video.staging_paths()
    if chunk_size is None:
        # Band staging is ~2% of the payload, so big chunks amortize
        # dispatch overhead cheaply; full-frame staging stays bounded.
        chunk_size = 4096 if read_band is not None else 256
    import time as _time

    t0 = _time.perf_counter()
    profiles = compute_profiles_batched(
        read_batch=video.read_batch,
        n_frames=len(video),
        frame_shape=video.frame_shape,
        background_scalar=background_scalar,
        config=config,
        skip_frames=skip_frames,
        chunk_size=chunk_size,
        read_packed=read_packed,
        read_band=read_band,
        count_fn=count_fn,
        read_band_counts=(
            video.band_bytes_and_counts if read_band is not None else None
        ),
        band_bit_depth=storage_depth,
        keep_device=scan == "device",
        need_intensity=detection_method != "combined" and use_frame_diff,
        need_raw=detection_method != "combined" and not use_frame_diff,
        progress=progress,
        stage_times=stage_times,
    )
    t_map = _time.perf_counter() - t0
    time_fn = video.get_absolute_time if use_absolute_time else video.get_time
    t0 = _time.perf_counter()
    if scan == "device":
        out = run_tracking_scan_device(
            profiles,
            config,
            frame_rate=video.frame_rate,
            calibration_m_per_px=calibration_m_per_px,
            position_offset_m=position_offset_m,
            time_fn=time_fn,
            detection_method=detection_method,
            use_frame_diff=use_frame_diff,
            stage_times=stage_times,
        )
    else:
        out = run_tracking_scan(
            profiles,
            config,
            frame_rate=video.frame_rate,
            calibration_m_per_px=calibration_m_per_px,
            position_offset_m=position_offset_m,
            time_fn=time_fn,
            on_result=on_result,
            detection_method=detection_method,
            use_frame_diff=use_frame_diff,
        )
    out.phase_timings = {
        "map_s": round(t_map, 4),
        "scan_s": round(_time.perf_counter() - t0, 4),
    }
    if stage_times is not None:
        out.phase_timings["stages"] = stage_times.as_dict()
    out.total_frames = len(video)
    return out


def _compute_profiles_sharded(
    video, background_scalar, config, skip_frames, mesh,
    frames_per_shard: int = 512,
    progress: Optional[Callable[[int, int], None]] = None,
) -> FrameProfiles:
    """Map phase over a device mesh: frames shard along the 'frame' axis with
    halo exchange for the differencing priors (parallel/sharding.py).

    Streams the recording in chunks of ``frames_per_shard * n_shards`` with a
    one-frame overlap (each chunk's first frame is the previous chunk's last,
    carrying the differencing prior; its output row is dropped), so host/device
    footprint stays bounded on long recordings.

    ``skip_frames`` are excluded entirely (not processed, not priors —
    batched-path semantics): each processed frame diffs against the previous
    PROCESSED frame, so compacting the processed frames before sharding
    preserves prior adjacency and the same halo machinery applies unchanged.
    """
    from ..kernels.preprocess import band_folds, band_margin
    from ..parallel.sharding import sharded_centerline_profiles

    # Same exactness fallback as the batched path (see
    # compute_profiles_batched): even morphology kernels with a folding
    # centerline band cannot be reproduced by the sharded band kernel.
    h_full = video.frame_shape[0]
    margin = band_margin(config.morphology_kernel_size, config.gaussian_sigma)
    if (config.morphology_kernel_size % 2 == 0
            and band_folds(h_full // 2, margin, h_full)):
        return _compute_profiles_host_exact(
            video.read_batch, len(video), video.frame_shape,
            background_scalar, config, skip_frames, progress=progress,
        )

    skip = set(int(s) for s in skip_frames)
    processed = np.array(
        [i for i in range(len(video)) if i not in skip], dtype=np.int64
    )
    m = processed.size
    h, w = video.frame_shape
    noise_threshold = max(NOISE_THRESHOLD_FLOOR, background_scalar * 0.5)
    n_shards = mesh.shape["frame"]
    chunk = max(n_shards, frames_per_shard * n_shards)

    sob = np.zeros((m, w), dtype=np.float32)
    grad = np.zeros((m, w), dtype=np.float32)
    intens = np.zeros((m, w), dtype=np.float32)
    rawc = np.zeros((m, w), dtype=np.float32)
    counts = np.zeros(m, dtype=np.int64)

    start = 0
    while start < m:
        stop = min(m, start + chunk)
        lo_pos = max(0, start - 1)  # one-frame overlap carries the prior
        idxs = processed[lo_pos:stop]
        lo, hi = int(idxs[0]), int(idxs[-1]) + 1
        if hi - lo == idxs.size:
            frames = video.read_batch(lo, hi)
        else:
            # Read each contiguous run of processed indices separately: one
            # spanning read would decode every skipped frame in the gaps
            # (a long skip run could pull GBs of unwanted frames into host
            # memory, breaking the bounded-footprint contract).
            runs = np.split(idxs, np.where(np.diff(idxs) != 1)[0] + 1)
            frames = np.concatenate(
                [video.read_batch(int(r[0]), int(r[-1]) + 1) for r in runs]
            )
        c_sob, c_grad, c_int, c_raw, c_cnt = sharded_centerline_profiles(
            frames,
            background_scalar,
            config.frame_diff_threshold,
            noise_threshold,
            mesh,
            morphology_kernel_size=config.morphology_kernel_size,
            gaussian_sigma=config.gaussian_sigma,
        )
        off = start - lo_pos  # 0 for the first chunk, 1 afterwards
        sob[start:stop] = c_sob[off:]
        grad[start:stop] = c_grad[off:]
        intens[start:stop] = c_int[off:]
        rawc[start:stop] = c_raw[off:]
        counts[start:stop] = c_cnt[off:]
        start = stop
        if progress is not None:
            progress(stop, m)

    has_prior = np.ones(m, dtype=bool)
    if m:
        has_prior[0] = False
    return FrameProfiles(
        frame_indices=processed,
        sobel_lines=sob,
        gradient_lines=grad,
        intensity_lines=intens,
        raw_center_lines=rawc,
        signal_counts=counts,
        has_prior=has_prior,
        width=w,
        total_pixels=h * w,
    )
