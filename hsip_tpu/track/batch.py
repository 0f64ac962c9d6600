"""Collection-scale tracking: many videos, one device dispatch.

The library-scale path (BASELINE.json config #5): every video's centerline
profiles are computed by the batched map phase, padded to a common length,
and the WHOLE tracking state machine runs as ``vmap(lax.scan)`` over the
video axis on device — positions, DDT, exit truncation for the entire
library in one dispatch, no per-frame host round-trips. Host work is only
table formatting plus exact float64 velocity columns.

Contrast with the reference: one Python loop per frame per rank, with
rank-local tracking state that silently changed results under MPI
(SURVEY.md §2.6).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import numpy as np

from .config import FlameDetectorConfig, VideoSourceConfig
from .device_scan import device_tracking_scan
from .velocity import (
    ddt_frame_from_velocities,
    velocities_from_positions,
    iter_velocity_entries,
)
from .scan import (
    MIN_SIGNAL_FRACTION,
    FrameProfiles,
    TrackingOutput,
    compute_profiles_batched,
)
from .tracker import FlameTracker

__all__ = ["track_collection_device", "ScanHistory", "build_device_scan_output"]

# Introspection: which library path each uniform-shape group took on the
# most recent track_collection_device call — "fused" (one device program)
# or "chunked" (general map-then-scan). The driver dryrun and the chip
# tier assert the fused path actually engaged; a silent fallback would
# pass parity while losing the perf property the bench claims.
LAST_GROUP_PATHS: List[str] = []


class ScanHistory:
    """Tracker-shaped view over device-scan results (velocity history, DDT).

    Quacks like :class:`FlameTracker` for the surfaces consumers use
    (``get_velocity_history``, ``ddt_frame``, ``ddt_detected``,
    ``position_history``, ``last_position``).
    """

    def __init__(self, entries, velocity_map, ddt_frame):
        self._entries = entries  # [(frame, pos|None), ...]
        self._vel = velocity_map  # {frame: (v1, v2, vc)}
        self._ddt = ddt_frame

    @property
    def position_history(self):
        return list(self._entries)

    @property
    def last_position(self):
        for _, p in reversed(self._entries):
            if p is not None:
                return p
        return None

    @property
    def ddt_frame(self):
        return self._ddt

    @property
    def ddt_detected(self):
        return self._ddt is not None

    def get_velocity_history(self):
        return [(f, v1, v2, vc) for f, (v1, v2, vc) in sorted(self._vel.items())]

    def get_pre_ddt_velocities(self):
        if self._ddt is None:
            return self.get_velocity_history()
        return [e for e in self.get_velocity_history() if e[0] < self._ddt]

    def get_post_ddt_velocities(self):
        if self._ddt is None:
            return []
        return [e for e in self.get_velocity_history() if e[0] >= self._ddt]


def build_device_scan_output(
    frame_indices,
    empty,
    finals,
    width: int,
    exit_margin_px: int,
    ddt_velocity_jump: float,
    frame_rate: float,
    calibration: float,
    position_offset: float,
    time_fn,
    total_frames: int,
) -> TrackingOutput:
    """Reconstruct a TrackingOutput from device-scan arrays (shared by the
    single-video device scan and the vmapped collection path).

    The scan emits integer positions only as far as decisions go: the
    exit/velocity-drop truncation, the DDT latch, and the row labels are
    recomputed HERE in float64, exactly as the host scan and the reference
    loop (``process_videos.py:1486-1516``) decide them. The kernels' own
    f32 stop/DDT latches are advisory — an f32-computed v1 can land on the
    other side of the reference's strict ``prev_v1 > 100`` gate than the
    float64 value (e.g. 100.00001 vs exactly 100.0), which is why the
    kernels keep tracking past their own stop and the truth is derived
    from the integer positions, which are exact on every backend.
    """
    # The per-step history exactly as the kernels append it (every
    # non-empty step), with the authoritative float64 v1 sequence produced
    # lazily by the ONE shared implementation of the velocity-append rule
    # (iter_velocity_entries yields the growing entry list in lockstep with
    # the steps), so replaying the reference loop's decisions stops paying
    # for velocities the moment it breaks — the kernels track past their
    # advisory stops, so an early-exit video has a long discarded tail.
    steps = []  # (step_idx, frame, pos|None) per non-empty step
    for j in range(len(frame_indices)):
        if not empty[j]:
            pos = int(finals[j]) if finals[j] >= 0 else None
            steps.append((j, int(frame_indices[j]), pos))

    rows = []
    stop_step = -1
    stop_reason = None
    clear_vc_entry = -1
    n_hist = 0  # steps whose history entry the tracker keeps (stop incl.)
    vel_all = []  # the generator's (single, growing) velocity-entry list
    vel_gen = iter_velocity_entries(
        ((frame, pos) for _, frame, pos in steps), frame_rate, calibration
    )
    for (j, frame, pos), vel_all in zip(steps, vel_gen):
        n_hist += 1
        k = len(vel_all)  # velocity entries appended at or before this step
        detected = pos is not None
        # Exit check BEFORE recording (reference :1486-1494).
        if detected and pos >= width - exit_margin_px:
            stop_step, stop_reason = j, "exit"
        # Sudden >50% velocity drop, from >100 m/s (reference :1496-1509;
        # thresholds hard-coded there). Judged on the last two appended
        # velocity entries, fresh or stale — exactly the reference's
        # vel_history[-2]/last_velocity pair.
        elif (
            k >= 2
            and vel_all[k - 2][1] > 100
            and (vel_all[k - 2][1] - vel_all[k - 1][1]) / vel_all[k - 2][1]
            > 0.5
        ):
            stop_step, stop_reason = j, "velocity_drop"
        if stop_step >= 0:
            # clear_last_central_difference targets entry[-2] (ordinal).
            if k >= 2:
                clear_vc_entry = k - 2
            break
        if detected:
            rows.append((frame, time_fn(frame), pos,
                         pos * calibration + position_offset))

    # DDT latches inside detect() BEFORE the break checks, so the stop
    # step's own velocity entry participates; a row is post-DDT iff its
    # frame is at or past the first above-threshold v1 jump (rows before
    # the latch frame are False either way). At loop exit vel_all holds
    # exactly the entries appended at or before the last replayed step.
    ddt_frame = ddt_frame_from_velocities(vel_all, ddt_velocity_jump)
    rows = [
        (frame, t, pos, pos_m,
         ddt_frame is not None and frame >= ddt_frame)
        for frame, t, pos, pos_m in rows
    ]
    entries = [(frame, pos) for _, frame, pos in steps[:n_hist]]
    # Empty-frame count stops where the reference loop breaks.
    last_j = steps[n_hist - 1][0] if n_hist else len(frame_indices)
    n_empty = sum(bool(empty[j]) for j in range(last_j)) if stop_step >= 0 \
        else sum(bool(e) for e in empty)
    vel = velocities_from_positions(
        entries, frame_rate, calibration, clear_vc_entry=clear_vc_entry
    )
    history = ScanHistory(entries, vel, ddt_frame)
    return TrackingOutput(
        rows=rows,
        tracker=history,
        empty_frame_count=n_empty,
        break_frame=int(frame_indices[stop_step]) if stop_step >= 0 else None,
        break_reason=stop_reason,
        total_frames=total_frames,
    )


def track_collection_device(
    collection,
    config: Optional[FlameDetectorConfig] = None,
    source_config: Optional[VideoSourceConfig] = None,
    use_absolute_time: bool = True,
    chunk_size: Optional[int] = None,
    mesh=None,
    video_axis: str = "video",
    max_group_bytes: int = 2 << 30,
    stage_times=None,
) -> List[TrackingOutput]:
    """Track every video of a collection with vmapped device scans.

    Videos sharing (H, W) batch into ONE vmapped scan; a mixed-shape
    collection (e.g. Nova + Mini cameras in one library) runs one scan per
    shape group, results returned in collection order. Per-video
    calibration/offset come from ``source_config.get_calibration_for_file``
    (defaults 1.0 / 0.0). Returns one :class:`TrackingOutput` per video,
    identical to running the serial host scan on each.

    Each shape group's device-resident profile footprint (videos are padded
    to the group's longest frame count) is bounded by ``max_group_bytes``
    (default 2 GiB): oversized groups split into sub-batches, ordered by
    frame count so padding stays minimal — a 500-video library cannot
    overflow device memory, and one 100k-frame recording doesn't pad fifty
    2k-frame ones to 100k steps. Per-video results are independent, so sub-batching
    never changes output tables.

    With ``mesh`` (a :class:`jax.sharding.Mesh` carrying ``video_axis``),
    each sub-batch's video axis shards across devices: each device scans
    its videos concurrently — the multi-card layout where a whole library
    tracks in one dispatch across the cards. The video count is padded to
    the axis size with inert (all-empty) videos.

    ``stage_times`` (a :class:`~hsip_tpu.utils.StageTimes`) accumulates
    host wall-clock per pipeline stage across ALL videos/sub-batches —
    staging stages from the map phase plus ``collate`` (pad/stack),
    ``scan_dispatch`` and ``tables`` (the blocking device fetch + float64
    host reconstruction). Map-pool threads overlap, so stage sums can
    exceed end-to-end wall-clock (see StageTimes).
    """
    config = config or FlameDetectorConfig()
    LAST_GROUP_PATHS.clear()
    videos = list(collection)
    if not videos:
        return []
    groups: dict = {}
    for idx, video in enumerate(videos):
        groups.setdefault(video.frame_shape, []).append(idx)
    outputs: List[Optional[TrackingOutput]] = [None] * len(videos)
    for (_h, w), idxs in groups.items():
        for sub in _split_by_footprint(idxs, videos, w, max_group_bytes):
            group_outputs = _track_uniform_videos(
                [videos[i] for i in sub], w, config, source_config,
                use_absolute_time, chunk_size, mesh, video_axis,
                stage_times=stage_times,
            )
            for i, out in zip(sub, group_outputs):
                outputs[i] = out
    return outputs  # type: ignore[return-value]


# The device scan holds 4 float32 (V, n_max, W) line sets per sub-batch
# (sobel, gradient, intensity, raw).
_PROFILE_ARRAYS = 4


def _split_by_footprint(idxs, videos, w: int, max_group_bytes: int):
    """Split a shape group into sub-batches whose padded profile footprint
    (V * n_max * W * 4 B * 4 arrays) stays under ``max_group_bytes``.

    Ordered by frame count, so each sub-batch's ``n_max`` is its last
    member's length and short recordings never pad to a long one's count.
    A single video over the budget still runs (sub-batch of one).
    """
    by_len = sorted(idxs, key=lambda i: len(videos[i]))
    batches, current = [], []
    for i in by_len:
        n_max = len(videos[i])  # ascending order: the max of current + [i]
        if current and (
            (len(current) + 1) * n_max * w * 4 * _PROFILE_ARRAYS
            > max_group_bytes
        ):
            batches.append(current)
            current = []
        current.append(i)
    if current:
        batches.append(current)
    return batches


def _track_uniform_videos(
    videos,
    w: int,
    config: FlameDetectorConfig,
    source_config: Optional[VideoSourceConfig],
    use_absolute_time: bool,
    chunk_size: Optional[int],
    mesh,
    video_axis: str,
    stage_times=None,
) -> List[TrackingOutput]:
    """One vmapped device scan over videos sharing a frame shape (the scan
    consumes width-``w`` profiles; height only shapes the map phase)."""
    from ..utils.profiling import StageTimes

    if stage_times is None:
        stage_times = StageTimes()  # unobserved; keeps the code one-path
    method = source_config.detection_method if source_config else "combined"
    use_frame_diff = source_config.use_frame_diff if source_config else True

    # --- fused fast path: the whole group as ONE device program ---
    # (band-staged groups without skip lists; falls through to the
    # general chunked path when preconditions fail — track/fused.py.
    # Under a mesh the fused program itself is shard_map-ped over the
    # video axis, so each device decodes and tracks only its shard.)
    from .fused import track_uniform_videos_fused

    fused = track_uniform_videos_fused(
        videos, w, config, source_config, use_absolute_time,
        stage_times=stage_times, mesh=mesh, video_axis=video_axis,
    )
    if fused is not None:
        LAST_GROUP_PATHS.append("fused")
        return fused
    LAST_GROUP_PATHS.append("chunked")

    # --- map phase per video (chunked, packed on-device decode) ---
    # A small thread pool overlaps one video's HOST work (C++ counts + band
    # gather, both GIL-releasing) with another's device transfer/dispatch
    # (jax dispatch is thread-safe). Order is preserved via executor.map.
    def _map_one(video) -> FrameProfiles:
        bg = float(np.max(video[0]))
        read_packed, read_band, count_fn, storage_depth = video.staging_paths()
        cs = chunk_size or (4096 if read_band is not None else 256)
        return compute_profiles_batched(
            read_batch=video.read_batch,
            n_frames=len(video),
            frame_shape=video.frame_shape,
            background_scalar=bg,
            config=config,
            skip_frames=(
                source_config.skip_frames if source_config is not None else ()
            ),
            chunk_size=cs,
            read_packed=read_packed,
            read_band=read_band,
            count_fn=count_fn,
            read_band_counts=(
                video.band_bytes_and_counts if read_band is not None else None
            ),
            band_bit_depth=storage_depth,
            keep_device=True,
            stage_times=stage_times,
        )

    if len(videos) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(4, len(videos))) as pool:
            profiles: List[FrameProfiles] = list(pool.map(_map_one, videos))
    else:
        profiles = [_map_one(v) for v in videos]

    # --- pad to a common step count; padding rows are 'empty' (no-ops) ---
    _collate_t = stage_times.stage("collate")
    _collate_t.__enter__()
    n_max = max(p.frame_indices.size for p in profiles)
    V = len(videos)
    v_pad = 0
    if mesh is not None:
        axis = mesh.shape[video_axis]
        v_pad = (-V) % axis
    V = V + v_pad
    import jax.numpy as jnp

    fi = np.zeros((V, n_max), dtype=np.int32)
    empty = np.ones((V, n_max), dtype=bool)
    has_prior = np.ones((V, n_max), dtype=bool)
    cals = np.zeros(V, dtype=np.float32)
    fpss = np.zeros(V, dtype=np.float32)
    max_disps = np.zeros(V, dtype=np.int32)
    # Profile lines stay DEVICE-resident: pad each video's (m, W) stack to
    # n_max rows on device and stack along the new video axis.
    sob_parts, grad_parts, intens_parts = [], [], []

    def _pad_rows(x, m):
        return jnp.pad(x, ((0, n_max - m), (0, 0))) if m < n_max else x

    calibs: List[Tuple[float, float]] = []
    for i, (video, p) in enumerate(zip(videos, profiles)):
        m = p.frame_indices.size
        fi[i, :m] = p.frame_indices
        fi[i, m:] = (p.frame_indices[-1] if m else 0) + np.arange(1, n_max - m + 1)
        if method == "combined":
            # Named methods never read sobel/gradient (the detector branch
            # is static), so skip staging them — device zeros stand in.
            sob_parts.append(_pad_rows(p.sobel_lines, m))
            grad_parts.append(_pad_rows(p.gradient_lines, m))
        intens_i, has_prior_i = p.select_intensity(method, use_frame_diff)
        if intens_i is not None:
            intens_parts.append(_pad_rows(intens_i, m))
        empty[i, :m] = p.signal_counts / p.total_pixels < MIN_SIGNAL_FRACTION
        has_prior[i, :m] = has_prior_i
        if source_config is not None:
            cal, off = source_config.get_calibration_for_file(video.filepath.name)
        else:
            cal, off = 1.0, 0.0
        calibs.append((cal, off))
        cals[i] = cal
        fpss[i] = video.frame_rate
        max_disps[i] = FlameTracker(config, video.frame_rate, cal).max_displacement_px
    # Inert pad videos (mesh alignment): all-empty frames, sane params.
    zero_lines = jnp.zeros((n_max, w), dtype=jnp.float32)
    for i in range(len(videos), V):
        if method == "combined":
            sob_parts.append(zero_lines)
            grad_parts.append(zero_lines)
        else:
            intens_parts.append(zero_lines)
        cals[i] = 1.0
        fpss[i] = 1.0
        max_disps[i] = 1

    # The unused profile set rides as device-created zeros: both scan
    # backends trace it but the statically-chosen detector branch never
    # reads it, so no host bytes cross for it.
    dev_zeros = jnp.zeros((V, n_max, w), dtype=jnp.float32)
    sob = jnp.stack(sob_parts) if method == "combined" else dev_zeros
    grad = jnp.stack(grad_parts) if method == "combined" else dev_zeros
    intens = (
        jnp.stack(intens_parts) if method != "combined" else dev_zeros
    )
    _collate_t.__exit__(None, None, None)

    # --- one device scan over the whole video axis ---
    # On a GPU the Pallas (Triton) kernel runs one program per video; other
    # backends vmap the lax.scan. Under a mesh each device scans its own
    # shard. Both are bit-identical by contract; a kernel failure raises.
    from . import pallas_scan

    if n_max > 0 and pallas_scan.kernel_enabled():
        kernel_fraction = np.float32(
            config.threshold_fraction if method == "threshold"
            else config.half_maximum_fraction
        )

        def kernel_scan(fi_l, sob_l, grad_l, it_l, empty_l, hp_l,
                        cal_l, fps_l, md_l):
            return pallas_scan.pallas_tracking_scan_batched(
                fi_l, sob_l, grad_l, empty_l, hp_l,
                width=w,
                min_gradient_strength=np.float32(
                    config.min_gradient_strength
                ),
                sobel_threshold_fraction=np.float32(
                    config.sobel_threshold_fraction
                ),
                ddt_velocity_jump=np.float32(config.ddt_velocity_jump_m_s),
                calibration=cal_l,
                frame_rate=fps_l,
                max_displacement_px=md_l,
                edge_margin_px=config.edge_margin_px,
                search_window_px=config.search_window_px,
                exit_margin_px=config.exit_margin_px,
                interpret=pallas_scan.INTERPRET,
                method=method,
                intensity_lines=it_l,
                method_fraction=kernel_fraction,
            )

        kern_args = (
            jnp.asarray(fi), sob, grad, intens,
            jnp.asarray(empty), jnp.asarray(has_prior),
            jnp.asarray(cals), jnp.asarray(fpss), jnp.asarray(max_disps),
        )
        if mesh is not None:
            # Each device runs the kernel over ITS videos (V is already
            # padded to the axis size).
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            from .device_scan import DeviceScanResult

            vm = P(video_axis, None)
            vmw = P(video_axis, None, None)
            vs = P(video_axis)
            kernel_scan = jax.jit(shard_map(
                kernel_scan,
                mesh=mesh,
                in_specs=(vm, vmw, vmw, vmw, vm, vm, vs, vs, vs),
                out_specs=DeviceScanResult(
                    final_position=vm, recorded=vm, is_post_ddt=vm,
                    search_start=vm, search_end=vm,
                    stop_step=vs, stop_reason=vs,
                    ddt_frame=vs, clear_vc_entry=vs,
                ),
                check_vma=False,
            ))
        with stage_times.stage("scan_dispatch"):
            res = kernel_scan(*kern_args)
        return _outputs_from_scan(
            res, videos, profiles, fi, empty, calibs, use_absolute_time,
            config, stage_times=stage_times,
        )

    fraction = (config.threshold_fraction if method == "threshold"
                else config.half_maximum_fraction)
    scan_v = jax.vmap(
        lambda f, s, g, it, e, hp, c, r, md: device_tracking_scan(
            f, s, g, e, hp,
            width=w,
            min_gradient_strength=np.float32(config.min_gradient_strength),
            sobel_threshold_fraction=np.float32(config.sobel_threshold_fraction),
            ddt_velocity_jump=np.float32(config.ddt_velocity_jump_m_s),
            calibration=c,
            frame_rate=r,
            max_displacement_px=md,
            edge_margin_px=config.edge_margin_px,
            search_window_px=config.search_window_px,
            exit_margin_px=config.exit_margin_px,
            method=method,
            intensity_lines=it,
            method_fraction=np.float32(fraction),
        )
    )
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        def shard(x, *rest_axes):
            spec = P(video_axis, *rest_axes)
            return jax.device_put(x, NamedSharding(mesh, spec))

        fi = shard(fi, None)
        sob = shard(sob, None, None)
        grad = shard(grad, None, None)
        intens = shard(intens, None, None)
        empty_d = shard(empty, None)
        has_prior_d = shard(has_prior, None)
        cals_d = shard(cals)
        fpss_d = shard(fpss)
        max_disps_d = shard(max_disps)
        with stage_times.stage("scan_dispatch"):
            res = scan_v(fi, sob, grad, intens, empty_d, has_prior_d,
                         cals_d, fpss_d, max_disps_d)
        fi = np.asarray(fi)
    else:
        with stage_times.stage("scan_dispatch"):
            res = scan_v(
                fi, sob, grad, intens, empty, has_prior,
                cals, fpss, max_disps,
            )

    return _outputs_from_scan(
        res, videos, profiles, fi, empty, calibs, use_absolute_time, config,
        stage_times=stage_times,
    )


def _outputs_from_scan(res, videos, profiles, fi, empty, calibs,
                       use_absolute_time,
                       config: FlameDetectorConfig,
                       stage_times=None) -> List[TrackingOutput]:
    """Host reconstruction shared by the kernel and vmapped-lax.scan paths:
    rows, float64 velocities, and the authoritative float64
    truncation/DDT decisions per video — the scans emit integer positions
    (their f32 stop latches are advisory; see build_device_scan_output)."""
    from ..utils.profiling import StageTimes

    if stage_times is None:
        stage_times = StageTimes()
    outputs: List[TrackingOutput] = []
    # The ONE blocking device fetch of the scan results: every device wait
    # the free-running map phase hid lands here.
    with stage_times.stage("d2h"):
        finals = jax.device_get(res.final_position)

    _tables_t = stage_times.stage("tables")
    _tables_t.__enter__()
    for i, (video, p) in enumerate(zip(videos, profiles)):
        m = p.frame_indices.size
        cal, off = calibs[i]
        time_fn = video.get_absolute_time if use_absolute_time else video.get_time
        outputs.append(
            build_device_scan_output(
                fi[i, :m],
                empty[i, :m],
                finals[i, :m],
                width=p.width,
                exit_margin_px=config.exit_margin_px,
                ddt_velocity_jump=config.ddt_velocity_jump_m_s,
                frame_rate=video.frame_rate,
                calibration=cal,
                position_offset=off,
                time_fn=time_fn,
                total_frames=len(video),
            )
        )
    _tables_t.__exit__(None, None, None)
    return outputs
