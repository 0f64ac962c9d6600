"""Device (lax.scan) tracker vs the host float64 scan: identical decisions."""

import numpy as np
import pytest

from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
from hsip_tpu.pipeline import process_video_file
from hsip_tpu.track import FlameDetectorConfig, VideoSourceConfig
from hsip_tpu.track.device_scan import (
    device_tracking_scan,
    velocities_from_positions,
)
from hsip_tpu.track.scan import (
    MIN_SIGNAL_FRACTION,
    compute_profiles_batched,
    run_tracking_scan,
)
from hsip_tpu.track.tracker import FlameTracker


def _run_both(frames, fps=100_000, cal=0.0008, config=None, method="combined"):
    config = config or FlameDetectorConfig()
    bg = float(np.max(frames[0]))
    profiles = compute_profiles_batched(
        read_batch=lambda a, b: frames[a:b],
        n_frames=len(frames),
        frame_shape=frames.shape[1:],
        background_scalar=bg,
        config=config,
    )
    host = run_tracking_scan(profiles, config, fps, cal, detection_method=method)

    empty = profiles.signal_counts / profiles.total_pixels < MIN_SIGNAL_FRACTION
    tr = FlameTracker(config, fps, cal)
    fraction = (config.threshold_fraction if method == "threshold"
                else config.half_maximum_fraction)
    dev = device_tracking_scan(
        profiles.frame_indices.astype(np.int32),
        profiles.sobel_lines,
        profiles.gradient_lines,
        empty,
        profiles.has_prior,
        width=profiles.width,
        min_gradient_strength=np.float32(config.min_gradient_strength),
        sobel_threshold_fraction=np.float32(config.sobel_threshold_fraction),
        ddt_velocity_jump=np.float32(config.ddt_velocity_jump_m_s),
        calibration=np.float32(cal),
        frame_rate=np.float32(fps),
        max_displacement_px=np.int32(tr.max_displacement_px),
        edge_margin_px=config.edge_margin_px,
        search_window_px=config.search_window_px,
        exit_margin_px=config.exit_margin_px,
        method=method,
        intensity_lines=profiles.intensity_lines,
        method_fraction=np.float32(fraction),
    )
    return host, dev, profiles, empty, config, fps, cal


@pytest.mark.parametrize(
    "flame",
    [
        FlameSpec(x0=30, v0_px=8, accel_px=0.3, ignition_frame=3,
                  ddt_frame=28, v_jump_px=25, seed=21),         # DDT + exit
        FlameSpec(x0=25, v0_px=4, ignition_frame=2, seed=5),     # steady
        FlameSpec(x0=60, v0_px=20, ignition_frame=1, seed=3),    # fast exit
        FlameSpec(ignition_frame=1000),                          # never ignites
    ],
)
@pytest.mark.parametrize("method", ["combined", "threshold", "gradient",
                                    "half_maximum"])
def test_device_scan_matches_host_scan(flame, method):
    frames, _ = synthesize_flame_video(60, height=48, width=512, flame=flame)
    host, dev, profiles, empty, config, fps, cal = _run_both(
        frames, method=method
    )

    stop_step = int(dev.stop_step)
    reason_map = {0: None, 1: "exit", 2: "velocity_drop"}
    assert reason_map[int(dev.stop_reason)] == host.break_reason
    if host.break_frame is not None:
        assert int(profiles.frame_indices[stop_step]) == host.break_frame

    # Recorded rows identical (frame, position, is_post_ddt).
    finals = np.asarray(dev.final_position)
    recs = np.asarray(dev.recorded)
    posts = np.asarray(dev.is_post_ddt)
    dev_rows = [
        (int(profiles.frame_indices[j]), int(finals[j]), bool(posts[j]))
        for j in range(len(recs))
        if recs[j] and (stop_step < 0 or j <= stop_step)
    ]
    host_rows = [(f, px, post) for f, _, px, _, post in host.rows]
    assert dev_rows == host_rows

    ddt_dev = int(dev.ddt_frame)
    assert (ddt_dev if ddt_dev >= 0 else None) == host.tracker.ddt_frame

    # Exact float64 velocity reconstruction matches the host tracker's.
    entries = []
    for j in range(len(finals)):
        if stop_step >= 0 and j > stop_step:
            break
        if empty[j]:
            continue
        f = int(profiles.frame_indices[j])
        p = int(finals[j]) if finals[j] >= 0 else None
        entries.append((f, p))
    vel = velocities_from_positions(
        entries, fps, cal, clear_vc_entry=int(dev.clear_vc_entry)
    )
    host_vel = {e[0]: (e[1], e[2], e[3])
                for e in host.tracker.get_velocity_history()}
    assert set(vel) == set(host_vel)
    for f in vel:
        for a, b in zip(vel[f], host_vel[f]):
            assert (a is None) == (b is None)
            if a is not None:
                assert a == pytest.approx(b, rel=1e-12)


def test_device_scan_respects_empty_frames():
    # All-background video: no detections, nothing recorded, no stop.
    frames, _ = synthesize_flame_video(
        12, height=32, width=256, flame=FlameSpec(ignition_frame=999)
    )
    host, dev, *_ = _run_both(frames)
    assert not np.any(np.asarray(dev.recorded))
    assert int(dev.stop_step) == -1
    assert host.rows == []


def test_track_collection_device_matches_per_video(tmp_path):
    """vmapped whole-library tracking == per-video host pipeline."""
    from hsip_tpu import open_collection
    from hsip_tpu.track import FileCalibration
    from hsip_tpu.track.batch import track_collection_device

    specs = [
        FlameSpec(x0=30, v0_px=8, accel_px=0.3, ignition_frame=3,
                  ddt_frame=28, v_jump_px=25, seed=21),
        FlameSpec(x0=25, v0_px=5, ignition_frame=2, seed=6),
        FlameSpec(x0=50, v0_px=16, ignition_frame=1, seed=9),
    ]
    lengths = [50, 40, 30]
    for i, (fl, n) in enumerate(zip(specs, lengths)):
        frames, _ = synthesize_flame_video(n, height=48, width=512, flame=fl)
        write_recording(
            tmp_path, f"lib-run-{i + 1}-x", frames,
            spec=CihxSpec(width=512, height=48, total_frames=n,
                          record_rate=100_000),
        )

    src = VideoSourceConfig(name="Lib", save_frame_images=False,
                            save_stacked_sequences=False)
    src.video_path = str(tmp_path)
    src.file_calibrations = [
        FileCalibration(calibration=0.0008, position_offset=1.0,
                        files=["run-1-:run-3-"]),
    ]

    coll = open_collection(str(tmp_path))
    batch_outputs = track_collection_device(
        coll, FlameDetectorConfig(), source_config=src
    )
    assert len(batch_outputs) == 3

    for i, video_path in enumerate(sorted(tmp_path.glob("*.cihx"))):
        single = process_video_file(
            video_path, src, backend="tpu", verbose=False, write_outputs=False
        )
        b = batch_outputs[i]
        assert [r[:4] for r in b.rows] == [r[:4] for r in single.rows], f"video {i}"
        assert b.break_reason == single.break_reason
        assert b.tracker.ddt_frame == single.tracker.ddt_frame
        # merged_rows (velocity columns) identical too.
        mb = b.merged_rows()
        ms = single.merged_rows()
        assert len(mb) == len(ms)
        for ra, rb in zip(mb, ms):
            assert ra[0] == rb[0] and ra[2] == rb[2]
            for x, y in zip(ra[4:7], rb[4:7]):
                assert (x is None) == (y is None)
                if x is not None:
                    assert abs(x - y) < 1e-9 * max(1.0, abs(y))
    coll.close_all()


def test_track_collection_device_mixed_shapes(tmp_path):
    """A mixed-shape library (two camera geometries) tracks as one scan per
    shape group, results in collection order and identical to per-video
    runs (regression: used to raise ValueError on non-uniform shapes)."""
    from hsip_tpu import open_collection
    from hsip_tpu.track.batch import track_collection_device

    geom = [(48, 512), (32, 256), (48, 512), (32, 256)]
    for i, (h, w) in enumerate(geom):
        fl = FlameSpec(x0=20, v0_px=5 + 2 * i, ignition_frame=2, seed=i)
        frames, _ = synthesize_flame_video(30, height=h, width=w, flame=fl)
        write_recording(
            tmp_path, f"mix-run-{i + 1}-x", frames,
            spec=CihxSpec(width=w, height=h, total_frames=30,
                          record_rate=50_000),
        )

    src = VideoSourceConfig(name="Mix", save_frame_images=False,
                            save_stacked_sequences=False)
    src.video_path = str(tmp_path)

    coll = open_collection(str(tmp_path))
    batch_outputs = track_collection_device(coll, FlameDetectorConfig(),
                                            source_config=src)
    assert len(batch_outputs) == 4
    for i, video_path in enumerate(sorted(tmp_path.glob("*.cihx"))):
        single = process_video_file(
            video_path, src, backend="tpu", verbose=False, write_outputs=False
        )
        b = batch_outputs[i]
        assert [r[:4] for r in b.rows] == [r[:4] for r in single.rows], f"video {i}"
        assert b.break_reason == single.break_reason
    coll.close_all()


@pytest.mark.parametrize("method", ["threshold", "gradient", "half_maximum"])
def test_track_collection_device_named_methods(tmp_path, method):
    """Batch device tracking with a named method == per-video host pipeline."""
    from hsip_tpu import open_collection
    from hsip_tpu.track.batch import track_collection_device

    for i in range(2):
        frames, _ = synthesize_flame_video(
            40, height=48, width=384,
            flame=FlameSpec(x0=30, v0_px=7, ignition_frame=2, seed=30 + i),
        )
        write_recording(tmp_path, f"nm-run-{i + 1}-a", frames,
                        spec=CihxSpec(width=384, height=48, total_frames=40,
                                      record_rate=100_000))

    src = VideoSourceConfig(name="NM", detection_method=method,
                            calibration=0.0008,
                            save_frame_images=False,
                            save_stacked_sequences=False)
    src.video_path = str(tmp_path)
    coll = open_collection(str(tmp_path))
    batch = track_collection_device(coll, FlameDetectorConfig(),
                                    source_config=src)
    for i, vp in enumerate(sorted(tmp_path.glob("*.cihx"))):
        single = process_video_file(vp, src, backend="tpu", verbose=False,
                                    write_outputs=False)
        assert [r[:4] for r in batch[i].rows] == [r[:4] for r in single.rows]
        assert batch[i].break_reason == single.break_reason
    coll.close_all()


@pytest.mark.parametrize("method", ["combined", "threshold"])
def test_track_video_device_scan_matches_host(tmp_path, method):
    """track_video(scan='device') — profiles stay on device — must equal
    the host-scan path row for row, including merged velocity columns."""
    from hsip_tpu import open_video
    from hsip_tpu.track.scan import track_video

    frames, _ = synthesize_flame_video(
        50, height=48, width=512,
        flame=FlameSpec(x0=30, v0_px=8, accel_px=0.3, ignition_frame=3,
                        ddt_frame=28, v_jump_px=25, seed=21),
    )
    meta = write_recording(tmp_path, "dv-run-1", frames,
                           spec=CihxSpec(width=512, height=48, total_frames=50,
                                         record_rate=100_000))
    with open_video(str(meta)) as video:
        host = track_video(video, FlameDetectorConfig(), 0.0008, 1.0,
                           detection_method=method, scan="host")
        dev = track_video(video, FlameDetectorConfig(), 0.0008, 1.0,
                          detection_method=method, scan="device")
    assert [r[:4] for r in dev.rows] == [r[:4] for r in host.rows]
    assert dev.break_reason == host.break_reason
    assert dev.empty_frame_count == host.empty_frame_count
    assert dev.tracker.ddt_frame == host.tracker.ddt_frame
    mh, md = host.merged_rows(), dev.merged_rows()
    for ra, rb in zip(md, mh):
        for x, y in zip(ra[4:7], rb[4:7]):
            assert (x is None) == (y is None)
            if x is not None:
                assert abs(x - y) < 1e-9 * max(1.0, abs(y))


def test_track_collection_device_sharded_over_mesh(tmp_path):
    """Video axis sharded across an 8-device mesh (3 videos pad to 8):
    results identical to the unsharded batch path."""
    from hsip_tpu import open_collection
    from hsip_tpu.parallel import make_mesh
    from hsip_tpu.track.batch import track_collection_device

    for i in range(3):
        frames, _ = synthesize_flame_video(
            30, height=32, width=256,
            flame=FlameSpec(x0=25, v0_px=6, ignition_frame=2, seed=40 + i),
        )
        write_recording(tmp_path, f"mesh-run-{i + 1}-a", frames,
                        spec=CihxSpec(width=256, height=32, total_frames=30,
                                      record_rate=80_000))
    src = VideoSourceConfig(name="M", calibration=0.001,
                            save_frame_images=False,
                            save_stacked_sequences=False)
    src.video_path = str(tmp_path)
    coll = open_collection(str(tmp_path))
    plain = track_collection_device(coll, FlameDetectorConfig(),
                                    source_config=src)
    mesh = make_mesh("video")
    sharded = track_collection_device(coll, FlameDetectorConfig(),
                                      source_config=src, mesh=mesh)
    assert len(sharded) == len(plain) == 3
    for a, b in zip(sharded, plain):
        assert a.rows == b.rows
        assert a.break_reason == b.break_reason
        assert a.tracker.ddt_frame == b.tracker.ddt_frame
    coll.close_all()


def test_threshold_product_boundary_host_equals_device():
    """Host scan and device scan must pick the SAME position when a profile
    value sits exactly at the fraction×peak threshold (host thresholds are
    f32-quantized to mirror the device's native float32 product — an f64
    host product provably flips the rightmost-Sobel pick at such values,
    e.g. smax=3185.1714, frac=0.1: f32 product 318.51715 vs f64 …13867)."""
    import jax.numpy as jnp

    from hsip_tpu.track.scan import FrameProfiles, run_tracking_scan

    config = FlameDetectorConfig()
    W, fps, cal = 256, 100_000.0, 0.0008
    smax = np.float32(3185.1714)
    boundary = np.float32(np.float32(smax) * np.float32(config.sobel_threshold_fraction))
    probes = [boundary,
              np.nextafter(boundary, np.float32(np.inf)),
              np.nextafter(boundary, np.float32(-np.inf))]
    for q in probes:
        sob = np.zeros((2, W), dtype=np.float32)
        sob[1, 100] = smax          # the window max
        sob[1, 120] = 500.0         # clearly above threshold
        sob[1, 140] = q             # the boundary probe, rightmost candidate
        grad = np.zeros((2, W), dtype=np.float32)  # no min-gradient candidate
        profiles = FrameProfiles(
            frame_indices=np.array([0, 1]),
            sobel_lines=sob,
            gradient_lines=grad,
            intensity_lines=np.zeros((2, W), np.float32),
            raw_center_lines=np.zeros((2, W), np.float32),
            signal_counts=np.array([10_000, 10_000]),
            has_prior=np.array([False, True]),
            width=W,
            total_pixels=W * 64,
        )
        host = run_tracking_scan(profiles, config, fps, cal)

        dev = device_tracking_scan(
            profiles.frame_indices.astype(np.int32),
            jnp.asarray(sob), jnp.asarray(grad),
            jnp.zeros(2, bool), jnp.asarray(profiles.has_prior),
            width=W,
            min_gradient_strength=np.float32(config.min_gradient_strength),
            sobel_threshold_fraction=np.float32(config.sobel_threshold_fraction),
            ddt_velocity_jump=np.float32(config.ddt_velocity_jump_m_s),
            calibration=np.float32(cal), frame_rate=np.float32(fps),
            max_displacement_px=np.int32(16),
        )
        host_pos = host.rows[0][2] if host.rows else None
        finals = np.asarray(dev.final_position)
        recs = np.asarray(dev.recorded)
        dev_pos = int(finals[1]) if recs[1] else None
        assert host_pos == dev_pos, (float(q), host_pos, dev_pos)


def test_device_gradient_exact_at_f64_ties():
    """The device 'gradient' detector carries differences as exact
    double-float pairs, so argmin ordering matches the host's float64
    arithmetic even at exact ties (locally-linear blurred profiles)."""
    import jax
    import jax.numpy as jnp

    from hsip_tpu.track.detectors import detect_gradient
    from hsip_tpu.track.device_scan import _detect_window_gradient

    rng = np.random.default_rng(3)
    W = 64
    cols = jnp.arange(W, dtype=jnp.int32)
    fn = jax.jit(
        lambda p, iw, s0, s1: _detect_window_gradient(
            p, iw, cols, s0, s1, jnp.float32(10.0)
        )
    )
    checked = 0
    for t in range(400):
        if t % 2 == 0:
            slope = rng.uniform(-30, 5)
            p = (rng.uniform(0, 50) + slope * np.arange(W)
                 + rng.normal(0, 0.01, W)).astype(np.float32)
        else:
            p = rng.uniform(0, 100, W).astype(np.float32)
        s0 = int(rng.integers(0, W - 2))
        s1 = int(rng.integers(s0 + 2, W + 1))
        iw = (np.arange(W) >= s0) & (np.arange(W) < s1)
        d = int(fn(jnp.asarray(p), jnp.asarray(iw), jnp.int32(s0), jnp.int32(s1)))
        h = detect_gradient(p.astype(np.float64), min_strength=10.0, bounds=(s0, s1))
        assert d == (-1 if h is None else h), (t, s0, s1)
        checked += 1
    assert checked == 400


def test_even_kernel_folding_band_falls_back_to_exact(tmp_path):
    """Even morphology kernels with a folding band (short frames) must use
    the float64 host ops — device band results equal the exact backend."""
    frames, _ = synthesize_flame_video(
        20, height=16, width=256,
        flame=FlameSpec(x0=30, v0_px=8, ignition_frame=2, seed=11),
    )
    meta = write_recording(tmp_path, "ek-run-1", frames,
                           spec=CihxSpec(width=256, height=16, total_frames=20,
                                         record_rate=50_000))
    cfg = VideoSourceConfig(name="EK", save_frame_images=False,
                            save_stacked_sequences=False)
    det = FlameDetectorConfig(morphology_kernel_size=4)
    t = process_video_file(meta, cfg, det, backend="tpu", verbose=False,
                           write_outputs=False)
    e = process_video_file(meta, cfg, det, backend="exact", verbose=False,
                           write_outputs=False)
    assert [r[:3] for r in t.rows] == [r[:3] for r in e.rows]
    assert t.break_reason == e.break_reason


def test_track_collection_footprint_subbatching(tmp_path):
    """A tiny max_group_bytes splits a shape group into multiple vmapped
    dispatches (ordered by length); tables must stay identical and in
    collection order."""
    from hsip_tpu import open_collection
    from hsip_tpu.track.batch import _split_by_footprint, track_collection_device

    lengths = [52, 20, 36]
    for i, n in enumerate(lengths):
        frames, _ = synthesize_flame_video(
            n, height=32, width=256,
            flame=FlameSpec(x0=24, v0_px=5, ignition_frame=2, seed=70 + i),
        )
        write_recording(tmp_path, f"foot-run-{i + 1}-001", frames)

    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        # Budget fits ONE longest video: every video becomes its own batch.
        tiny = 52 * 256 * 4 * 4 + 1
        subs = _split_by_footprint(list(range(3)), videos, 256, tiny)
        assert len(subs) == 3
        assert [len(videos[s[0]]) for s in subs] == sorted(lengths)

        unsplit = track_collection_device(coll, FlameDetectorConfig())
        split = track_collection_device(
            coll, FlameDetectorConfig(), max_group_bytes=tiny
        )
    assert len(split) == 3
    for a, b in zip(split, unsplit):
        assert a.rows == b.rows
        assert a.break_reason == b.break_reason
        assert a.tracker.get_velocity_history() == b.tracker.get_velocity_history()


def test_split_by_footprint_single_video_over_budget(tmp_path):
    from hsip_tpu.track.batch import _split_by_footprint

    class _FakeVideo:
        def __init__(self, n):
            self._n = n

        def __len__(self):
            return self._n

    videos = [_FakeVideo(100_000), _FakeVideo(10)]
    subs = _split_by_footprint([0, 1], videos, 1024, max_group_bytes=1024)
    assert sorted(map(sorted, subs)) == [[0], [1]]


def test_device_scan_matches_host_when_frame_rate_zero(tmp_path):
    """A missing 'Record Rate(fps)' header defaults frame_rate to 0; the
    host reconstruction then records no velocity entries, and the device
    scan must agree (dt = gap/0 = +inf used to pass the dt > 0 gate and
    drift the entry counts)."""
    from hsip_tpu import open_video
    from hsip_tpu.track import FlameDetectorConfig
    from hsip_tpu.track.scan import track_video

    frames, _ = synthesize_flame_video(
        30, height=32, width=256,
        flame=FlameSpec(x0=30, v0_px=8, ignition_frame=2, seed=41),
    )
    meta = write_recording(
        tmp_path, "zerofps-run-1-001", frames,
        spec=CihxSpec(width=256, height=32, total_frames=30, record_rate=0),
    )
    with open_video(str(meta)) as video:
        assert video.frame_rate == 0
        host = track_video(video, FlameDetectorConfig(), 0.001, scan="host")
        dev = track_video(video, FlameDetectorConfig(), 0.001, scan="device")
    assert [r[:3] for r in dev.rows] == [r[:3] for r in host.rows]
    assert dev.tracker.get_velocity_history() == host.tracker.get_velocity_history() == []
    assert dev.break_reason == host.break_reason


def test_velocity_drop_gate_is_float64_exact(tmp_path):
    """The reference's velocity-drop gate is a strict float64 compare
    (``prev_v1 > 100``, process_videos.py:1502). At 10 px/frame, 20k fps,
    0.0005 m/px the float64 v1 is exactly 100.0 (no break) while the f32
    chain in the device kernels computes 100.00001 (break) — so the
    authoritative decision must come from the float64 host recompute over
    integer positions, with the in-scan f32 stop latch advisory only.
    Regression: the lax.scan backend used to FREEZE at its f32 stop and
    lose every row the reference still produces (found by the reference
    fuzz; the pipeline-level flip was a missing-tail pre-DDT table)."""
    from hsip_tpu import open_video
    from hsip_tpu.track.scan import track_video

    h, w, n = 48, 640, 24
    drop_at = 12
    # Frame 0 is background-only (it sets the background scalar).
    edges = [40 + 10 * i for i in range(drop_at)]       # v1 = 100.0 exactly
    # 4 px/frame = 40.0 m/s: a 0.6 drop ratio (>0.5) whose 4-px diff
    # strip survives the 3x3 opening (a 2-px strip would be eroded).
    edges += [edges[-1] + 4 * (i + 1) for i in range(n - 1 - drop_at)]
    frames = np.full((n, h, w), 50, dtype=np.uint16)
    for i, e in enumerate(edges):
        frames[i + 1, :, :e] = 3000
    meta = write_recording(
        tmp_path, "vdrop-run-1-001", frames,
        spec=CihxSpec(width=w, height=h, total_frames=n, record_rate=20_000),
    )
    with open_video(str(meta)) as video:
        host = track_video(video, FlameDetectorConfig(), 0.0005, 0.0,
                           scan="host")
        dev = track_video(video, FlameDetectorConfig(), 0.0005, 0.0,
                          scan="device")

    # Premise guard: the exact boundary value really occurred, and the
    # >50% drop really followed it (only the >100 gate held the break off).
    v1s = [e[1] for e in host.tracker.get_velocity_history()]
    assert 100.0 in v1s and 40.0 in v1s
    # No backend may break; the post-drop rows must exist on both.
    assert host.break_reason is None
    assert dev.break_reason is None
    assert [r[:4] for r in dev.rows] == [r[:4] for r in host.rows]
    assert dev.rows[-1][0] >= n - 2  # tracked well past the drop frame
