"""End-to-end pipeline tests: device-batched vs exact backends, output tables."""

from pathlib import Path

import numpy as np
import pytest

from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
from hsip_tpu.pipeline import (
    process_video_file,
    process_video_source,
    write_position_results,
)
from hsip_tpu.track import FileCalibration, FlameDetectorConfig, VideoSourceConfig


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    flame = FlameSpec(
        x0=30.0, v0_px=8.0, accel_px=0.3, ignition_frame=3,
        ddt_frame=28, v_jump_px=25.0, seed=21,
    )
    frames, positions = synthesize_flame_video(
        n_frames=60, height=48, width=512, flame=flame
    )
    spec = CihxSpec(
        width=512, height=48, total_frames=60, record_rate=100_000,
        bit_depth=12, start_frame=-10,
    )
    meta = write_recording(tmp, "nova-run-1-003", frames, spec=spec)
    return {"path": meta, "dir": tmp, "frames": frames, "positions": positions}


def _source_config(recording, out, **kw):
    cfg = VideoSourceConfig(
        name="Nova", enabled=True,
        save_frame_images=False, save_stacked_sequences=False, **kw,
    )
    cfg.video_path = str(recording["dir"])
    cfg.output_dir = str(out)
    cfg.file_calibrations = [
        FileCalibration(calibration=0.000833333, position_offset=1.0159,
                        files=["run-1-"]),
    ]
    return cfg


def test_tpu_backend_matches_exact_backend(recording, tmp_path):
    """The batched band device path must produce IDENTICAL rows to the
    frame-at-a-time float64 exact path."""
    cfg = _source_config(recording, tmp_path / "o1")
    out_tpu = process_video_file(
        recording["path"], cfg, backend="tpu", verbose=False, write_outputs=False
    )
    out_exact = process_video_file(
        recording["path"], cfg, backend="exact", verbose=False, write_outputs=False
    )

    assert out_tpu.empty_frame_count == out_exact.empty_frame_count
    assert out_tpu.break_reason == out_exact.break_reason
    assert out_tpu.break_frame == out_exact.break_frame
    assert len(out_tpu.rows) == len(out_exact.rows)
    for a, b in zip(out_tpu.rows, out_exact.rows):
        assert a[0] == b[0]                      # frame
        assert a[1] == pytest.approx(b[1], abs=0)  # time (both from TimingInfo)
        assert a[2] == b[2]                      # position px — must be exact
        assert a[3] == pytest.approx(b[3], rel=1e-15)  # position m
        assert a[4] == b[4]                      # is_post_ddt
    # Velocity histories identical.
    va = out_tpu.tracker.get_velocity_history()
    vb = out_exact.tracker.get_velocity_history()
    assert len(va) == len(vb)
    for ea, eb in zip(va, vb):
        assert ea[0] == eb[0]
        for x, y in zip(ea[1:], eb[1:]):
            assert (x is None) == (y is None)
            if x is not None:
                assert x == pytest.approx(y, rel=1e-12)
    assert out_tpu.tracker.ddt_frame == out_exact.tracker.ddt_frame


def test_pipeline_tracks_trajectory_and_ddt(recording, tmp_path):
    cfg = _source_config(recording, tmp_path / "o2")
    out = process_video_file(
        recording["path"], cfg, backend="tpu", verbose=False, write_outputs=False
    )
    assert len(out.rows) > 20
    assert out.tracker.ddt_detected
    # Positions track analytic trajectory.
    pos = recording["positions"]
    errs = [abs(px - pos[f]) for f, _, px, _, _ in out.rows if np.isfinite(pos[f])]
    assert np.median(errs) < 12
    # Positions are monotone non-decreasing (flame moves right).
    pxs = [r[2] for r in out.rows]
    assert all(b >= a for a, b in zip(pxs, pxs[1:]))
    # Calibration applied: pos_m = px * cal + offset.
    f, t, px, m, _ = out.rows[0]
    assert m == pytest.approx(px * 0.000833333 + 1.0159, rel=1e-12)
    # Absolute timing: t = (start_frame + f) / fps with start_frame=-10.
    assert t == pytest.approx((-10 + f) / 100_000)


def test_results_tables_written_with_reference_format(recording, tmp_path):
    out_dir = tmp_path / "o3"
    cfg = _source_config(recording, out_dir)
    outputs = process_video_source(cfg, backend="tpu", verbose=False)
    assert len(outputs) == 1
    stem = "nova-run-1-003"
    main_table = out_dir / f"{stem}-flame-position.txt"
    assert main_table.exists()
    lines = main_table.read_text().splitlines()
    # Header block then column header.
    assert lines[0] == "# Flame Position and Velocity Data"
    col_line = next(l for l in lines if l.startswith("#Frame"))
    assert col_line == ("#Frame Time_s Position_px Position_m "
                       "Vel_Backward1 Vel_Backward2 Vel_Central")
    data_lines = [l for l in lines if l and not l.startswith("#")]
    assert len(data_lines) == len(outputs[0].rows)
    first = data_lines[0].split(" ")
    assert len(first) == 7
    int(first[0])           # frame parses as int
    assert "." in first[1] and len(first[1].split(".")[1]) == 9  # %.9f
    int(first[2])
    assert len(first[3].split(".")[1]) == 9
    # DDT split files exist (DDT occurs in this recording).
    assert (out_dir / f"{stem}-flame-position-pre-DDT.txt").exists()
    assert (out_dir / f"{stem}-flame-position-post-DDT.txt").exists()
    # Figures and sequences were both disabled: no empty '<stem>-frames/'
    # directory is littered into the output tree.
    assert not (out_dir / f"{stem}-frames").exists()


def test_write_position_results_none_velocities(tmp_path):
    rows = [(5, 0.000123456789, 42, 1.23456789, None, None, None),
            (6, 0.0002, 50, 1.3, 100.0, 150.5, 125.25)]
    path = write_position_results(rows, tmp_path / "t.txt")
    lines = [l for l in path.read_text().splitlines() if not l.startswith("#")]
    assert lines[0] == "5 0.000123457 42 1.234567890   "
    assert lines[1] == "6 0.000200000 50 1.300000000 100.000 150.500 125.250"


def test_empty_video_no_rows(tmp_path):
    """A recording with no flame at all: everything empty-skipped, no crash,
    no results rows."""
    frames, _ = synthesize_flame_video(
        10, height=32, width=128,
        flame=FlameSpec(ignition_frame=100),  # never ignites
    )
    meta = write_recording(tmp_path, "empty-run-1-a", frames)
    cfg = VideoSourceConfig(name="T", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.output_dir = str(tmp_path / "out")
    out = process_video_file(meta, cfg, backend="tpu", verbose=False)
    assert out.rows == []
    assert out.empty_frame_count == 10
    assert not (tmp_path / "out" / "empty-run-1-a-flame-position.txt").exists()


def test_skip_frames_respected(recording, tmp_path):
    cfg = _source_config(recording, tmp_path / "o4", skip_frames=[5, 6, 7])
    out = process_video_file(
        recording["path"], cfg, backend="tpu", verbose=False, write_outputs=False
    )
    out_exact = process_video_file(
        recording["path"], cfg, backend="exact", verbose=False, write_outputs=False
    )
    recorded = {r[0] for r in out.rows}
    assert not recorded & {5, 6, 7}
    assert [r[:3] for r in out.rows] == [r[:3] for r in out_exact.rows]


def test_exit_truncation(tmp_path):
    """Flame reaching the right margin stops recording at the exit frame."""
    flame = FlameSpec(x0=60.0, v0_px=20.0, ignition_frame=1, seed=3)
    frames, _ = synthesize_flame_video(30, height=32, width=256, flame=flame)
    meta = write_recording(tmp_path, "exit-run-1-b", frames,
                           spec=CihxSpec(width=256, height=32, total_frames=30,
                                         record_rate=50_000))
    cfg = VideoSourceConfig(name="T", save_frame_images=False,
                            save_stacked_sequences=False)
    out = process_video_file(meta, cfg, backend="tpu", verbose=False,
                             write_outputs=False)
    out_e = process_video_file(meta, cfg, backend="exact", verbose=False,
                               write_outputs=False)
    assert out.break_reason in ("exit", "velocity_drop")
    assert out.break_reason == out_e.break_reason
    assert out.break_frame == out_e.break_frame
    assert [r[:3] for r in out.rows] == [r[:3] for r in out_e.rows]
    # No recorded position inside the exit margin.
    assert all(r[2] < 256 - 15 for r in out.rows)


@pytest.mark.parametrize("method", ["threshold", "gradient", "half_maximum"])
def test_detection_methods_tpu_matches_exact(recording, tmp_path, method):
    """Each named profile method must agree between the device-batched and the
    exact float64 backends and produce a plausible trajectory."""
    cfg = _source_config(recording, tmp_path / f"m_{method}",
                         detection_method=method)
    out = process_video_file(
        recording["path"], cfg, backend="tpu", verbose=False, write_outputs=False
    )
    out_e = process_video_file(
        recording["path"], cfg, backend="exact", verbose=False, write_outputs=False
    )
    assert len(out.rows) > 10
    assert [r[:3] for r in out.rows] == [r[:3] for r in out_e.rows]
    assert out.break_reason == out_e.break_reason
    # The detected front should land within tens of px of the analytic edge
    # (method-dependent bias over the ~9px-wide blurred diff region is fine).
    pos = recording["positions"]
    errs = [abs(px - pos[f]) for f, _, px, _, _ in out.rows if np.isfinite(pos[f])]
    assert np.median(errs) < 25


def test_write_results_generic(tmp_path):
    from hsip_tpu.pipeline import write_results

    path = write_results(
        {"Frame": [1, 2], "Position_px": [10, 20]}, tmp_path / "g.txt"
    )
    assert path.read_text() == "Frame Position_px\n1 10\n2 20\n"
    empty = write_results({}, tmp_path / "e.txt")
    assert empty.read_text() == "\n"


def test_device_backend_matches_tpu_backend(recording, tmp_path):
    cfg = _source_config(recording, tmp_path / "odev")
    out_dev = process_video_file(
        recording["path"], cfg, backend="device", verbose=False,
        write_outputs=False, save_images=False,
    )
    out_tpu = process_video_file(
        recording["path"], cfg, backend="tpu", verbose=False,
        write_outputs=False,
    )
    assert [r[:4] for r in out_dev.rows] == [r[:4] for r in out_tpu.rows]
    assert out_dev.break_reason == out_tpu.break_reason
    assert out_dev.tracker.ddt_frame == out_tpu.tracker.ddt_frame


def test_unmatched_file_calibration_warns(recording, tmp_path, capsys):
    """When file_calibrations exist but none matches a recording, the
    pipeline must say so instead of silently using default units (the
    classic "A:B" range-pattern trap: it compares the LAST filename
    integer — 3 for the fixture's nova-run-1-003 — not the run number)."""
    cfg = _source_config(recording, tmp_path / "warn")
    cfg.file_calibrations = [
        FileCalibration(calibration=0.0008, position_offset=1.0,
                        files=["run-4-:run-9-"]),  # 3 is outside 4..9
    ]
    process_video_file(recording["path"], cfg, backend="tpu", verbose=False,
                       write_outputs=False)
    out = capsys.readouterr().out
    assert "no file_calibration entry matches" in out

    cfg.file_calibrations = [
        FileCalibration(calibration=0.0008, position_offset=1.0,
                        files=["run-1-"]),
    ]
    process_video_file(recording["path"], cfg, backend="tpu", verbose=False,
                       write_outputs=False)
    assert "no file_calibration entry" not in capsys.readouterr().out


def test_corrupt_recording_skipped_with_warning(tmp_path, capsys):
    """One unreadable recording must not abort a library run: the pipeline
    warns, records the failure in run-summary.json, and processes the rest
    (matching the collection layer's skip-and-warn contract)."""
    import json

    flame = FlameSpec(x0=25.0, v0_px=8.0, ignition_frame=2, seed=4)
    frames, _ = synthesize_flame_video(25, height=32, width=256, flame=flame)
    write_recording(tmp_path / "v", "good-run-1-a", frames,
                    spec=CihxSpec(width=256, height=32, total_frames=25,
                                  record_rate=50_000))
    (tmp_path / "v" / "corrupt-run-1-b.cihx").write_bytes(b"\x00garbage" * 64)

    cfg = VideoSourceConfig(name="T", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.video_path = str(tmp_path / "v")
    cfg.output_dir = str(tmp_path / "out")
    outs = process_video_source(cfg, verbose=False)
    assert len(outs) == 1 and len(outs[0].rows) > 5
    assert "Could not process" in capsys.readouterr().out
    summary = json.loads((tmp_path / "out" / "run-summary.json").read_text())
    assert summary["total_failures"] == 1
    assert summary["failures"][0]["file"] == "corrupt-run-1-b.cihx"
    assert summary["total_files"] == 1
    # The good recording's table was written.
    assert (tmp_path / "out" / "good-run-1-a-flame-position.txt").exists()


def test_odd_width_12bit_matches_exact(tmp_path):
    """Odd-width 12-bit payloads are byte-aligned per FRAME but not per row:
    the band path (host-side byte row gather) gates off, but full-frame
    packed staging stays on via the flat-stream decode — and the whole
    pipeline must still match the exact float64 host backend."""
    flame = FlameSpec(x0=25.0, v0_px=9.0, ignition_frame=2, seed=11)
    frames, _ = synthesize_flame_video(30, height=48, width=255, flame=flame)
    meta = write_recording(tmp_path, "odd-run-1-a", frames,
                           spec=CihxSpec(width=255, height=48, total_frames=30,
                                         record_rate=50_000, bit_depth=12))
    from hsip_tpu import open_video

    with open_video(str(meta)) as video:
        assert video.supports_packed_frames
        assert not video.supports_packed_band
        np.testing.assert_array_equal(video[0], frames[0])  # exact round-trip
    cfg = VideoSourceConfig(name="T", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.output_dir = str(tmp_path / "out")
    out = process_video_file(meta, cfg, backend="tpu", verbose=False,
                             write_outputs=False)
    out_e = process_video_file(meta, cfg, backend="exact", verbose=False,
                               write_outputs=False)
    assert len(out.rows) > 5
    assert [r[:3] for r in out.rows] == [r[:3] for r in out_e.rows]
    assert out.break_reason == out_e.break_reason


def test_ten_bit_band_path_matches_exact(tmp_path):
    """10-bit packed recordings use the same minimal-transfer band path as
    12-bit (device unpack + C++ host counts) and must match the exact
    float64 backend."""
    from hsip_tpu import open_video

    frames, _ = synthesize_flame_video(
        30, height=48, width=384,
        flame=FlameSpec(x0=30, v0_px=8, ignition_frame=2,
                        flame_level=900, background_level=20, seed=4),
    )
    frames = np.clip(frames, 0, 1023)
    meta = write_recording(
        tmp_path, "ten-run-1-a", frames,
        spec=CihxSpec(width=384, height=48, total_frames=30,
                      record_rate=50_000, bit_depth=10),
    )
    with open_video(str(meta)) as v:
        # Band path availability depends on the native codec being built.
        if not v.supports_packed_band:
            pytest.skip("native codec unavailable")
    cfg = VideoSourceConfig(name="T", save_frame_images=False,
                            save_stacked_sequences=False)
    t = process_video_file(meta, cfg, backend="tpu", verbose=False,
                           write_outputs=False)
    e = process_video_file(meta, cfg, backend="exact", verbose=False,
                           write_outputs=False)
    assert len(t.rows) > 10
    assert [r[:3] for r in t.rows] == [r[:3] for r in e.rows]
    assert t.break_reason == e.break_reason


def test_sixteen_bit_band_path_matches_exact(tmp_path):
    """16-bit containers also ride the minimal-transfer band path."""
    from hsip_tpu import open_video

    frames, _ = synthesize_flame_video(
        30, height=48, width=384,
        flame=FlameSpec(x0=30, v0_px=8, ignition_frame=2, seed=6),
    )
    meta = write_recording(
        tmp_path, "sixteen-run-1-a", frames,
        spec=CihxSpec(width=384, height=48, total_frames=30,
                      record_rate=50_000, bit_depth=16),
    )
    with open_video(str(meta)) as v:
        if not v.supports_packed_band:
            pytest.skip("native codec unavailable")
        assert v.count_above(0, 3, 100.0, 50.0) is not None
    cfg = VideoSourceConfig(name="S", save_frame_images=False,
                            save_stacked_sequences=False)
    t = process_video_file(meta, cfg, backend="tpu", verbose=False,
                           write_outputs=False)
    e = process_video_file(meta, cfg, backend="exact", verbose=False,
                           write_outputs=False)
    assert len(t.rows) > 10
    assert [r[:3] for r in t.rows] == [r[:3] for r in e.rows]


@pytest.mark.parametrize("seed", [0, 1])
def test_tpu_matches_exact_random_configs(recording, tmp_path, seed):
    """Device band path == exact backend across randomized detector configs
    (odd kernels stay on the band path; even-k folding uses the fallback)."""
    rng = np.random.default_rng(seed)
    det = FlameDetectorConfig(
        frame_diff_threshold=float(rng.uniform(2.0, 10.0)),
        morphology_kernel_size=int(rng.choice([2, 3, 5])),
        gaussian_sigma=float(rng.uniform(1.0, 2.2)),
        min_gradient_strength=float(rng.uniform(5.0, 15.0)),
        search_window_px=int(rng.integers(60, 140)),
    )
    cfg = _source_config(recording, tmp_path / f"rc{seed}")
    t = process_video_file(recording["path"], cfg, det, backend="tpu",
                           verbose=False, write_outputs=False)
    e = process_video_file(recording["path"], cfg, det, backend="exact",
                           verbose=False, write_outputs=False)
    assert [r[:3] for r in t.rows] == [r[:3] for r in e.rows], det
    assert t.break_reason == e.break_reason


def test_pipeline_without_native_codec(recording, tmp_path, monkeypatch):
    """With no C++ codec (no toolchain), the pipeline falls back to numpy
    decode + full-packed device staging and still matches exact."""
    import hsip_tpu._native as native

    def no_native():
        raise RuntimeError("simulated: toolchain unavailable")

    monkeypatch.setattr(native, "native_decoder", no_native)
    from hsip_tpu import open_video

    with open_video(str(recording["path"])) as v:
        assert not v.supports_packed_band  # band fast path off
    cfg = _source_config(recording, tmp_path / "nonative")
    t = process_video_file(recording["path"], cfg, backend="tpu",
                           verbose=False, write_outputs=False)
    e = process_video_file(recording["path"], cfg, backend="exact",
                           verbose=False, write_outputs=False)
    assert [r[:3] for r in t.rows] == [r[:3] for r in e.rows]
    assert t.break_reason == e.break_reason


@pytest.fixture()
def library_dir(tmp_path):
    """Mixed-shape multi-recording library (two shape groups + one DDT)."""
    d = tmp_path / "library"
    for stem, (h, w), flame in (
        ("nova-run-1-001", (48, 512),
         FlameSpec(x0=30.0, v0_px=8.0, ignition_frame=2, seed=3)),
        ("nova-run-1-002", (48, 512),
         FlameSpec(x0=22.0, v0_px=5.0, ddt_frame=25, v_jump_px=24.0,
                   ignition_frame=3, seed=5)),
        ("mini-run-2-001", (64, 384),
         FlameSpec(x0=28.0, v0_px=7.0, ignition_frame=4, seed=8)),
    ):
        frames, _ = synthesize_flame_video(48, height=h, width=w, flame=flame)
        write_recording(
            d, stem, frames,
            spec=CihxSpec(width=w, height=h, total_frames=48,
                          record_rate=100_000, bit_depth=12),
        )
    return d


def _library_source(library_dir, out):
    cfg = VideoSourceConfig(
        name="Lib", enabled=True,
        save_frame_images=False, save_stacked_sequences=False,
    )
    cfg.video_path = str(library_dir)
    cfg.output_dir = str(out)
    cfg.file_calibrations = [
        FileCalibration(calibration=0.000833333, position_offset=1.0159,
                        files=["nova-"]),
        FileCalibration(calibration=0.000869565, position_offset=0.050237,
                        files=["mini-"]),
    ]
    return cfg


def test_library_mode_tables_match_per_file_device(library_dir, tmp_path):
    """process_video_source_library == per-file backend='device', byte-wise."""
    from hsip_tpu.pipeline import (
        process_video_source,
        process_video_source_library,
    )

    out_lib = tmp_path / "lib-out"
    out_dev = tmp_path / "dev-out"
    outs = process_video_source_library(
        _library_source(library_dir, out_lib), verbose=False
    )
    process_video_source(
        _library_source(library_dir, out_dev), backend="device", verbose=False
    )
    assert len(outs) == 3
    lib_tables = {p.name: p.read_bytes() for p in sorted(out_lib.glob("*.txt"))}
    dev_tables = {p.name: p.read_bytes() for p in sorted(out_dev.glob("*.txt"))}
    assert set(lib_tables) == set(dev_tables) and lib_tables
    for name in lib_tables:
        assert lib_tables[name] == dev_tables[name], name
    # The DDT recording must have split (guards against a vacuous pass).
    assert any("post-DDT" in n for n in lib_tables)
    # Run summary covers every recording.
    import json

    summary = json.loads((out_lib / "run-summary.json").read_text())
    assert len(summary["files"]) == 3


def test_library_mode_resume_skips_completed(library_dir, tmp_path, capsys):
    from hsip_tpu.pipeline import process_video_source_library

    out = tmp_path / "out"
    cfg = _library_source(library_dir, out)
    process_video_source_library(cfg, verbose=False)
    outs = process_video_source_library(cfg, verbose=True, resume=True)
    assert outs == []  # everything checkpoint-skipped
    assert "already complete" in capsys.readouterr().out


def test_library_mode_skips_corrupt_recording(library_dir, tmp_path, capsys):
    from hsip_tpu.pipeline import process_video_source_library

    (library_dir / "broken.cihx").write_bytes(b"\x00 not a header" * 32)
    out = tmp_path / "out"
    outs = process_video_source_library(
        _library_source(library_dir, out), verbose=False
    )
    assert len(outs) == 3  # the three good recordings still tracked
    assert "Could not load" in capsys.readouterr().out
    import json

    summary = json.loads((out / "run-summary.json").read_text())
    assert [f["file"] for f in summary["failures"]] == ["broken.cihx"]


def test_library_mode_warns_on_unmatched_calibration(library_dir, tmp_path,
                                                     capsys):
    """A file_calibrations list that matches nothing must warn, not stay
    silent (wrong-units guard, same contract as the per-file driver)."""
    from hsip_tpu.pipeline import process_video_source_library

    cfg = _library_source(library_dir, tmp_path / "out")
    cfg.file_calibrations = [
        FileCalibration(calibration=0.5, position_offset=0.0,
                        files=["9000:9999"]),
    ]
    process_video_source_library(cfg, verbose=False)
    out = capsys.readouterr().out
    assert out.count("no file_calibration entry matches") == 3


def test_exact_backend_prints_progress_every_50_frames(tmp_path, capsys):
    """Reference parity: per-50-frame progress prints (:1524-1527)."""
    frames, _ = synthesize_flame_video(
        120, height=32, width=640,
        flame=FlameSpec(x0=20.0, v0_px=3.0, ignition_frame=2, seed=21),
    )
    meta = write_recording(tmp_path, "prog-run-1-001", frames)
    cfg = VideoSourceConfig(name="P", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.output_dir = str(tmp_path / "out")
    process_video_file(meta, cfg, backend="exact", verbose=True,
                       write_outputs=False)
    out = capsys.readouterr().out
    assert "Processed 50/120 frames" in out
    assert "Processed 100/120 frames" in out


def test_map_phase_progress_callback(recording):
    """compute_profiles_batched reports staged/total after each chunk."""
    from hsip_tpu import open_video
    from hsip_tpu.track import FlameDetectorConfig
    from hsip_tpu.track.scan import track_video

    seen = []
    with open_video(str(recording["path"])) as video:
        track_video(
            video, FlameDetectorConfig(), calibration_m_per_px=0.001,
            chunk_size=16, progress=lambda a, b: seen.append((a, b)),
        )
        n = len(video)
    assert seen, "progress callback never fired"
    assert seen[-1][0] == seen[-1][1] == n
    assert [a for a, _ in seen] == sorted(a for a, _ in seen)


def test_long_skip_gap_reads_stay_bounded(tmp_path):
    """A skip list covering a long interior range must not decode or stage
    the skipped frames (bounded batch contract): every read spans only
    contiguous PROCESSED frames, and rows match the exact backend."""
    from hsip_tpu import open_video
    from hsip_tpu.track import FlameDetectorConfig
    from hsip_tpu.track.scan import track_video

    n = 400
    frames, _ = synthesize_flame_video(
        n, height=32, width=256,
        flame=FlameSpec(x0=20.0, v0_px=0.4, ignition_frame=2, seed=31),
    )
    meta = write_recording(tmp_path, "gap-run-1-001", frames)
    skip = list(range(40, 360))  # 320-frame interior gap

    spans = []
    with open_video(str(meta)) as video:
        orig_band = video.band_bytes
        orig_fused = video.band_bytes_and_counts
        orig_batch = video.read_batch

        def spy_band(a, b, rows):
            spans.append(b - a)
            return orig_band(a, b, rows)

        def spy_fused(a, b, rows, bg, thr, out=None):
            spans.append(b - a)
            return orig_fused(a, b, rows, bg, thr, out=out)

        def spy_batch(a, b):
            spans.append(b - a)
            return orig_batch(a, b)

        video.band_bytes = spy_band
        video.band_bytes_and_counts = spy_fused
        video.read_batch = spy_batch
        out = track_video(video, FlameDetectorConfig(), 0.001,
                          skip_frames=skip, chunk_size=32)
        video.band_bytes = orig_band
        video.band_bytes_and_counts = orig_fused
        video.read_batch = orig_batch
        exact = track_video(video, FlameDetectorConfig(), 0.001,
                            skip_frames=skip, chunk_size=32)
    assert out.rows == exact.rows
    assert spans and max(spans) <= 40, (
        f"a read spanned {max(spans)} frames across the skip gap"
    )


def test_library_mode_survives_per_video_write_failure(library_dir, tmp_path,
                                                       capsys, monkeypatch):
    """One recording's table-write failure must not lose the others' tables,
    and the run summary must still be written (rank-barrier safety)."""
    import hsip_tpu.pipeline as pipeline_mod
    from hsip_tpu.pipeline import process_video_source_library

    real_writer = pipeline_mod._write_ddt_split_tables
    calls = []

    def flaky(output, output_dir, stem, verbose=True):
        calls.append(stem)
        if stem == "nova-run-1-001":
            raise OSError("disk quota exceeded")
        return real_writer(output, output_dir, stem, verbose)

    monkeypatch.setattr(pipeline_mod, "_write_ddt_split_tables", flaky)
    out = tmp_path / "out"
    outs = process_video_source_library(
        _library_source(library_dir, out), verbose=False
    )
    assert len(outs) == 3  # all scans completed
    assert "Could not write results for nova-run-1-001" in capsys.readouterr().out
    # The other two recordings' tables landed.
    assert (out / "mini-run-2-001-flame-position.txt").exists()
    assert (out / "nova-run-1-002-flame-position.txt").exists()
    assert not (out / "nova-run-1-001-flame-position.txt").exists()
    import json as _json

    summary = _json.loads((out / "run-summary.json").read_text())
    assert [f["file"] for f in summary["failures"]] == ["nova-run-1-001.cihx"]
    assert len(summary["files"]) == 2


def test_eight_bit_band_path_matches_exact(tmp_path):
    """8-bit containers ride the minimal-transfer band path too: the bytes
    are the pixels, the native count pass screens empty frames, and the
    tracked output matches the exact float64 backend."""
    from hsip_tpu import open_video

    frames, _ = synthesize_flame_video(
        30, height=48, width=384,
        flame=FlameSpec(x0=30, v0_px=8, ignition_frame=2, flame_level=220,
                        background_level=8, seed=3),
    )
    frames = np.clip(frames, 0, 255)
    meta = write_recording(
        tmp_path, "eight-run-1-a", frames,
        spec=CihxSpec(width=384, height=48, total_frames=30,
                      record_rate=50_000, bit_depth=8),
    )
    with open_video(str(meta)) as v:
        assert v.supports_packed_frames
        np.testing.assert_array_equal(v[0], frames[0])
        if not v.supports_packed_band:
            pytest.skip("native codec unavailable")
        counts = v.count_above(0, 3, 10.0, 5.0)
        dec = v.read_batch(0, 3).astype(np.float64)
        ref = (np.maximum(dec - 10.0, 0.0) > 5.0).sum(axis=(1, 2))
        np.testing.assert_array_equal(counts, ref.astype(np.int32))
    cfg = VideoSourceConfig(name="E8", save_frame_images=False,
                            save_stacked_sequences=False)
    t = process_video_file(meta, cfg, backend="tpu", verbose=False,
                           write_outputs=False)
    e = process_video_file(meta, cfg, backend="exact", verbose=False,
                           write_outputs=False)
    assert len(t.rows) > 10
    assert [r[:3] for r in t.rows] == [r[:3] for r in e.rows]
    assert t.break_reason == e.break_reason


def test_resume_distinguishes_same_stem_in_subdirs(tmp_path):
    """Discovery is recursive, so two recordings may share a basename in
    different subdirectories. The resume ledger must key on the
    video_path-relative path: keyed by basename, a resumed run would skip
    the sibling as already done (a fresh run processes both)."""
    src = tmp_path / "videos"
    out = tmp_path / "out"
    spec = CihxSpec(width=256, height=32, total_frames=24,
                    record_rate=50_000, bit_depth=12)
    frames_a, _ = synthesize_flame_video(
        24, height=32, width=256,
        flame=FlameSpec(x0=20.0, v0_px=4.0, ignition_frame=2, seed=31))
    write_recording(src / "session-A", "dup-run-1-001", frames_a, spec=spec)

    cfg = VideoSourceConfig(name="dup", enabled=True, calibration=0.0008,
                            save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.video_path = str(src)
    cfg.output_dir = str(out)
    process_video_source(cfg, backend="tpu", verbose=False)
    table = out / "dup-run-1-001-flame-position.txt"
    first = table.read_bytes()

    # A same-stem sibling lands later (e.g. the run crashed before its
    # session was recorded); the resumed run must process it.
    frames_b, _ = synthesize_flame_video(
        24, height=32, width=256,
        flame=FlameSpec(x0=40.0, v0_px=7.0, ignition_frame=2, seed=37))
    write_recording(src / "session-B", "dup-run-1-001", frames_b, spec=spec)
    process_video_source(cfg, backend="tpu", verbose=False, resume=True)
    second = table.read_bytes()
    assert second != first, (
        "resume skipped session-B/dup-run-1-001 — the ledger aliased two "
        "recordings that share a basename"
    )
