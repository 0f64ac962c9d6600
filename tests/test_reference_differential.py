"""Differential test: run the ACTUAL reference implementation side by side.

Opt-in tier (``HSIP_REFERENCE=1``): loads the read-only reference checkout
(``/root/reference``, overridable via ``HSIP_REFERENCE_ROOT``), satisfies its
one missing dependency with a tiny in-memory ``pyMRAW`` shim backed by this
framework's MRAW reader, runs the reference's own
``process_video_source`` (``scripts/process_videos.py:1277``) on synthetic
recordings, and byte-compares its ``*-flame-position*.txt`` tables against
this framework's — for BOTH tracking backends ('tpu' host float64 scan and
'device' on-device lax.scan).

This is the strongest parity evidence in the suite: every other correctness
test anchors on a re-implemented scipy oracle; this one anchors on the
reference code itself. It exercises per-file calibration range matching,
skip_frames, empty-frame skipping, DDT pre/post table splitting, the
velocity merge, and domain-exit truncation end to end.

Figure rendering is neutralized on both sides (tables only): the reference
renders a 12-panel matplotlib figure per frame unconditionally
(``process_videos.py:1474``), which is orthogonal to the tracked outputs.
No reference code is copied — the module is loaded from its own checkout.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
from hsip_tpu.testing import load_reference_module, reference_script

pytestmark = pytest.mark.skipif(
    os.environ.get("HSIP_REFERENCE") != "1" or not reference_script().exists(),
    reason="opt-in differential tier: set HSIP_REFERENCE=1 (needs the "
    "reference checkout and scipy/matplotlib)",
)


@pytest.fixture(scope="module")
def ref():
    """The reference ``scripts/process_videos.py`` as an imported module.

    Tables-only comparison: figures are neutralized (they dominate
    reference runtime and never feed back into positions/velocities/DDT).
    """
    return load_reference_module()


# Four trajectories: plain propagation that exits the domain, a DDT jump
# (pre/post split + velocity merge), late ignition (empty-frame skips), and
# a sudden slowdown (8 -> 1 px/frame with a sharp 1 px edge: v1 drops
# 400 -> 100 m/s = 75% on the default calibration, hitting the
# velocity-drop break + the retroactive central-difference invalidation,
# reference process_videos.py:1496-1509, without latching DDT since the
# jump is negative; a softer 2 px edge smears the transition across frames
# and never exceeds the 50% single-step threshold).
_SCENARIOS = {
    "nova-run-1-005": FlameSpec(
        x0=25.0, v0_px=9.0, accel_px=0.05, ignition_frame=2, seed=7
    ),
    "nova-run-2-014": FlameSpec(
        x0=20.0, v0_px=4.0, ddt_frame=22, v_jump_px=22.0, ignition_frame=3, seed=11
    ),
    "nova-run-3-021": FlameSpec(
        x0=30.0, v0_px=6.0, ignition_frame=12, seed=13
    ),
    "nova-run-5-033": FlameSpec(
        x0=22.0, v0_px=8.0, ddt_frame=26, v_jump_px=-7.0, ignition_frame=2,
        edge_width_px=1.0, seed=19,
    ),
}
_N_FRAMES = 48
_HEIGHT, _WIDTH = 64, 384


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("refdiff-videos")
    spec = CihxSpec(
        width=_WIDTH, height=_HEIGHT, total_frames=_N_FRAMES,
        record_rate=100_000, bit_depth=12,
    )
    for stem, flame in _SCENARIOS.items():
        frames, _ = synthesize_flame_video(
            _N_FRAMES, height=_HEIGHT, width=_WIDTH, flame=flame
        )
        write_recording(d, stem, frames, spec=spec)
    # One 8-bit container: its packed bytes ARE the pixels, exercising
    # the 8-bit decode rung on both sides of the differential.
    frames8, _ = synthesize_flame_video(
        _N_FRAMES, height=_HEIGHT, width=_WIDTH,
        flame=FlameSpec(x0=28.0, v0_px=7.0, ignition_frame=2,
                        flame_level=230, background_level=8, seed=17),
    )
    write_recording(
        d, "nova-run-4-050", np.clip(frames8, 0, 255),
        spec=CihxSpec(width=_WIDTH, height=_HEIGHT, total_frames=_N_FRAMES,
                      record_rate=100_000, bit_depth=8),
    )
    # ... and one 10-bit container (5 bytes -> 4 pixels) so the remaining
    # packed decode rung is differentially exercised through the pipeline.
    frames10, _ = synthesize_flame_video(
        _N_FRAMES, height=_HEIGHT, width=_WIDTH,
        flame=FlameSpec(x0=26.0, v0_px=7.5, ignition_frame=2,
                        flame_level=900, seed=23),
    )
    write_recording(
        d, "nova-run-6-044", np.clip(frames10, 0, 1023),
        spec=CihxSpec(width=_WIDTH, height=_HEIGHT, total_frames=_N_FRAMES,
                      record_rate=100_000, bit_depth=10),
    )
    # One recording nested in a subdirectory: discovery is a RECURSIVE
    # glob on both sides (reference process_videos.py:1299-1308 rglobs
    # "*.cihx"), so session-style folder layouts must be found and their
    # tables land in the same flat output directory.
    frames7, _ = synthesize_flame_video(
        _N_FRAMES, height=_HEIGHT, width=_WIDTH,
        flame=FlameSpec(x0=24.0, v0_px=6.5, ignition_frame=4, seed=29),
    )
    write_recording(
        d / "session-A", "nova-run-7-101", frames7, spec=spec
    )
    return d


def _file_calibrations(mod):
    """Same rules both sides; exercises exact + 'A:B' range matching."""
    return [
        mod.FileCalibration(
            calibration=0.000833333, position_offset=1.0159,
            files=["run-1"],
        ),
        mod.FileCalibration(
            calibration=0.000869565, position_offset=1.197565,
            files=["010:030"],  # matches the last integer in the name
        ),
    ]


def _run_reference(ref, video_dir: Path, out_dir: Path, **overrides) -> None:
    config = ref.VideoSourceConfig(
        name="diff",
        enabled=True,
        calibration=0.0005,
        position_offset=0.25,
        skip_frames=[5],
        file_calibrations=_file_calibrations(ref),
        **overrides,
    )
    config.video_path = str(video_dir)   # absolute: setter passes through
    config.output_dir = str(out_dir)
    ref.process_video_source(config, processor=None)


def _run_ours(video_dir: Path, out_dir: Path, backend: str, **overrides) -> None:
    import hsip_tpu.track.config as cfg
    from hsip_tpu.pipeline import process_video_source

    config = cfg.VideoSourceConfig(
        name="diff",
        enabled=True,
        calibration=0.0005,
        position_offset=0.25,
        skip_frames=[5],
        file_calibrations=_file_calibrations(cfg),
        save_frame_images=False,
        save_stacked_sequences=False,
        **overrides,
    )
    config.video_path = str(video_dir)
    config.output_dir = str(out_dir)
    process_video_source(config, backend=backend, verbose=False)


def _tables(out_dir: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(out_dir.glob("*.txt"))}


@pytest.fixture(scope="module")
def reference_tables(ref, video_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("refdiff-ref-out")
    _run_reference(ref, video_dir, out)
    tables = _tables(out)
    assert len(tables) >= len(_SCENARIOS), "reference produced no tables"
    # The DDT scenario must actually split, or the test is vacuous.
    assert any("post-DDT" in name for name in tables), (
        "expected a post-DDT table from the DDT scenario"
    )
    # ... and the main tables must carry real tracked rows with velocities
    # (incl. the 8/10-bit containers, so their byte-identity isn't vacuous).
    for stem in list(_SCENARIOS) + [
        "nova-run-4-050", "nova-run-6-044", "nova-run-7-101"
    ]:
        rows = [
            line
            for line in tables[f"{stem}-flame-position.txt"].decode().splitlines()
            if line and not line.startswith("#")
        ]
        assert len(rows) > 10, f"{stem}: too few tracked rows ({len(rows)})"
        assert any(len(r.split()) == 7 for r in rows), (
            f"{stem}: no row carries all three velocity columns"
        )
    # The slowdown scenario must actually hit the velocity-drop break, or
    # its anchor is vacuous: its last recorded frame stays well short of
    # the recording end (the exit margin is never reached at ~220 px).
    rows5 = [
        line
        for line in tables["nova-run-5-033-flame-position.txt"]
        .decode()
        .splitlines()
        if line and not line.startswith("#")
    ]
    assert int(rows5[-1].split()[0]) < _N_FRAMES - 10, (
        "expected the velocity-drop break to truncate nova-run-5-033"
    )
    return tables


@pytest.mark.parametrize("backend", ["tpu", "device", "exact"])
def test_tables_byte_identical_to_reference(
    reference_tables, video_dir, tmp_path, backend
):
    ours_dir = tmp_path / f"ours-{backend}"
    _run_ours(video_dir, ours_dir, backend)
    ours = _tables(ours_dir)
    assert set(ours) == set(reference_tables)
    for name in sorted(reference_tables):
        assert ours[name] == reference_tables[name], (
            f"{name} differs from the reference output (backend={backend})"
        )


def test_tables_byte_identical_via_pallas_kernel(
    reference_tables, video_dir, tmp_path, monkeypatch
):
    """Strongest kernel evidence: the single-kernel Pallas scan (interpret
    mode here; the same code Triton compiles on the GPU) reproduces the
    ACTUAL reference's result tables byte for byte."""
    import hsip_tpu.track.pallas_scan as ps

    monkeypatch.setattr(ps, "INTERPRET", True)
    ours_dir = tmp_path / "ours-pallas"
    _run_ours(video_dir, ours_dir, "device")
    ours = _tables(ours_dir)
    assert set(ours) == set(reference_tables)
    for name in sorted(reference_tables):
        assert ours[name] == reference_tables[name], (
            f"{name} differs from the reference output (pallas kernel)"
        )


def test_trigger_relative_time_matches_reference(ref, video_dir, tmp_path):
    """``use_absolute_time=False`` with an explicit trigger frame switches
    the Time_s column to trigger-relative values (negative before the
    trigger, reference video.py:211-220) — a branch the main corpus never
    takes since the reference defaults to absolute PFV4 time."""
    ref_out = tmp_path / "ref-trig"
    _run_reference(
        ref, video_dir, ref_out, use_absolute_time=False, trigger_frame=9
    )
    reference_tables = _tables(ref_out)
    assert len(reference_tables) >= len(_SCENARIOS)
    # Vacuity guard: pre-trigger rows must really carry negative times.
    sample = reference_tables["nova-run-1-005-flame-position.txt"].decode()
    assert any(
        line.split()[1].startswith("-")
        for line in sample.splitlines()
        if line and not line.startswith("#")
    ), "expected negative trigger-relative times before the trigger frame"

    ours_dir = tmp_path / "ours-trig"
    _run_ours(
        video_dir, ours_dir, "device",
        use_absolute_time=False, trigger_frame=9,
    )
    ours = _tables(ours_dir)
    assert set(ours) == set(reference_tables)
    for name in sorted(reference_tables):
        assert ours[name] == reference_tables[name], (
            f"{name} differs from the reference output (trigger-relative)"
        )
