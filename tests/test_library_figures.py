"""Library-mode figures: data-identical to per-file mode.

The batched library scan dead-code-eliminates the per-frame detector
internals a diagnostic figure draws, so library mode replays the per-file
figure path per requesting recording (`process_video_source_library`
docstring). These tests pin that the figures actually appear AND are
byte-identical to what per-file mode writes for the same recordings —
the strongest form of the "data-identical" contract.
"""

from __future__ import annotations

import numpy as np
import pytest

from hsip_tpu.io import (
    CihxSpec,
    FlameSpec,
    synthesize_flame_video,
    write_recording,
)
from hsip_tpu.track import VideoSourceConfig
from hsip_tpu.track.config import FileCalibration


@pytest.fixture(scope="module")
def fig_library(tmp_path_factory):
    d = tmp_path_factory.mktemp("fig-lib")
    for i, seed in enumerate((11, 13)):
        frames, _ = synthesize_flame_video(
            10, height=32, width=192,
            flame=FlameSpec(x0=20, v0_px=8, ignition_frame=2, seed=seed),
        )
        write_recording(
            d, f"figlib-run-{i + 1}-001", frames,
            spec=CihxSpec(width=192, height=32, total_frames=10,
                          record_rate=50_000),
        )
    return d


def _source(library_dir, out, **kw):
    cfg = VideoSourceConfig(
        name="FigLib", enabled=True, figure_style="compact", **kw,
    )
    cfg.video_path = str(library_dir)
    cfg.output_dir = str(out)
    cfg.file_calibrations = [
        FileCalibration(calibration=0.000833333, position_offset=1.0159,
                        files=["figlib-"]),
    ]
    return cfg


def test_library_figures_match_per_file_bytes(fig_library, tmp_path):
    from hsip_tpu.pipeline import (
        process_video_source,
        process_video_source_library,
    )

    out_lib = tmp_path / "lib"
    out_pf = tmp_path / "pf"
    outs = process_video_source_library(
        _source(fig_library, out_lib, save_frame_images=True,
                save_stacked_sequences=True),
        verbose=False,
    )
    assert len(outs) == 2
    process_video_source(
        _source(fig_library, out_pf, save_frame_images=True,
                save_stacked_sequences=True),
        backend="tpu", verbose=False,
    )

    lib_pngs = {p.relative_to(out_lib): p for p in sorted(out_lib.rglob("*.png"))}
    pf_pngs = {p.relative_to(out_pf): p for p in sorted(out_pf.rglob("*.png"))}
    assert lib_pngs, "library mode wrote no figures"
    assert set(lib_pngs) == set(pf_pngs)
    # Per-frame 12-panel/compact figures AND stacked sequences, per video.
    names = {p.name for p in lib_pngs}
    assert any("stacked-sequence" in n for n in names)
    assert any("Frame" in n for n in names)
    for rel in lib_pngs:
        assert lib_pngs[rel].read_bytes() == pf_pngs[rel].read_bytes(), rel
    # Tables come from the batched scan and must still match per-file.
    lib_tables = {p.name: p.read_bytes() for p in out_lib.glob("*.txt")}
    pf_tables = {p.name: p.read_bytes() for p in out_pf.glob("*.txt")}
    assert lib_tables and lib_tables == pf_tables


def test_device_backend_figures_match_tpu_bytes(fig_library, tmp_path):
    """backend='device' must render figures too:
    the on-device scan has no per-frame hook, so a host-scan replay
    collects them — byte-identical to backend='tpu', like the reference's
    always-available 12-panel diagnostics (process_videos.py:1474-1480)."""
    from hsip_tpu.pipeline import process_video_source

    out_dev = tmp_path / "dev"
    out_tpu = tmp_path / "tpu"
    process_video_source(
        _source(fig_library, out_dev, save_frame_images=True,
                save_stacked_sequences=True),
        backend="device", verbose=False,
    )
    process_video_source(
        _source(fig_library, out_tpu, save_frame_images=True,
                save_stacked_sequences=True),
        backend="tpu", verbose=False,
    )
    dev_pngs = {p.relative_to(out_dev): p
                for p in sorted(out_dev.rglob("*.png"))}
    tpu_pngs = {p.relative_to(out_tpu): p
                for p in sorted(out_tpu.rglob("*.png"))}
    assert dev_pngs, "backend='device' wrote no figures"
    assert set(dev_pngs) == set(tpu_pngs)
    assert any("Frame" in p.name for p in dev_pngs)  # per-frame diagnostics
    for rel in dev_pngs:
        assert dev_pngs[rel].read_bytes() == tpu_pngs[rel].read_bytes(), rel
    # Tables from the device scan match the host-scan ones byte-for-byte.
    dev_tables = {p.name: p.read_bytes() for p in out_dev.glob("*.txt")}
    tpu_tables = {p.name: p.read_bytes() for p in out_tpu.glob("*.txt")}
    assert dev_tables and dev_tables == tpu_tables


def test_library_figures_off_writes_no_pngs(fig_library, tmp_path):
    from hsip_tpu.pipeline import process_video_source_library

    out = tmp_path / "nofig"
    process_video_source_library(
        _source(fig_library, out, save_frame_images=False,
                save_stacked_sequences=False),
        verbose=False,
    )
    assert not list(out.rglob("*.png"))
    assert list(out.glob("*.txt"))  # tables still written
