"""Visualization tests: structural figure checks + render smoke.

Structural assertions (panel count, titles, marker positions) run here on
every suite pass; panel-for-panel parity against the ACTUAL reference
figures is the opt-in HSIP_REFERENCE=1 tier
(test_reference_viz_differential.py).
"""

from pathlib import Path

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")

from hsip_tpu import open_video  # noqa: E402
from hsip_tpu.io import FlameSpec, synthesize_flame_video, write_recording  # noqa: E402
from hsip_tpu.track import FlameDetector, FlameDetectorConfig  # noqa: E402
from hsip_tpu import viz  # noqa: E402


@pytest.fixture(scope="module")
def video_on_disk(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viz")
    frames, _ = synthesize_flame_video(
        12, height=32, width=192,
        flame=FlameSpec(x0=30, v0_px=8, ignition_frame=1, seed=4),
    )
    meta = write_recording(tmp, "viz-run-1", frames)
    return meta, tmp


_PANEL_TITLE_STARTS = [
    "1. BG Subtracted - Frame",
    "2. Frame Diff (current - prior)",
    "3. Noise Removed (morphological opening)",
    "4. Gaussian Blur",
    "5. Sobel Filter (horizontal)",
    "6. Gradient Filter (np.gradient)",
    "7. Frame Diff Centerline",
    "8. Sobel Centerline",
    "9. Gradient Centerline (min = leading edge)",
    "10. Result:",
    "11. Position History + Spline Estimator",
    "12. Velocity Comparison",
]


def _axvline_xs(ax):
    xs = []
    for line in ax.lines:
        xd = np.asarray(line.get_xdata(), dtype=float)
        if xd.size == 2 and xd[0] == xd[1]:
            xs.append(float(xd[0]))
    return xs


def test_save_frame_image_full(video_on_disk, tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    meta, _ = video_on_disk
    with open_video(str(meta)) as video:
        det = FlameDetector(FlameDetectorConfig(), video.frame_rate, 0.001)
        bg = float(np.max(video[0]))
        result = None
        for i in range(6):
            result = det.detect(video[i], i, bg)

        # Capture the figure object for structural checks, then render.
        # (The real close runs AFTER the assertions — closing first can
        # tear down artists.)
        captured = []
        orig_close = plt.close
        monkeypatch.setattr(plt, "close",
                            lambda fig=None: captured.append(fig))
        out = viz.save_frame_image(video[5], result, tmp_path, "Test", det)
        monkeypatch.setattr(plt, "close", orig_close)

        assert out.exists() and out.stat().st_size > 50_000
        assert out.name == "Test-Frame-000005.png"

        # Structure: 12 panels with the reference's titles, and the
        # detection markers at the detector's actual positions.
        fig = captured[-1]
        assert len(fig.axes) == 12
        for ax, start in zip(fig.axes, _PANEL_TITLE_STARTS):
            assert ax.get_title().startswith(start), ax.get_title()
        assert result.final_position is not None
        for panel in (6, 7, 8):  # the three centerline panels
            xs = _axvline_xs(fig.axes[panel])
            assert float(result.final_position) in xs
            assert float(result.search_bounds[0]) in xs
        if result.pos_min_gradient is not None:
            assert float(result.pos_min_gradient) in _axvline_xs(fig.axes[8])
        if result.pos_rightmost_sobel is not None:
            assert float(result.pos_rightmost_sobel) in _axvline_xs(fig.axes[7])
        # Result overlay (panel 10): candidates are POINT markers on the
        # centerline, search bounds are vlines.
        overlay = fig.axes[9]
        assert float(result.search_bounds[0]) in _axvline_xs(overlay)
        marker_pts = [
            (float(np.asarray(l.get_xdata())[0]), float(np.asarray(l.get_ydata())[0]))
            for l in overlay.lines
            if len(np.asarray(l.get_xdata())) == 1
        ]
        assert (float(result.final_position), float(video.height // 2)) in marker_pts
        for f in captured:
            orig_close(f)


def test_save_frame_image_from_band_result(video_on_disk, tmp_path):
    """Band-path results carry no images; intermediates are recomputed."""
    meta, _ = video_on_disk
    from hsip_tpu.track.config import FlameDetectionResult
    from hsip_tpu.track.tracker import FlameTracker

    with open_video(str(meta)) as video:
        tracker = FlameTracker(FlameDetectorConfig(), video.frame_rate, 0.001)
        # Fabricate a minimal band-path result for frame 5 (no images).
        result = FlameDetectionResult(
            frame_idx=5, time_s=5e-4, final_position=70,
            search_bounds=(10, 182),
        )
        tracker._position_history = [(4, 62), (5, 70)]
        out = viz.save_frame_image_from_video(
            video, result, tracker, float(np.max(video[0])),
            tmp_path, "Band", FlameDetectorConfig(),
        )
        assert out.exists() and out.stat().st_size > 50_000
        # Intermediates were reconstructed on the result in place.
        assert result.frame_subtracted is not None
        assert result.frame_diff is not None
        assert result.sobel_output is not None


def test_stacked_sequences(video_on_disk, tmp_path):
    meta, _ = video_on_disk
    with open_video(str(meta)) as video:
        bg = float(np.max(video[0]))
        two_col = viz.generate_stacked_sequence(
            video, [0, 3, 6, 9], bg, tmp_path / "stack2.png", title="T"
        )
        one_col = viz.generate_stacked_sequence_single_column(
            video, [0, 3, 6, 9], bg, tmp_path / "stack1.png", title="T"
        )
        assert two_col.exists() and two_col.stat().st_size > 10_000
        assert one_col.exists() and one_col.stat().st_size > 5_000


def test_compact_figure_style(video_on_disk, tmp_path):
    from hsip_tpu.pipeline import process_video_file
    from hsip_tpu.track import VideoSourceConfig

    meta, _ = video_on_disk
    cfg = VideoSourceConfig(name="C", figure_style="compact",
                            save_stacked_sequences=False)
    cfg.output_dir = str(tmp_path / "out")
    out = process_video_file(meta, cfg, backend="tpu", verbose=False)
    pngs = sorted((tmp_path / "out" / "viz-run-1-frames").glob("*.png"))
    assert len(pngs) == len(out.tracker.position_history)
    assert pngs[0].stat().st_size > 1_000
    # Compare PNG PIXEL dimensions (stable across matplotlib versions,
    # unlike byte sizes): compact figures are materially shorter than the
    # 12-panel full style.
    import struct

    def png_dims(path):
        header = path.read_bytes()[16:24]
        w, h = struct.unpack(">II", header)
        return w, h

    cfg2 = VideoSourceConfig(name="F", figure_style="full",
                             save_stacked_sequences=False)
    cfg2.output_dir = str(tmp_path / "out_full")
    process_video_file(meta, cfg2, backend="tpu", verbose=False)
    full_pngs = sorted((tmp_path / "out_full" / "viz-run-1-frames").glob("*.png"))
    _, compact_h = png_dims(pngs[-1])
    _, full_h = png_dims(full_pngs[-1])
    assert compact_h < 0.5 * full_h


def test_config_rejects_bad_figure_style(tmp_path):
    import json

    import pytest as _pytest

    from hsip_tpu.cli import load_config

    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"source": [{"name": "X", "figure_style": "Compact"}]}))
    with _pytest.raises(ValueError, match="figure_style"):
        load_config(p)


def test_render_diagnostics_parallel_end_to_end(tmp_path):
    """The default-on production figure path (worker pool + prefix history
    reconstruction) must actually write figures through process_video_file
    — both the pooled and serial fallbacks — without mutating the parent
    process's platform env."""
    import os

    from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
    from hsip_tpu.pipeline import process_video_file
    from hsip_tpu.track import VideoSourceConfig
    from hsip_tpu import viz as vizmod

    frames, _ = synthesize_flame_video(
        10, height=32, width=192,
        flame=FlameSpec(x0=20, v0_px=8, ignition_frame=2, seed=8),
    )
    meta = write_recording(tmp_path, "viz-run-1-a", frames,
                           spec=CihxSpec(width=192, height=32, total_frames=10,
                                         record_rate=50_000))
    cfg = VideoSourceConfig(name="V", save_frame_images=True,
                            save_stacked_sequences=False,
                            figure_style="compact")
    cfg.output_dir = str(tmp_path / "out")

    env_before = os.environ.get("JAX_PLATFORMS")
    out = process_video_file(meta, cfg, verbose=False)
    assert len(out.rows) > 3
    pngs = sorted((tmp_path / "out" / "viz-run-1-a-frames").glob("V-Frame-*.png"))
    assert len(pngs) == len(out.rows)
    assert pngs[0].stat().st_size > 5_000  # a real rendered figure

    # Serial fallback (single task) renders in-process and must NOT pin the
    # caller's platform env.
    one = [t for t in [1]]  # noqa: F841 (clarity)
    tasks = [{
        "frame_idx": out.rows[0][0], "time_s": out.rows[0][1],
        "pos_min_gradient": None, "pos_rightmost_sobel": None,
        "pos_spline_predicted": None, "search_bounds": (0, 192),
        "final_position": out.rows[0][2],
    }]
    paths = vizmod.render_diagnostics_parallel(
        str(meta), tasks, out.tracker.position_history,
        50_000.0, 0.001, 40.0, tmp_path / "serial", "S", workers=1,
        style="compact",
    )
    assert len(paths) == 1 and Path(paths[0]).exists()
    assert os.environ.get("JAX_PLATFORMS") == env_before


_UNGUARDED_SCRIPT = '''
import sys
from pathlib import Path

# Deliberately NO `if __name__ == "__main__":` guard: a spawned worker that
# imported this file as its main module would append a second line.
work = Path(sys.argv[1])
with open(work / "runs.txt", "a") as f:
    f.write("run\\n")

from hsip_tpu import viz
from hsip_tpu.io import FlameSpec, synthesize_flame_video, write_recording

frames, _ = synthesize_flame_video(
    6, height=32, width=128,
    flame=FlameSpec(x0=20, v0_px=8, ignition_frame=1, seed=3),
)
meta = write_recording(work, "guard-run-1-a", frames)
tasks = [{
    "frame_idx": i, "time_s": i * 1e-5, "pos_min_gradient": None,
    "pos_rightmost_sobel": None, "pos_spline_predicted": None,
    "search_bounds": (0, 128), "final_position": 20 + 8 * i,
} for i in range(1, 4)]
entries = [(i, 20 + 8 * i) for i in range(6)]
paths = viz.render_diagnostics_parallel(
    str(meta), tasks, entries, 100_000.0, 0.001, 40.0, work / "out", "G",
    workers=2, style="compact",
)
print("RENDERED", len(paths))
'''


def test_render_workers_do_not_rerun_unguarded_main(tmp_path):
    """Spawned render workers must not execute the parent's main script:
    one without a __main__ guard (a `hsip --distributed` driver, say) would
    otherwise run again in every worker — re-joining the distributed
    runtime under its parent's rank, which aborts the whole job."""
    import os
    import subprocess
    import sys

    repo = Path(__file__).resolve().parents[1]
    script = tmp_path / "unguarded.py"
    script.write_text(_UNGUARDED_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(repo), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RENDERED 3" in out.stdout
    assert (tmp_path / "runs.txt").read_text().splitlines() == ["run"]


def test_render_worker_init_hides_the_cards(monkeypatch):
    """A render worker never opens an accelerator: its initializer hides
    the cards and pins JAX to the CPU before any backend exists."""
    import os

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    viz._render_worker_init(None)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
    assert os.environ["JAX_PLATFORMS"] == "cpu"
