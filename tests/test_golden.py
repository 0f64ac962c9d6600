"""Golden-table regression: the device pipeline must reproduce, BYTE FOR BYTE,
a results table generated once by the exact float64 backend.

Guards the whole exactness contract at once: synthetic generation, 12-bit
packing, on-device band decode + preprocess, tracking semantics, float64
velocity columns, and output formatting.
"""

from pathlib import Path

import pytest

from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
from hsip_tpu.pipeline import process_video_file
from hsip_tpu.track import FileCalibration, VideoSourceConfig

# NOTE: the golden table is generated from synthesize_flame_video(seed=77),
# whose noise stream depends on numpy's Generator bit-stream (stable per
# numpy version, may change across feature releases — NEP 19). If a numpy
# upgrade breaks this test with otherwise-green parity tests, regenerate:
#   python -c "from tests.test_golden import regenerate; regenerate()"
GOLDEN = Path(__file__).parent / "golden" / "golden-run-1-001-flame-position.txt"


def regenerate(out_path=GOLDEN):
    """Rebuild the golden table with the exact float64 backend."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        meta, cfg = _build(tmp)
        process_video_file(meta, cfg, backend="exact", verbose=False)
        src = tmp / "out" / "golden-run-1-001-flame-position.txt"
        Path(out_path).write_bytes(src.read_bytes())


def _build(tmp_path):
    flame = FlameSpec(x0=30.0, v0_px=8.0, accel_px=0.3, ignition_frame=3,
                      ddt_frame=28, v_jump_px=25.0, seed=77)
    frames, _ = synthesize_flame_video(60, height=48, width=512, flame=flame)
    spec = CihxSpec(width=512, height=48, total_frames=60, record_rate=100_000,
                    bit_depth=12, start_frame=-10)
    meta = write_recording(tmp_path, "golden-run-1-001", frames, spec=spec)
    cfg = VideoSourceConfig(name="G", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.output_dir = str(tmp_path / "out")
    cfg.file_calibrations = [
        FileCalibration(calibration=0.000833333, position_offset=1.0159,
                        files=["run-1-"]),
    ]
    return meta, cfg


@pytest.mark.parametrize("backend", ["exact", "tpu", "device"])
def test_pipeline_reproduces_golden_table(tmp_path, backend):
    meta, cfg = _build(tmp_path)
    process_video_file(meta, cfg, backend=backend, verbose=False)
    produced = (tmp_path / "out" / "golden-run-1-001-flame-position.txt")
    assert produced.read_bytes() == GOLDEN.read_bytes()
