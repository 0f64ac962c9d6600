"""Utils tests: logging, summaries, checkpoint/resume."""

import json
import logging

import numpy as np
import pytest

from hsip_tpu.io import FlameSpec, synthesize_flame_video, write_recording
from hsip_tpu.pipeline import process_video_source
from hsip_tpu.track import VideoSourceConfig
from hsip_tpu.utils import BatchCheckpoint, get_logger, set_log_level
from hsip_tpu.utils.logging import kv


def test_logger_namespacing_and_kv():
    log = get_logger("test")
    assert log.name == "hsip_tpu.test"
    set_log_level("DEBUG")
    # The hsip_tpu root logger does not propagate (own stderr handler), so
    # capture with an explicitly attached handler.
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = Capture()
    logging.getLogger("hsip_tpu").addHandler(handler)
    try:
        kv(log, logging.INFO, "hello", frames=10, fps=100)
    finally:
        logging.getLogger("hsip_tpu").removeHandler(handler)
        set_log_level("INFO")
    assert any("hello" in r.getMessage() for r in records)
    from hsip_tpu.utils.logging import _KVFormatter

    line = _KVFormatter().format(records[-1])
    assert "frames=10" in line and "fps=100" in line


def test_batch_checkpoint_roundtrip(tmp_path):
    ckpt = BatchCheckpoint(tmp_path, run_config_hash="abc")
    assert not ckpt.is_done("a.cihx")
    ckpt.mark_done("a.cihx", rows=5)
    assert ckpt.is_done("a.cihx")
    # A new instance with the same config hash sees the progress.
    again = BatchCheckpoint(tmp_path, run_config_hash="abc")
    assert again.is_done("a.cihx")
    assert again.completed["a.cihx"]["rows"] == 5
    # A changed config invalidates it.
    fresh = BatchCheckpoint(tmp_path, run_config_hash="DIFFERENT")
    assert not fresh.is_done("a.cihx")
    # Corrupt ledger: start clean, no crash.
    (tmp_path / BatchCheckpoint.FILENAME).write_text("{broken")
    corrupt = BatchCheckpoint(tmp_path, run_config_hash="abc")
    assert not corrupt.is_done("a.cihx")


@pytest.fixture()
def source_dir(tmp_path):
    frames, _ = synthesize_flame_video(
        20, height=32, width=256,
        flame=FlameSpec(x0=30, v0_px=7, ignition_frame=2, seed=2),
    )
    write_recording(tmp_path / "v", "sum-run-1-a", frames)
    write_recording(tmp_path / "v", "sum-run-2-b", frames)
    return tmp_path


def _cfg(source_dir):
    cfg = VideoSourceConfig(name="S", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.video_path = str(source_dir / "v")
    cfg.output_dir = str(source_dir / "out")
    return cfg


def test_run_summary_written(source_dir):
    cfg = _cfg(source_dir)
    outputs = process_video_source(cfg, verbose=False)
    assert len(outputs) == 2
    summary = json.loads((source_dir / "out" / "run-summary.json").read_text())
    assert summary["source"] == "S"
    assert summary["total_files"] == 2
    assert summary["total_rows"] == sum(len(o.rows) for o in outputs)
    f0 = summary["files"][0]
    assert f0["file"] == "sum-run-1-a.cihx"
    assert f0["rows"] > 5 and f0["wall_s"] >= 0
    assert summary["config"]["backend"] == "tpu"


def test_resume_skips_completed(source_dir, capsys):
    cfg = _cfg(source_dir)
    out1 = process_video_source(cfg, verbose=False)
    assert len(out1) == 2
    # Resume: both complete -> nothing reprocessed.
    out2 = process_video_source(cfg, verbose=True, resume=True)
    assert out2 == []
    assert "already complete" in capsys.readouterr().out
    # Without resume the ledger resets and everything reruns.
    out3 = process_video_source(cfg, verbose=False)
    assert len(out3) == 2


def test_run_summary_reports_full_frame_counts(source_dir):
    cfg = _cfg(source_dir)
    process_video_source(cfg, verbose=False)
    summary = json.loads((source_dir / "out" / "run-summary.json").read_text())
    # Each fixture recording has 20 frames total.
    assert all(f["n_frames"] == 20 for f in summary["files"])


def test_checkpoint_clear_removes_all_rank_ledgers(tmp_path):
    for r in range(3):
        BatchCheckpoint(tmp_path, run_config_hash="h", rank=r).mark_done(f"v{r}")
    fresh = BatchCheckpoint(tmp_path, run_config_hash="h", rank=0)
    assert fresh.is_done("v1")  # sees other ranks' ledgers
    fresh.clear()
    assert not any(tmp_path.glob("hsip-checkpoint*.json"))
    assert not BatchCheckpoint(tmp_path, run_config_hash="h").is_done("v1")


def test_resume_does_not_clobber_summary(source_dir):
    cfg = _cfg(source_dir)
    process_video_source(cfg, verbose=False)
    before = (source_dir / "out" / "run-summary.json").read_text()
    out = process_video_source(cfg, verbose=False, resume=True)
    assert out == []  # everything skipped
    assert (source_dir / "out" / "run-summary.json").read_text() == before


def test_resume_summary_accumulates_over_retried_failure(source_dir):
    """A --resume run that only retries a (still-failing) recording must
    keep the previous run's per-file records and add the failure — not
    clobber run-summary.json with total_files=0."""
    cfg = _cfg(source_dir)
    corrupt = source_dir / "v" / "bad-run-9-z.cihx"
    corrupt.write_bytes(b"\x01not-a-cihx" * 32)
    out1 = process_video_source(cfg, verbose=False)
    assert len(out1) == 2
    s1 = json.loads((source_dir / "out" / "run-summary.json").read_text())
    assert s1["total_files"] == 2 and s1["total_failures"] == 1

    # Resume: both good files skip via the checkpoint, the corrupt one
    # retries (it was never marked done) and fails again.
    out2 = process_video_source(cfg, verbose=False, resume=True)
    assert out2 == []
    s2 = json.loads((source_dir / "out" / "run-summary.json").read_text())
    assert s2["total_files"] == 2  # previous records kept
    assert s2["total_failures"] == 1  # replaced, not duplicated
    assert {f["file"] for f in s2["files"]} == {f["file"] for f in s1["files"]}

    # Fixing the recording and resuming replaces the failure with a record.
    frames, _ = synthesize_flame_video(
        20, height=32, width=256,
        flame=FlameSpec(x0=30, v0_px=7, ignition_frame=2, seed=5),
    )
    corrupt.unlink()
    write_recording(source_dir / "v", "bad-run-9-z", frames)
    out3 = process_video_source(cfg, verbose=False, resume=True)
    assert len(out3) == 1
    s3 = json.loads((source_dir / "out" / "run-summary.json").read_text())
    assert s3["total_files"] == 3 and s3["total_failures"] == 0


def test_enable_persistent_compilation_cache(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache directory as it
    is (no suffix, no other directory set in code)."""
    import jax

    from hsip_tpu.utils import enable_persistent_compilation_cache

    old = jax.config.jax_compilation_cache_dir
    try:
        target = tmp_path / "env-cache"
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
        got = enable_persistent_compilation_cache()
        assert got == str(target) and target.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(target)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_default_compilation_cache_is_fixed_in_checkout(tmp_path):
    """Unset, the cache is ONE fixed directory inside the checkout — the
    same for two processes with different HOME and TMPDIR, so each finds
    what the other compiled."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("from hsip_tpu.utils import enable_persistent_compilation_cache"
            " as e; print(e())")
    got = []
    for i in range(2):
        env = {k: v for k, v in os.environ.items()
               if k != "JAX_COMPILATION_CACHE_DIR"}
        env.update(HOME=str(tmp_path / f"home{i}"),
                   TMPDIR=str(tmp_path), JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(repo))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-800:]
        got.append(out.stdout.strip().splitlines()[-1])
    assert got[0] == got[1] == str(repo / ".jax_cache")


def test_invalid_log_level_env_does_not_crash():
    """HSIP_LOG_LEVEL is a diagnostic knob; a bad value must clamp to INFO,
    not take down every import of the pipeline."""
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run(
        [sys.executable, "-c",
         "import hsip_tpu.pipeline; print('IMPORT_OK')"],
        capture_output=True, text=True, timeout=120,
        env={**__import__('os').environ, "HSIP_LOG_LEVEL": "verbose",
             "PYTHONPATH": str(Path(__file__).resolve().parent.parent)},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "IMPORT_OK" in proc.stdout
    assert "ignoring invalid HSIP_LOG_LEVEL" in proc.stderr


def test_run_summary_includes_phase_timings(tmp_path):
    """track_video attributes wall time to map/scan phases and the run
    summary carries it through."""
    import json

    import numpy as np

    from hsip_tpu.io import FlameSpec, synthesize_flame_video, write_recording
    from hsip_tpu.pipeline import process_video_source
    from hsip_tpu.track import VideoSourceConfig

    frames, _ = synthesize_flame_video(
        16, height=32, width=256,
        flame=FlameSpec(x0=25, v0_px=8, ignition_frame=2, seed=2),
    )
    write_recording(tmp_path / "v", "pt-run-1", frames)
    cfg = VideoSourceConfig(name="PT", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.video_path = str(tmp_path / "v")
    cfg.output_dir = str(tmp_path / "out")
    outs = process_video_source(cfg, verbose=False)
    assert outs[0].phase_timings is not None
    assert set(outs[0].phase_timings) == {"map_s", "scan_s"}
    summary = json.loads((tmp_path / "out" / "run-summary.json").read_text())
    pt = summary["files"][0]["phase_timings"]
    assert pt["map_s"] >= 0 and pt["scan_s"] >= 0
