"""Opt-in randomized cross-backend parity sweep.

Off by default (adds minutes of runtime); enable with ``HSIP_FUZZ=1``, and
widen with ``HSIP_FUZZ_CONFIGS=N``. Each case draws a random detector config,
geometry, bit depth, and flame trajectory, then asserts the tpu, device, and
exact backends emit identical position rows and truncation reasons — the
whole-pipeline generalization of the fixed-seed parity tests in
test_pipeline.py. Also fuzzes detection method, use_frame_diff, skip
lists, metadata format (cihx/cih), all container depths (8/10/12/16),
odd/non-lane-multiple widths and Color Bit != effective depth
containers. Last wide run: HSIP_FUZZ_CONFIGS=40, 73/73 exact.
"""

import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

from hsip_tpu.io import (
    CihxSpec,
    FlameSpec,
    synthesize_flame_video,
    write_recording,
)
from hsip_tpu.pipeline import process_video_file
from hsip_tpu.track import FlameDetectorConfig, VideoSourceConfig

pytestmark = pytest.mark.skipif(
    not os.environ.get("HSIP_FUZZ"),
    reason="randomized sweep is opt-in: set HSIP_FUZZ=1",
)

N_CONFIGS = int(os.environ.get("HSIP_FUZZ_CONFIGS", "10"))


@pytest.mark.parametrize("seed", range(N_CONFIGS))
def test_random_config_backend_parity(seed):
    rng = np.random.default_rng(1000 + seed)
    det = FlameDetectorConfig(
        frame_diff_threshold=float(rng.uniform(1, 12)),
        morphology_kernel_size=int(rng.choice([2, 3, 4, 5])),
        gaussian_sigma=float(rng.uniform(0.8, 2.5)),
        min_gradient_strength=float(rng.uniform(3, 20)),
        sobel_threshold_fraction=float(rng.uniform(0.05, 0.3)),
        max_velocity_change_m_s=float(rng.uniform(80, 400)),
        search_window_px=int(rng.integers(40, 160)),
        edge_margin_px=int(rng.integers(3, 20)),
        exit_margin_px=int(rng.integers(8, 25)),
    )
    height = int(rng.choice([16, 32, 48, 96]))
    # Include widths that are NOT lane-multiples and NOT byte-aligned for
    # packed rows (odd width at 12-bit forces the host-decode fallback —
    # regression class: the packed staging path used to crash on them).
    width = int(rng.choice([255, 256, 330, 384, 500, 512]))
    depth = int(rng.choice([8, 10, 12, 16]))
    if depth == 10 and width % 4:
        width += 4 - width % 4  # 10-bit packing needs width % 4 == 0
    method = str(rng.choice(
        ["combined", "combined", "threshold", "gradient", "half_maximum"]
    ))
    use_frame_diff = bool(rng.random() < 0.7)
    metadata_format = str(rng.choice(["cihx", "cih"]))
    # Occasionally store 12 effective bits in 16-bit words (Color Bit).
    color_bit = 16 if (depth == 12 and rng.random() < 0.25) else None
    skip = (sorted(rng.choice(np.arange(3, 20), size=3, replace=False).tolist())
            if rng.random() < 0.3 else [])
    flame = FlameSpec(
        x0=float(rng.uniform(15, 60)),
        v0_px=float(rng.uniform(2, 14)),
        accel_px=float(rng.uniform(0, 0.5)),
        ignition_frame=int(rng.integers(0, 6)),
        ddt_frame=int(rng.integers(15, 35)) if rng.random() < 0.5 else None,
        v_jump_px=float(rng.uniform(10, 40)),
        flame_level={8: 220, 10: 900}.get(depth, 3000),
        background_level={8: 8, 10: 20}.get(depth, 40),
        seed=seed,
    )
    n_frames = int(rng.integers(25, 70))
    frames, _ = synthesize_flame_video(n_frames, height=height, width=width,
                                       flame=flame)
    if depth in (8, 10):
        frames = np.clip(frames, 0, 2 ** depth - 1)

    with tempfile.TemporaryDirectory() as tmp:
        meta = write_recording(
            Path(tmp), f"fuzz-run-{seed}-a", frames,
            spec=CihxSpec(width=width, height=height, total_frames=n_frames,
                          record_rate=int(rng.choice([50_000, 100_000])),
                          bit_depth=depth, color_bit=color_bit),
            metadata_format=metadata_format,
        )
        cfg = VideoSourceConfig(
            name="FUZZ", save_frame_images=False,
            save_stacked_sequences=False,
            calibration=float(rng.uniform(4e-4, 1.5e-3)),
            detection_method=method,
            use_frame_diff=use_frame_diff,
            skip_frames=skip,
        )
        outputs = {
            backend: process_video_file(meta, cfg, det, backend=backend,
                                        verbose=False, write_outputs=False)
            for backend in ("exact", "tpu", "device")
        }

    exact = outputs["exact"]
    for backend in ("tpu", "device"):
        got = outputs[backend]
        assert [r[:3] for r in got.rows] == [r[:3] for r in exact.rows], (
            f"seed {seed}: {backend} rows diverge from exact "
            f"(H={height} W={width} depth={depth} "
            f"k={det.morphology_kernel_size})"
        )
        if backend == "tpu":
            assert got.break_reason == exact.break_reason


@pytest.mark.parametrize("seed", range(max(3, N_CONFIGS // 3)))
def test_random_library_matches_per_file(seed, tmp_path):
    """Library mode (vmapped, mixed shapes/lengths/depths in one source)
    must write byte-identical tables to per-file device runs under random
    geometry — the whole-source generalization of
    test_library_mode_tables_match_per_file_device."""
    from hsip_tpu.pipeline import (
        process_video_source,
        process_video_source_library,
    )

    rng = np.random.default_rng(7000 + seed)
    lib = tmp_path / "lib"
    n_videos = int(rng.integers(2, 5))
    shapes = [(int(rng.choice([32, 48, 64])), int(rng.choice([256, 384, 512])))
              for _ in range(int(rng.integers(1, 3)))]
    for v in range(n_videos):
        h, w = shapes[v % len(shapes)]
        depth = int(rng.choice([12, 16]))
        n = int(rng.integers(20, 60))
        flame = FlameSpec(
            x0=float(rng.uniform(15, 50)),
            v0_px=float(rng.uniform(3, 10)),
            ignition_frame=int(rng.integers(0, 5)),
            ddt_frame=int(rng.integers(12, 25)) if rng.random() < 0.4 else None,
            v_jump_px=25.0,
            seed=900 + 10 * seed + v,
        )
        frames, _ = synthesize_flame_video(n, height=h, width=w, flame=flame)
        write_recording(
            lib, f"fuzzlib-run-{v + 1}-001", frames,
            spec=CihxSpec(width=w, height=h, total_frames=n,
                          record_rate=100_000, bit_depth=depth),
        )

    def cfg(out):
        c = VideoSourceConfig(name="FL", save_frame_images=False,
                              save_stacked_sequences=False,
                              calibration=0.000833333, position_offset=1.0)
        c.video_path = str(lib)
        c.output_dir = str(out)
        return c

    outs = process_video_source_library(cfg(tmp_path / "lo"), verbose=False)
    process_video_source(cfg(tmp_path / "do"), backend="device",
                         verbose=False)
    assert len(outs) == n_videos
    lib_tables = {p.name: p.read_bytes()
                  for p in (tmp_path / "lo").glob("*.txt")}
    dev_tables = {p.name: p.read_bytes()
                  for p in (tmp_path / "do").glob("*.txt")}
    assert set(lib_tables) == set(dev_tables)
    for name in lib_tables:
        assert lib_tables[name] == dev_tables[name], f"seed {seed}: {name}"


@pytest.mark.parametrize(
    "method", ["combined", "threshold", "half_maximum", "gradient"]
)
@pytest.mark.parametrize("seed", range(max(1, N_CONFIGS // 10)))
def test_random_pallas_scan_parity(seed, method):
    """Randomized configs through the Pallas scan kernel (interpret mode)
    vs the lax.scan backend: every output field bit-identical. The method
    is parametrized (not drawn) so every tier run deterministically covers
    all four kernels; widths include non-power-of-two values."""
    import jax.numpy as jnp

    from hsip_tpu.track.device_scan import device_tracking_scan
    from hsip_tpu.track.pallas_scan import pallas_tracking_scan
    from hsip_tpu.track.scan import MIN_SIGNAL_FRACTION, compute_profiles_batched

    rng = np.random.default_rng(
        7000 + 131 * seed + sum(map(ord, method))
    )
    det = FlameDetectorConfig(
        frame_diff_threshold=float(rng.uniform(1, 12)),
        gaussian_sigma=float(rng.uniform(0.8, 2.5)),
        min_gradient_strength=float(rng.uniform(3, 20)),
        sobel_threshold_fraction=float(rng.uniform(0.05, 0.3)),
        search_window_px=int(rng.integers(40, 160)),
        edge_margin_px=int(rng.integers(0, 20)),
        exit_margin_px=int(rng.integers(8, 25)),
    )
    n = int(rng.integers(16, 48))
    height, width = 32, int(rng.choice([250, 255, 256, 384, 500, 512]))
    flame = FlameSpec(
        x0=float(rng.uniform(10, 40)),
        v0_px=float(rng.uniform(2, 12)),
        accel_px=float(rng.uniform(0, 0.15)),
        ignition_frame=int(rng.integers(0, 6)),
        seed=int(rng.integers(0, 2**31)),
    )
    frames, _ = synthesize_flame_video(n, height=height, width=width,
                                       flame=flame)
    bg = float(frames[0].max())
    p = compute_profiles_batched(
        lambda a, b: frames[a:b], n, (height, width), bg, det, chunk_size=16
    )
    empty = p.signal_counts / p.total_pixels < MIN_SIGNAL_FRACTION
    kw = dict(
        width=width,
        min_gradient_strength=np.float32(det.min_gradient_strength),
        sobel_threshold_fraction=np.float32(det.sobel_threshold_fraction),
        ddt_velocity_jump=np.float32(det.ddt_velocity_jump_m_s),
        calibration=np.float32(rng.uniform(5e-4, 2e-3)),
        frame_rate=np.float32(rng.choice([5e4, 1e5, 2e5])),
        max_displacement_px=np.int32(rng.integers(1, 8)),
        edge_margin_px=det.edge_margin_px,
        search_window_px=det.search_window_px,
        exit_margin_px=det.exit_margin_px,
    )
    has_prior = p.has_prior
    if method != "combined":
        intens, has_prior = p.select_intensity(method, True)
        kw.update(
            method=method,
            intensity_lines=jnp.asarray(intens),
            method_fraction=np.float32(rng.uniform(0.3, 0.7)),
        )
    args = (np.asarray(p.frame_indices, np.int32), np.asarray(p.sobel_lines),
            np.asarray(p.gradient_lines), jnp.asarray(empty),
            jnp.asarray(has_prior))
    a = device_tracking_scan(*args, **kw)
    b = pallas_tracking_scan(*args, interpret=True, **kw)
    for name in a._fields:
        va = np.asarray(getattr(a, name))
        vb = np.asarray(getattr(b, name)).astype(va.dtype)
        np.testing.assert_array_equal(va, vb, err_msg=name)


@pytest.mark.parametrize(
    "method", ["combined", "threshold", "half_maximum", "gradient"]
)
def test_adversarial_pallas_scan_soak(method):
    """Adversarial value classes through the kernel at a hostile static
    config: heavy ties, sparse spikes, flat plateaus, and noise — with
    edge_margin 0 (the windows reach the clamped neighbour columns and the
    masked block tail), scattered non-contiguous frame indices and
    frame_rate 0 draws. Every field bit-identical."""
    import jax.numpy as jnp

    from hsip_tpu.track.device_scan import device_tracking_scan
    from hsip_tpu.track.pallas_scan import pallas_tracking_scan

    rng = np.random.default_rng(777 + sum(map(ord, method)))
    W, M = 250, 25
    for kind in range(4):
        if kind == 0:
            prof = np.abs(rng.normal(0, 50, (M, W))).astype(np.float32)
        elif kind == 1:  # heavy ties
            prof = (np.abs(rng.integers(-3, 4, (M, W))) * 10.0).astype(
                np.float32
            )
        elif kind == 2:  # sparse spikes
            prof = np.zeros((M, W), np.float32)
            prof[:, rng.integers(0, W, 5)] = 100
        else:  # flat plateau
            prof = np.full((M, W), 50.0, np.float32)
        sob = rng.normal(0, 30, (M, W)).astype(np.float32)
        grad = rng.normal(0, 15, (M, W)).astype(np.float32)
        empty = rng.random(M) < 0.2
        prior = rng.random(M) < 0.9
        fidx = np.sort(
            rng.choice(np.arange(M * 2), M, replace=False)
        ).astype(np.int32)
        kw = dict(
            width=W,
            min_gradient_strength=np.float32(rng.uniform(1, 30)),
            sobel_threshold_fraction=np.float32(rng.uniform(0.05, 0.4)),
            ddt_velocity_jump=np.float32(rng.uniform(100, 3000)),
            calibration=np.float32(rng.uniform(1e-4, 5e-3)),
            frame_rate=np.float32(rng.choice([0.0, 1e5])),
            max_displacement_px=np.int32(rng.integers(1, 9)),
            edge_margin_px=0, search_window_px=60, exit_margin_px=5,
        )
        if method != "combined":
            kw.update(method=method, intensity_lines=jnp.asarray(prof),
                      method_fraction=np.float32(rng.uniform(0.2, 1.2)))
        args = (fidx, sob, grad, jnp.asarray(empty), jnp.asarray(prior))
        a = device_tracking_scan(*args, **kw)
        b = pallas_tracking_scan(*args, interpret=True, **kw)
        for name in a._fields:
            va = np.asarray(getattr(a, name))
            vb = np.asarray(getattr(b, name)).astype(va.dtype)
            np.testing.assert_array_equal(
                va, vb, err_msg=f"{method} kind={kind} {name}"
            )
