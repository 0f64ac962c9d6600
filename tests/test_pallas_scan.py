"""Pallas (Triton) scan kernel: bit-identity with the lax.scan tracker.

The single-kernel scan (track/pallas_scan.py) must agree with
device_tracking_scan on EVERY output field, bit for bit — it is the GPU
path for every detector, and the host scan's quantization contract is
anchored on the lax.scan semantics. These tests run the kernel in Pallas
interpret mode on the CPU, and lower it for CUDA (which runs the Triton
lowering rules without a card); `chip_smoke.py` checks the compiled kernel
on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hsip_tpu.track.pallas_scan as ps
from hsip_tpu.io import FlameSpec, synthesize_flame_video, write_recording
from hsip_tpu.track import FlameDetectorConfig
from hsip_tpu.track.device_scan import device_tracking_scan
from hsip_tpu.track.pallas_scan import (
    pallas_tracking_scan,
    pallas_tracking_scan_batched,
)

_METHODS = ["combined", "threshold", "half_maximum", "gradient"]


def _assert_identical(a, b):
    for name in a._fields:
        va = np.asarray(getattr(a, name))
        vb = np.asarray(getattr(b, name)).astype(va.dtype)
        np.testing.assert_array_equal(va, vb, err_msg=name)


def _run_both(fidx, sob, grad, empty, prior, **kw):
    a = device_tracking_scan(
        fidx, sob, grad, jnp.asarray(empty), jnp.asarray(prior), **kw
    )
    b = pallas_tracking_scan(
        fidx, sob, grad, jnp.asarray(empty), jnp.asarray(prior),
        interpret=True, **kw,
    )
    _assert_identical(a, b)
    return a


_KW = dict(
    min_gradient_strength=np.float32(10.0),
    sobel_threshold_fraction=np.float32(0.1),
    ddt_velocity_jump=np.float32(1250.0),
    calibration=np.float32(0.001),
    frame_rate=np.float32(100_000.0),
    max_displacement_px=np.int32(3),
)


def test_pallas_scan_random_profiles():
    rng = np.random.default_rng(3)
    # Power-of-two and other widths: the kernel loads a power-of-two block
    # masked to W, so any W must match the lax.scan backend bit for bit.
    for trial, W in enumerate((256, 250, 255, 100)):
        M = int(rng.integers(8, 80))
        sob = rng.normal(0, 30, (M, W)).astype(np.float32)
        grad = rng.normal(0, 15, (M, W)).astype(np.float32)
        empty = rng.random(M) < 0.15
        prior = np.ones(M, bool)
        prior[0] = False
        fidx = np.arange(M, dtype=np.int32)
        _run_both(fidx, sob, grad, empty, prior, width=W, **_KW)


def _video_profiles(flame, n=40, width=256, height=32):
    from hsip_tpu.track.scan import compute_profiles_batched

    frames, _ = synthesize_flame_video(n, height=height, width=width,
                                       flame=flame)
    config = FlameDetectorConfig()
    bg = float(frames[0].max())

    def read_batch(a, b):
        return frames[a:b]

    p = compute_profiles_batched(
        read_batch, n, (height, width), bg, config, chunk_size=16
    )
    from hsip_tpu.track.scan import MIN_SIGNAL_FRACTION

    empty = p.signal_counts / p.total_pixels < MIN_SIGNAL_FRACTION
    return p, empty


@pytest.mark.parametrize("flame", [
    FlameSpec(x0=25.0, v0_px=9.0, accel_px=0.05, ignition_frame=2, seed=7),
    FlameSpec(x0=20.0, v0_px=4.0, ddt_frame=18, v_jump_px=22.0,
              ignition_frame=3, seed=11),
    FlameSpec(x0=30.0, v0_px=6.0, ignition_frame=12, seed=13),
], ids=["exit", "ddt", "late-ignition"])
def test_pallas_scan_flame_scenarios(flame):
    """Exit truncation, DDT latch and empty-frame skipping all agree."""
    p, empty = _video_profiles(flame)
    res = _run_both(
        np.asarray(p.frame_indices, np.int32),
        np.asarray(p.sobel_lines), np.asarray(p.gradient_lines),
        empty, p.has_prior, width=p.width, **_KW,
    )
    # The scenario must actually exercise the machinery.
    assert int(np.sum(np.asarray(res.recorded))) > 3


def test_pallas_scan_nonaligned_width_flame():
    """A real flame trajectory at a width that is not a power of two
    (W=250): map-phase profiles plus both scan backends, bit-identical."""
    p, empty = _video_profiles(
        FlameSpec(x0=20.0, v0_px=7.0, ignition_frame=2, seed=17),
        n=32, width=250,
    )
    res = _run_both(
        np.asarray(p.frame_indices, np.int32),
        np.asarray(p.sobel_lines), np.asarray(p.gradient_lines),
        empty, p.has_prior, width=p.width, **_KW,
    )
    assert int(np.sum(np.asarray(res.recorded))) > 3


def test_pallas_scan_zero_frame_rate():
    """frame_rate <= 0 records no velocity entries in either backend."""
    p, empty = _video_profiles(
        FlameSpec(x0=25.0, v0_px=8.0, ignition_frame=2, seed=5), n=24
    )
    kw = dict(_KW, frame_rate=np.float32(0.0))
    _run_both(
        np.asarray(p.frame_indices, np.int32),
        np.asarray(p.sobel_lines), np.asarray(p.gradient_lines),
        empty, p.has_prior, width=p.width, **kw,
    )


def test_pallas_scan_gate(monkeypatch):
    """The kernel runs on a GPU backend, or wherever a test asked for
    interpret mode — never on the CPU otherwise."""
    import hsip_tpu.utils.backend as backend_mod

    assert not backend_mod.is_gpu_backend()  # the suite runs on the CPU
    assert not ps.kernel_enabled()
    monkeypatch.setattr(ps, "INTERPRET", True)
    assert ps.kernel_enabled()
    monkeypatch.setattr(ps, "INTERPRET", False)
    monkeypatch.setattr(backend_mod, "is_gpu_backend", lambda: True)
    assert ps.kernel_enabled()


def test_track_video_pallas_gate_off_on_cpu(tmp_path, monkeypatch):
    """On the CPU run_tracking_scan_device stays on lax.scan: no path runs
    the kernel in interpret mode unless a test asked for it."""
    from hsip_tpu import open_video
    from hsip_tpu.track.scan import track_video

    def boom(*a, **k):
        raise AssertionError("kernel path taken on the CPU")

    monkeypatch.setattr(ps, "pallas_tracking_scan", boom)
    monkeypatch.setattr(ps, "pallas_tracking_scan_batched", boom)
    frames, _ = synthesize_flame_video(
        20, height=32, width=256,
        flame=FlameSpec(x0=25, v0_px=8, ignition_frame=2, seed=9),
    )
    meta = write_recording(tmp_path, "ps-run-1", frames)
    with open_video(str(meta)) as video:
        out = track_video(
            video, FlameDetectorConfig(), calibration_m_per_px=0.001,
            scan="device",
        )
    assert len(out.rows) > 3


def test_pallas_scan_rejects_bad_width():
    with pytest.raises(ValueError, match="width"):
        pallas_tracking_scan(
            np.arange(4, dtype=np.int32),
            np.zeros((4, 256), np.float32), np.zeros((4, 256), np.float32),
            jnp.zeros(4, bool), jnp.ones(4, bool),
            width=512, interpret=True, **_KW,
        )


def test_pallas_scan_batched_matches_vmapped_lax_scan():
    """Whole-batch kernel (grid (V,), per-video state reset and params)
    is bit-identical to vmap(device_tracking_scan) — including an inert
    all-empty pad video like the mesh-alignment padding."""
    specs = [
        FlameSpec(x0=25.0, v0_px=9.0, accel_px=0.05, ignition_frame=2, seed=7),
        FlameSpec(x0=20.0, v0_px=4.0, ddt_frame=18, v_jump_px=22.0,
                  ignition_frame=3, seed=11),
        FlameSpec(x0=30.0, v0_px=6.0, ignition_frame=12, seed=13),
    ]
    profs = [_video_profiles(f) for f in specs]
    n_max = max(p.frame_indices.size for p, _ in profs)
    V = len(profs) + 1  # + one inert pad video
    W = profs[0][0].width
    fi = np.zeros((V, n_max), np.int32)
    sob = np.zeros((V, n_max, W), np.float32)
    grad = np.zeros((V, n_max, W), np.float32)
    empty = np.ones((V, n_max), bool)
    prior = np.ones((V, n_max), bool)
    cals = np.array([0.001, 0.0008, 0.0012, 1.0], np.float32)
    fps = np.array([1e5, 9e4, 1.1e5, 1.0], np.float32)
    mds = np.array([3, 4, 2, 1], np.int32)
    for i, (p, e) in enumerate(profs):
        m = p.frame_indices.size
        fi[i, :m] = p.frame_indices
        sob[i, :m] = p.sobel_lines
        grad[i, :m] = p.gradient_lines
        empty[i, :m] = e
        prior[i, :m] = p.has_prior

    kw = dict(
        width=W,
        min_gradient_strength=np.float32(10.0),
        sobel_threshold_fraction=np.float32(0.1),
        ddt_velocity_jump=np.float32(1250.0),
    )
    scan_v = jax.vmap(
        lambda f, s, g, e, hp, c, r, md: device_tracking_scan(
            f, s, g, e, hp, calibration=c, frame_rate=r,
            max_displacement_px=md, **kw,
        )
    )
    a = scan_v(jnp.asarray(fi), jnp.asarray(sob), jnp.asarray(grad),
               jnp.asarray(empty), jnp.asarray(prior),
               jnp.asarray(cals), jnp.asarray(fps), jnp.asarray(mds))
    b = pallas_tracking_scan_batched(
        jnp.asarray(fi), jnp.asarray(sob), jnp.asarray(grad),
        jnp.asarray(empty), jnp.asarray(prior),
        calibration=jnp.asarray(cals), frame_rate=jnp.asarray(fps),
        max_displacement_px=jnp.asarray(mds), interpret=True, **kw,
    )
    _assert_identical(a, b)
    # The batch genuinely tracked something in each real video.
    assert all(np.asarray(a.recorded)[i].sum() > 3 for i in range(3))


def test_pallas_scan_under_mesh_shard_map(tmp_path, monkeypatch):
    """The kernel path also serves the mesh-sharded library mode: shard_map
    over the video axis (interpret mode on the virtual CPU mesh) produces
    tables identical to the lax.scan mesh path."""
    from hsip_tpu import open_collection
    from hsip_tpu.parallel import make_mesh
    from hsip_tpu.track.batch import track_collection_device

    for i in range(3):
        frames, _ = synthesize_flame_video(
            18 + 4 * i, height=32, width=256,
            flame=FlameSpec(x0=22.0 + i, v0_px=7.0 + i, ignition_frame=2,
                            seed=70 + i),
        )
        write_recording(tmp_path, f"mesh-run-{i + 1}-001", frames)

    mesh = make_mesh("video", n_devices=4)

    def run():
        with open_collection(str(tmp_path)) as coll:
            return track_collection_device(
                coll, FlameDetectorConfig(), mesh=mesh
            )

    monkeypatch.setattr(ps, "INTERPRET", True)
    outs_pallas = run()
    monkeypatch.setattr(ps, "INTERPRET", False)
    outs_lax = run()
    assert len(outs_pallas) == len(outs_lax) == 3
    for a, b in zip(outs_pallas, outs_lax):
        assert a.rows == b.rows and len(a.rows) > 3
        assert a.break_reason == b.break_reason
        assert a.tracker.get_velocity_history() == b.tracker.get_velocity_history()


# ---- named profile methods (threshold / half_maximum / gradient) ----

_NAMED = ["threshold", "half_maximum", "gradient"]


def _run_both_named(fidx, sob, grad, intens, empty, prior, method, **kw):
    kw = dict(kw, method=method, intensity_lines=jnp.asarray(intens),
              method_fraction=np.float32(0.5))
    a = device_tracking_scan(
        fidx, sob, grad, jnp.asarray(empty), jnp.asarray(prior), **kw
    )
    b = pallas_tracking_scan(
        fidx, sob, grad, jnp.asarray(empty), jnp.asarray(prior),
        interpret=True, **kw,
    )
    _assert_identical(a, b)
    return a


@pytest.mark.parametrize("method", _NAMED)
def test_pallas_scan_named_methods_random(method):
    """Each named detector's kernel twin is bit-identical to the lax.scan
    device twin — including the gradient method's TwoSum double-float tie
    ordering — on noisy profiles at aligned and non-aligned widths."""
    rng = np.random.default_rng(29)
    for W in (256, 250):
        M = 48
        intens = np.abs(rng.normal(60, 40, (M, W))).astype(np.float32)
        pos = (20 + 3 * np.arange(M)) % (W - 30)
        for i in range(M):
            intens[i, pos[i]:pos[i] + 8] += 400.0
        zeros = np.zeros((M, W), np.float32)
        empty = rng.random(M) < 0.1
        prior = np.ones(M, bool)
        fidx = np.arange(M, dtype=np.int32)
        res = _run_both_named(
            fidx, zeros, zeros, intens, empty, prior, method, width=W, **_KW
        )
        assert int((np.asarray(res.final_position) >= 0).sum()) > 5


@pytest.mark.parametrize("method", _NAMED)
def test_pallas_scan_named_methods_flame(method):
    """Named methods over REAL pipeline profiles (select_intensity feed)."""
    p, empty = _video_profiles(
        FlameSpec(x0=25.0, v0_px=8.0, ignition_frame=2, seed=33), n=36
    )
    intens, has_prior = p.select_intensity(method, True)
    res = _run_both_named(
        np.asarray(p.frame_indices, np.int32),
        np.asarray(p.sobel_lines), np.asarray(p.gradient_lines),
        np.asarray(intens), empty, has_prior, method, width=p.width, **_KW,
    )
    assert int(np.sum(np.asarray(res.recorded))) > 3


@pytest.mark.parametrize("method", _NAMED)
def test_pallas_library_named_methods(tmp_path, monkeypatch, method):
    """Library mode with a named detector takes the kernel path and matches
    the lax.scan library path row for row."""
    from hsip_tpu import open_collection
    from hsip_tpu.track.batch import track_collection_device
    from hsip_tpu.track.config import VideoSourceConfig

    for i in range(2):
        frames, _ = synthesize_flame_video(
            24, height=32, width=256,
            flame=FlameSpec(x0=24.0 + i, v0_px=7.0, ignition_frame=2,
                            seed=80 + i),
        )
        write_recording(tmp_path, f"nmk-run-{i + 1}-001", frames)

    src = VideoSourceConfig(name="NMK", detection_method=method,
                            calibration=0.0008,
                            save_frame_images=False,
                            save_stacked_sequences=False)
    src.video_path = str(tmp_path)

    def run():
        with open_collection(str(tmp_path)) as coll:
            return track_collection_device(
                coll, FlameDetectorConfig(), source_config=src
            )

    monkeypatch.setattr(ps, "INTERPRET", True)
    outs_pallas = run()
    monkeypatch.setattr(ps, "INTERPRET", False)
    outs_lax = run()
    assert len(outs_pallas) == len(outs_lax) == 2
    for a, b in zip(outs_pallas, outs_lax):
        assert a.rows == b.rows and len(a.rows) > 3
        assert a.break_reason == b.break_reason


def test_pallas_named_method_under_mesh(tmp_path, monkeypatch):
    """Named detector + mesh: the 9-arg shard_map'd kernel (intensity rows
    ride along) matches the lax.scan mesh path row for row."""
    from hsip_tpu import open_collection
    from hsip_tpu.parallel import make_mesh
    from hsip_tpu.track.batch import track_collection_device
    from hsip_tpu.track.config import VideoSourceConfig

    for i in range(2):
        frames, _ = synthesize_flame_video(
            20, height=32, width=256,
            flame=FlameSpec(x0=23.0 + i, v0_px=7.0, ignition_frame=2,
                            seed=90 + i),
        )
        write_recording(tmp_path, f"nmm-run-{i + 1}-001", frames)

    src = VideoSourceConfig(name="NMM", detection_method="gradient",
                            calibration=0.0008,
                            save_frame_images=False,
                            save_stacked_sequences=False)
    src.video_path = str(tmp_path)
    mesh = make_mesh("video", n_devices=2)

    def run():
        with open_collection(str(tmp_path)) as coll:
            return track_collection_device(
                coll, FlameDetectorConfig(), source_config=src, mesh=mesh
            )

    monkeypatch.setattr(ps, "INTERPRET", True)
    outs_pallas = run()
    monkeypatch.setattr(ps, "INTERPRET", False)
    outs_lax = run()
    assert len(outs_pallas) == len(outs_lax) == 2
    for a, b in zip(outs_pallas, outs_lax):
        assert a.rows == b.rows and len(a.rows) > 3
        assert a.break_reason == b.break_reason


def _library(tmp_path, n, frames=20, width=256, seed=100):
    for i in range(n):
        fr, _ = synthesize_flame_video(
            frames, height=32, width=width,
            flame=FlameSpec(x0=22.0 + i, v0_px=7.0, ignition_frame=2,
                            seed=seed + i),
        )
        write_recording(tmp_path, f"lib-run-{i + 1}-001", fr)
    return tmp_path


@pytest.fixture
def fresh_fused_programs():
    """The fused library program is cached per static config; patched
    kernels must not leak into (or out of) a cached program."""
    from hsip_tpu.track.fused import _fused_program

    _fused_program.cache_clear()
    yield
    _fused_program.cache_clear()


def _gpu_gate_with_interpret_spy(monkeypatch):
    """Pretend the backend is a GPU; route the kernel calls through
    interpret mode and record the batch sizes they saw (at trace time)."""
    import hsip_tpu.utils.backend as backend_mod

    seen = []
    real_batched = ps.pallas_tracking_scan_batched

    def spy_batched(fi, *a, **k):
        seen.append(int(fi.shape[0]))
        return real_batched(fi, *a, **{**k, "interpret": True})

    monkeypatch.setattr(backend_mod, "is_gpu_backend", lambda: True)
    monkeypatch.setattr(ps, "pallas_tracking_scan_batched", spy_batched)
    return seen


@pytest.mark.parametrize("n_videos", [1, 3])
def test_scan_routing_by_batch_size(tmp_path, monkeypatch, n_videos,
                                   fresh_fused_programs):
    """On a GPU the library scan takes the kernel at EVERY batch size (one
    program per video, no batch-size crossover), with tables equal to
    the CPU's vmapped lax.scan. The map phase is plain jnp and runs on
    the CPU whatever the gate says."""
    from hsip_tpu import open_collection
    from hsip_tpu.track.batch import track_collection_device

    _library(tmp_path, n_videos)

    def run():
        with open_collection(str(tmp_path)) as coll:
            return track_collection_device(coll, FlameDetectorConfig())

    ref = run()
    seen = _gpu_gate_with_interpret_spy(monkeypatch)
    got = run()
    assert seen == [n_videos]
    assert [o.rows for o in got] == [o.rows for o in ref]
    assert all(len(o.rows) > 3 for o in got)


def test_gpu_gate_routes_single_video_scan_to_kernel(monkeypatch):
    """run_tracking_scan_device: the GPU gate picks the kernel (here run
    in interpret mode); rows equal the lax.scan backend's."""
    from hsip_tpu.track.scan import run_tracking_scan_device

    p, _ = _video_profiles(
        FlameSpec(x0=25, v0_px=8, ignition_frame=2, seed=21), n=30
    )
    common = dict(config=FlameDetectorConfig(), frame_rate=1e5,
                  calibration_m_per_px=0.001)
    out_lax = run_tracking_scan_device(p, **common)
    seen = _gpu_gate_with_interpret_spy(monkeypatch)
    out_kernel = run_tracking_scan_device(p, **common)
    assert seen == [1]
    assert out_kernel.rows == out_lax.rows and len(out_lax.rows) > 3


def test_kernel_error_propagates_without_fallback(tmp_path, monkeypatch,
                                                 fresh_fused_programs):
    """A kernel failure raises out of both the per-file and the library
    scan; nothing quietly falls back to lax.scan."""
    import hsip_tpu.utils.backend as backend_mod
    from hsip_tpu import open_collection
    from hsip_tpu.track.batch import track_collection_device
    from hsip_tpu.track.scan import run_tracking_scan_device

    class KernelFailure(RuntimeError):
        pass

    def broken(*a, **k):
        raise KernelFailure("kernel failed to compile")

    monkeypatch.setattr(backend_mod, "is_gpu_backend", lambda: True)
    monkeypatch.setattr(ps, "pallas_tracking_scan_batched", broken)
    p, _ = _video_profiles(
        FlameSpec(x0=25, v0_px=8, ignition_frame=2, seed=21), n=20
    )
    with pytest.raises(KernelFailure):
        run_tracking_scan_device(p, FlameDetectorConfig(), frame_rate=1e5,
                                 calibration_m_per_px=0.001)
    _library(tmp_path, 2)
    with open_collection(str(tmp_path)) as coll:
        with pytest.raises(KernelFailure):
            track_collection_device(coll, FlameDetectorConfig())


def _random_inputs(rng, V, M, W, method):
    sob = rng.normal(0, 30, (V, M, W)).astype(np.float32)
    grad = rng.normal(0, 15, (V, M, W)).astype(np.float32)
    intens = np.abs(rng.normal(60, 40, (V, M, W))).astype(np.float32)
    for v in range(V):
        pos = (20 + (3 + v) * np.arange(M)) % (W - 30)
        for i in range(M):
            intens[v, i, pos[i]:pos[i] + 8] += 400.0
    empty = rng.random((V, M)) < 0.15
    prior = np.ones((V, M), bool)
    if method == "combined":
        prior[:, 0] = False
    fidx = np.tile(np.arange(M, dtype=np.int32), (V, 1))
    return fidx, sob, grad, intens, empty, prior


def _batched_kw(V, W, method, intens):
    return dict(
        width=W,
        min_gradient_strength=np.float32(10.0),
        sobel_threshold_fraction=np.float32(0.1),
        ddt_velocity_jump=np.float32(1250.0),
        calibration=np.linspace(8e-4, 1.2e-3, V).astype(np.float32),
        frame_rate=np.full(V, 1e5, np.float32),
        max_displacement_px=np.arange(2, 2 + V, dtype=np.int32) % 5 + 1,
        method=method,
        intensity_lines=jnp.asarray(intens),
        method_fraction=np.float32(0.5),
    )


def _vmapped_lax(fidx, sob, grad, empty, prior, kw):
    kw = dict(kw)
    cal, fr, md = (kw.pop("calibration"), kw.pop("frame_rate"),
                   kw.pop("max_displacement_px"))
    intens = kw.pop("intensity_lines")
    return jax.vmap(
        lambda f, s, g, it, e, hp, c, r, d: device_tracking_scan(
            f, s, g, e, hp, calibration=c, frame_rate=r,
            max_displacement_px=d, intensity_lines=it, **kw,
        )
    )(jnp.asarray(fidx), jnp.asarray(sob), jnp.asarray(grad), intens,
      jnp.asarray(empty), jnp.asarray(prior), jnp.asarray(cal),
      jnp.asarray(fr), jnp.asarray(md))


@pytest.mark.parametrize("W", [1024, 1000, 250])
@pytest.mark.parametrize("method", _METHODS)
def test_kernel_parity_with_lax_scan(method, W):
    """Interpret-mode kernel vs lax.scan, every field, at the bench width
    (1024), a width just under it (1000: the block is masked) and a small
    one — for all four detectors."""
    rng = np.random.default_rng(W + sum(map(ord, method)))
    fidx, sob, grad, intens, empty, prior = _random_inputs(
        rng, 1, 24, W, method
    )
    kw = _batched_kw(1, W, method, intens)
    a = _vmapped_lax(fidx, sob, grad, empty, prior, kw)
    b = pallas_tracking_scan_batched(
        fidx, sob, grad, jnp.asarray(empty), jnp.asarray(prior),
        interpret=True, **kw,
    )
    _assert_identical(a, b)
    assert int((np.asarray(a.final_position) >= 0).sum()) > 5


@pytest.mark.parametrize("V", [2, 8, 16])
def test_kernel_batched_parity(V):
    """One program per video at V = 2, 8 and 16: per-video state and
    parameters never leak between programs."""
    method = ("combined", "gradient", "threshold")[V % 3]
    rng = np.random.default_rng(40 + V)
    fidx, sob, grad, intens, empty, prior = _random_inputs(
        rng, V, 12, 128, method
    )
    kw = _batched_kw(V, 128, method, intens)
    a = _vmapped_lax(fidx, sob, grad, empty, prior, kw)
    b = pallas_tracking_scan_batched(
        fidx, sob, grad, jnp.asarray(empty), jnp.asarray(prior),
        interpret=True, **kw,
    )
    _assert_identical(a, b)


def test_kernel_pad_columns_inert():
    """W=250 loads a 256-wide block. With edge_margin 0 the windows reach
    the last real column, and the values right after each row (the next
    row's first columns) are extreme — the masked pad columns still never
    win a reduction, for any detector."""
    rng = np.random.default_rng(11)
    V, M, W = 2, 16, 250
    for method in _METHODS:
        fidx, sob, grad, intens, empty, prior = _random_inputs(
            rng, V, M, W, method
        )
        for arr, val in ((sob, 1e30), (grad, -1e30), (intens, 1e30)):
            arr[:, :, :6] = val
        kw = dict(_batched_kw(V, W, method, intens), edge_margin_px=0,
                  exit_margin_px=0, search_window_px=400)
        a = _vmapped_lax(fidx, sob, grad, empty, prior, kw)
        b = pallas_tracking_scan_batched(
            fidx, sob, grad, jnp.asarray(empty), jnp.asarray(prior),
            interpret=True, **kw,
        )
        _assert_identical(a, b)


@pytest.fixture
def verified_triton(monkeypatch):
    """Run MLIR's verifier on every Triton module the lowering builds. The
    card parses the module and rejects one that fails it (for example an
    ``arith.select`` whose branches differ in type); lowering alone writes
    it out unchecked."""
    from jax._src.pallas.triton import lowering

    real = lowering.lower_jaxpr_to_triton_module
    verified = []

    def lower_and_verify(*a, **k):
        result = real(*a, **k)
        result.module.operation.verify()  # raises on an invalid module
        verified.append(True)
        return result

    monkeypatch.setattr(lowering, "lower_jaxpr_to_triton_module",
                        lower_and_verify)
    return verified


@pytest.mark.parametrize("method", _METHODS)
def test_kernel_lowers_for_gpu(method, verified_triton):
    """The Triton lowering of every detector at a masked width, without a
    card: lowering for CUDA runs the Pallas->Triton rules (unsupported ops,
    block shapes, scalar/tensor types) that interpret mode never checks,
    and the verifier checks the module the card would parse."""
    V, M, W = 2, 16, 1000
    kw = dict(
        width=W,
        min_gradient_strength=np.float32(10.0),
        sobel_threshold_fraction=np.float32(0.1),
        ddt_velocity_jump=np.float32(1250.0),
        calibration=jnp.ones(V, jnp.float32),
        frame_rate=jnp.full(V, 1e5, jnp.float32),
        max_displacement_px=jnp.full(V, 3, jnp.int32),
        method=method,
        intensity_lines=jnp.zeros((V, M, W), jnp.float32),
        method_fraction=np.float32(0.5),
    )
    args = (jnp.zeros((V, M), jnp.int32), jnp.zeros((V, M, W)),
            jnp.zeros((V, M, W)), jnp.zeros((V, M), bool),
            jnp.ones((V, M), bool))
    f = jax.jit(lambda *a: pallas_tracking_scan_batched(*a, **kw))
    low = f.trace(*args).lower(lowering_platforms=("cuda",))
    assert "triton" in low.as_text().lower()
    assert verified_triton == [True]


def test_mesh_kernel_lowers_for_gpu(verified_triton):
    """The shard_map'd kernel (the mesh library path) lowers for CUDA: the
    per-device pallas_call survives partitioning."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from hsip_tpu.parallel import make_mesh
    from hsip_tpu.track.device_scan import DeviceScanResult

    mesh = make_mesh("video", n_devices=4)
    V, M, W = 4, 16, 1024

    def kernel_scan(fi, sob, grad, empty, hp, cal, fps, md):
        return pallas_tracking_scan_batched(
            fi, sob, grad, empty, hp, width=W,
            min_gradient_strength=np.float32(10.0),
            sobel_threshold_fraction=np.float32(0.1),
            ddt_velocity_jump=np.float32(1250.0),
            calibration=cal, frame_rate=fps, max_displacement_px=md,
        )

    vm, vmw, vs = P("video", None), P("video", None, None), P("video")
    f = jax.jit(shard_map(
        kernel_scan, mesh=mesh,
        in_specs=(vm, vmw, vmw, vm, vm, vs, vs, vs),
        out_specs=DeviceScanResult(
            final_position=vm, recorded=vm, is_post_ddt=vm,
            search_start=vm, search_end=vm,
            stop_step=vs, stop_reason=vs, ddt_frame=vs, clear_vc_entry=vs,
        ),
        check_vma=False,
    ))
    args = (
        jnp.zeros((V, M), jnp.int32), jnp.zeros((V, M, W), jnp.float32),
        jnp.zeros((V, M, W), jnp.float32), jnp.zeros((V, M), bool),
        jnp.ones((V, M), bool), jnp.ones(V, jnp.float32),
        jnp.full(V, 1e5, jnp.float32), jnp.full(V, 3, jnp.int32),
    )
    low = f.trace(*args).lower(lowering_platforms=("cuda",))
    assert "triton" in low.as_text().lower()
    assert verified_triton
