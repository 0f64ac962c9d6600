"""Fused whole-library path (track/fused.py): parity + routing.

The fused path must be bit-identical to the per-video host scan (the same
contract every backend carries) AND actually engage for eligible groups —
a silent fallback would pass parity while losing the perf property the
driver bench claims.
"""

import numpy as np
import pytest

from hsip_tpu import open_collection, open_video
from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
from hsip_tpu.track import FlameDetectorConfig
from hsip_tpu.track.batch import track_collection_device
from hsip_tpu.track.config import VideoSourceConfig
from hsip_tpu.track.fused import track_uniform_videos_fused
from hsip_tpu.track.scan import track_video


def _write(tmp_path, name, n_frames=40, height=64, width=384, seed=0,
           bit_depth=12):
    flame = FlameSpec(x0=25.0, v0_px=width / (1.4 * n_frames), accel_px=0.0,
                      ignition_frame=2, seed=seed)
    frames, _ = synthesize_flame_video(
        n_frames, height=height, width=width, flame=flame
    )
    spec = CihxSpec(width=width, height=height, total_frames=n_frames,
                    record_rate=100_000, bit_depth=bit_depth)
    return write_recording(tmp_path, name, frames, spec=spec)


def _rows(out):
    return [(r[0], r[2]) for r in out.rows]


def test_fused_engages_and_matches_host_scan(tmp_path, monkeypatch):
    metas = [
        _write(tmp_path, f"nova-run-{i + 1}-001", seed=i) for i in range(3)
    ]
    config = FlameDetectorConfig()

    # Per-video host-scan ground truth.
    expected = []
    for m in metas:
        with open_video(str(m)) as v:
            expected.append(track_video(v, config, 1.0, 0.0, scan="host",
                                        use_absolute_time=True))

    # The fused path must actually run (None would mean silent fallback).
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        outs = track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, None, True,
        )
        assert outs is not None, "eligible group must take the fused path"
        for out, exp in zip(outs, expected):
            assert _rows(out) == _rows(exp)
            assert out.break_reason == exp.break_reason
            assert out.empty_frame_count == exp.empty_frame_count


def test_fused_ragged_lengths_match(tmp_path):
    _write(tmp_path, "nova-run-1-001", n_frames=40, seed=1)
    _write(tmp_path, "nova-run-2-001", n_frames=25, seed=2)
    config = FlameDetectorConfig()
    expected = []
    for name in ("nova-run-1-001", "nova-run-2-001"):
        with open_video(str(tmp_path / f"{name}.cihx")) as v:
            expected.append(track_video(v, config, 1.0, 0.0, scan="host"))
    with open_collection(str(tmp_path)) as coll:
        outs = track_collection_device(coll, config)
    for out, exp in zip(outs, expected):
        assert _rows(out) == _rows(exp)


@pytest.mark.parametrize("method", ["threshold", "half_maximum", "gradient"])
@pytest.mark.parametrize("use_frame_diff", [True, False])
def test_fused_named_methods_match(tmp_path, method, use_frame_diff):
    _write(tmp_path, "nova-run-1-001", seed=3)
    _write(tmp_path, "nova-run-2-001", seed=4)
    config = FlameDetectorConfig()
    sc = VideoSourceConfig(
        name="t", detection_method=method, use_frame_diff=use_frame_diff,
    )
    expected = []
    for name in ("nova-run-1-001", "nova-run-2-001"):
        with open_video(str(tmp_path / f"{name}.cihx")) as v:
            expected.append(track_video(
                v, config, 1.0, 0.0, scan="host",
                detection_method=method, use_frame_diff=use_frame_diff,
            ))
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        outs = track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, sc, True,
        )
    assert outs is not None
    for out, exp in zip(outs, expected):
        assert _rows(out) == _rows(exp)


def test_fused_engages_under_mesh_and_matches(tmp_path):
    """shard_map fused path on the 8-device mesh: V=3 ragged videos pad to
    8 with inert all-empty entries; rows must be byte-identical to the
    per-video host scan (and engagement is asserted — a silent fallback to
    the chunked path would pass parity while losing the one-program
    property)."""
    from hsip_tpu.parallel import make_mesh

    lengths = (40, 25, 33)
    for i, n in enumerate(lengths):
        _write(tmp_path, f"nova-run-{i + 1}-001", n_frames=n, seed=20 + i)
    config = FlameDetectorConfig()
    expected = []
    for i in range(len(lengths)):
        with open_video(str(tmp_path / f"nova-run-{i + 1}-001.cihx")) as v:
            expected.append(track_video(v, config, 1.0, 0.0, scan="host",
                                        use_absolute_time=True))
    mesh = make_mesh("video")
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        outs = track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, None, True, mesh=mesh,
        )
    assert outs is not None, "eligible group must fuse under the mesh too"
    assert len(outs) == len(lengths)
    for out, exp in zip(outs, expected):
        assert _rows(out) == _rows(exp)
        assert out.break_reason == exp.break_reason


def test_fused_multi_axis_mesh_falls_back_to_sharded_put(tmp_path,
                                                         monkeypatch):
    """A mesh with axes beyond the video axis replicates shards across
    devices — the per-shard put train assumes one device per shard, so
    such a mesh must route to the sharded one_put (NamedSharding handles
    any mesh) and stay row-identical to the host scan."""
    import jax
    import numpy as np_
    from jax.sharding import Mesh

    monkeypatch.setenv("HSIP_STAGING", "put_train")
    lengths = (40, 25, 33)
    for i, n in enumerate(lengths):
        _write(tmp_path, f"nova-run-{i + 1}-001", n_frames=n, seed=120 + i)
    config = FlameDetectorConfig()
    expected = []
    for i in range(len(lengths)):
        with open_video(str(tmp_path / f"nova-run-{i + 1}-001.cihx")) as v:
            expected.append(track_video(v, config, 1.0, 0.0, scan="host",
                                        use_absolute_time=True))
    mesh = Mesh(
        np_.array(jax.devices()[:8]).reshape(2, 4), ("video", "aux")
    )
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        outs = track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, None, True, mesh=mesh,
        )
    assert outs is not None
    for out, exp in zip(outs, expected):
        assert _rows(out) == _rows(exp)


@pytest.mark.parametrize("staging", ["one_put", "put_train"])
def test_fused_staging_modes_match(tmp_path, monkeypatch, staging):
    """Both payload calling conventions (ONE batched put vs a per-video
    put train) must be row-identical to the host scan — ragged lengths
    included, so the pad rows a pooled/uninitialized buffer leaves as
    garbage are proven scan-masked. Two back-to-back calls also exercise
    one_put's pooled-buffer reuse."""
    monkeypatch.setenv("HSIP_STAGING", staging)
    lengths = (40, 25, 33)
    for i, n in enumerate(lengths):
        _write(tmp_path, f"nova-run-{i + 1}-001", n_frames=n, seed=40 + i)
    config = FlameDetectorConfig()
    expected = []
    for i in range(len(lengths)):
        with open_video(str(tmp_path / f"nova-run-{i + 1}-001.cihx")) as v:
            expected.append(track_video(v, config, 1.0, 0.0, scan="host",
                                        use_absolute_time=True))
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        for _ in range(2):  # second call reuses the pooled staging buffer
            outs = track_uniform_videos_fused(
                videos, videos[0].frame_shape[1], config, None, True,
            )
            assert outs is not None
            for out, exp in zip(outs, expected):
                assert _rows(out) == _rows(exp)
                assert out.break_reason == exp.break_reason


def test_fused_pipelined_groups_match(tmp_path, monkeypatch):
    """G>1 pipelined sub-batch programs (stage+dispatch group g, then
    gather g+1 while g computes; fetch only at the end) must be
    row-identical to the host scan — per-video results are independent,
    so grouping is output-invariant by construction. The pipeline trace
    must show one record per group, dispatched strictly before the next
    group's gather ends (the overlap window exists)."""
    import hsip_tpu.track.fused as fused_mod

    monkeypatch.setenv("HSIP_FUSED_GROUPS", "3")
    lengths = (40, 25, 33, 37, 29)
    for i, n in enumerate(lengths):
        _write(tmp_path, f"nova-run-{i + 1}-001", n_frames=n, seed=90 + i)
    config = FlameDetectorConfig()
    expected = []
    for i in range(len(lengths)):
        with open_video(str(tmp_path / f"nova-run-{i + 1}-001.cihx")) as v:
            expected.append(track_video(v, config, 1.0, 0.0, scan="host",
                                        use_absolute_time=True))
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        outs = track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, None, True,
        )
    assert outs is not None and len(outs) == len(lengths)
    for out, exp in zip(outs, expected):
        assert _rows(out) == _rows(exp)
        assert out.break_reason == exp.break_reason
        assert out.empty_frame_count == exp.empty_frame_count
    trace = fused_mod._LAST_PIPELINE_TRACE
    assert len(trace) == 3
    for g in range(len(trace) - 1):
        # Group g is dispatched before group g+1's gather starts: the
        # device works under the next group's host staging.
        assert trace[g]["dispatch_t"] <= trace[g + 1]["gather_start_t"]
    # Results are fetched only after every group is in flight.
    assert all("finals_ready_t" in t for t in trace)
    assert trace[0]["finals_ready_t"] >= trace[-1]["dispatch_t"]


def test_fused_group_count_routing(monkeypatch):
    from hsip_tpu.parallel import make_mesh
    from hsip_tpu.track.fused import _fused_group_count

    monkeypatch.setenv("HSIP_FUSED_GROUPS", "4")
    assert _fused_group_count(8, None) == 4
    assert _fused_group_count(3, None) == 3  # clamped to V
    assert _fused_group_count(1, None) == 1
    # Mesh runs keep one sharded dispatch regardless of the override.
    assert _fused_group_count(8, make_mesh("video")) == 1
    monkeypatch.setenv("HSIP_FUSED_GROUPS", "auto")
    import hsip_tpu.track.fused as fused_mod

    monkeypatch.setattr(fused_mod, "_puts_are_lazy", lambda: True)
    assert fused_mod._fused_group_count(8, None) == 1  # wire-bound: 1 train
    monkeypatch.setattr(fused_mod, "_puts_are_lazy", lambda: False)
    assert fused_mod._fused_group_count(8, None) == 4  # staging-bound: pipe


def test_staging_mode_routing(monkeypatch):
    """HSIP_STAGING overrides; auto resolves to the put train on BOTH
    link families and under a mesh (where it means PER-SHARD trains —
    the r4 wire finding: concurrency of in-flight transfers, not put
    size, sets the rate; one sharded put forfeits it)."""
    from hsip_tpu.parallel import make_mesh
    from hsip_tpu.track.fused import _staging_mode

    monkeypatch.setenv("HSIP_STAGING", "put_train")
    assert _staging_mode(None) == "put_train"
    assert _staging_mode(make_mesh("video")) == "put_train"
    monkeypatch.setenv("HSIP_STAGING", "one_put")
    assert _staging_mode(None) == "one_put"
    monkeypatch.setenv("HSIP_STAGING", "auto")
    assert _staging_mode(None) == "put_train"
    assert _staging_mode(make_mesh("video")) == "put_train"


def test_clip_skips_dark_ranges_bit_identically(tmp_path, monkeypatch):
    """Videos with long dark preambles ship only their non-empty range
    (the reference merely skips PROCESSING dark frames,
    process_videos.py:743-763 — the fused path also skips their wire and
    device compute) with rows byte-identical to the host scan. A fully
    dark video rides along (nothing ships for it)."""
    import hsip_tpu.track.fused as fused_mod

    monkeypatch.setenv("HSIP_STAGING", "one_put")
    # Ignition deep into the recording: a ~60% dark preamble.
    specs = [(64, 40, 50), (64, 44, 51)]
    for i, (n, ign, seed) in enumerate(specs):
        flame = FlameSpec(x0=25.0, v0_px=384 / 30, accel_px=0.0,
                          ignition_frame=ign, seed=seed)
        frames, _ = synthesize_flame_video(n, height=64, width=384,
                                           flame=flame)
        spec = CihxSpec(width=384, height=64, total_frames=n,
                        record_rate=100_000, bit_depth=12)
        write_recording(tmp_path, f"nova-run-{i + 1}-001", frames, spec=spec)
    # All-dark rider: zero frames of signal end to end.
    dark = np.zeros((64, 64, 384), np.uint16)
    write_recording(tmp_path, "nova-run-3-001", dark,
                    spec=CihxSpec(width=384, height=64, total_frames=64,
                                  record_rate=100_000, bit_depth=12))
    config = FlameDetectorConfig()
    expected = []
    for i in range(3):
        with open_video(str(tmp_path / f"nova-run-{i + 1}-001.cihx")) as v:
            expected.append(track_video(v, config, 1.0, 0.0, scan="host",
                                        use_absolute_time=True))
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        outs = track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, None, True,
        )
    assert outs is not None
    assert fused_mod._LAST_CLIPPED, "dark-preamble batch must take the clip"
    for out, exp in zip(outs, expected):
        assert _rows(out) == _rows(exp)
        assert out.break_reason == exp.break_reason
        assert out.empty_frame_count == exp.empty_frame_count
    assert not outs[2].rows  # the all-dark video records nothing

    # Dense batch: the clip must stand down (ship-everything is zero-copy).
    for f in tmp_path.glob("nova-run-*"):
        f.unlink()
    _write(tmp_path, "nova-run-1-001", seed=60)
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        outs = track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, None, True,
        )
    assert outs is not None and outs[0].rows
    assert not fused_mod._LAST_CLIPPED


def test_clip_under_put_train_matches(tmp_path, monkeypatch):
    """The put train clips too when puts are lazy: the full-length lazy
    puts are dropped untransferred and the clipped per-video slices ship
    instead — rows identical to the host scan, dark rider included."""
    import hsip_tpu.track.fused as fused_mod

    monkeypatch.setenv("HSIP_STAGING", "put_train")
    monkeypatch.setattr(fused_mod, "_puts_are_lazy", lambda: True)
    specs = [(64, 40, 80), (64, 44, 81)]
    for i, (n, ign, seed) in enumerate(specs):
        flame = FlameSpec(x0=25.0, v0_px=384 / 30, accel_px=0.0,
                          ignition_frame=ign, seed=seed)
        frames, _ = synthesize_flame_video(n, height=64, width=384,
                                           flame=flame)
        spec = CihxSpec(width=384, height=64, total_frames=n,
                        record_rate=100_000, bit_depth=12)
        write_recording(tmp_path, f"nova-run-{i + 1}-001", frames, spec=spec)
    dark = np.zeros((64, 64, 384), np.uint16)
    write_recording(tmp_path, "nova-run-3-001", dark,
                    spec=CihxSpec(width=384, height=64, total_frames=64,
                                  record_rate=100_000, bit_depth=12))
    config = FlameDetectorConfig()
    expected = []
    for i in range(3):
        with open_video(str(tmp_path / f"nova-run-{i + 1}-001.cihx")) as v:
            expected.append(track_video(v, config, 1.0, 0.0, scan="host",
                                        use_absolute_time=True))
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        outs = track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, None, True,
        )
    assert outs is not None
    assert fused_mod._LAST_CLIPPED, "lazy put train must take the clip"
    for out, exp in zip(outs, expected):
        assert _rows(out) == _rows(exp)
        assert out.break_reason == exp.break_reason
    assert not outs[2].rows


def test_clip_env_knob_disables(tmp_path, monkeypatch):
    import hsip_tpu.track.fused as fused_mod

    monkeypatch.setenv("HSIP_STAGING", "one_put")
    monkeypatch.setenv("HSIP_CLIP_EMPTY", "off")
    flame = FlameSpec(x0=25.0, v0_px=384 / 20, accel_px=0.0,
                      ignition_frame=44, seed=52)
    frames, _ = synthesize_flame_video(64, height=64, width=384, flame=flame)
    write_recording(tmp_path, "nova-run-1-001", frames,
                    spec=CihxSpec(width=384, height=64, total_frames=64,
                                  record_rate=100_000, bit_depth=12))
    config = FlameDetectorConfig()
    with open_video(str(tmp_path / "nova-run-1-001.cihx")) as v:
        exp = track_video(v, config, 1.0, 0.0, scan="host",
                          use_absolute_time=True)
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        outs = track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, None, True,
        )
    assert outs is not None and not fused_mod._LAST_CLIPPED
    assert _rows(outs[0]) == _rows(exp)


def test_clip_under_mesh_matches(tmp_path, monkeypatch):
    """Clipped payload + sharded put + shard_map program: rows identical
    to the host scan (pad videos ride as inert clip rows)."""
    from hsip_tpu.parallel import make_mesh

    import hsip_tpu.track.fused as fused_mod

    monkeypatch.setenv("HSIP_STAGING", "one_put")
    for i, (ign, seed) in enumerate(((40, 70), (46, 71), (42, 72))):
        flame = FlameSpec(x0=25.0, v0_px=384 / 30, accel_px=0.0,
                          ignition_frame=ign, seed=seed)
        frames, _ = synthesize_flame_video(64, height=64, width=384,
                                           flame=flame)
        write_recording(
            tmp_path, f"nova-run-{i + 1}-001", frames,
            spec=CihxSpec(width=384, height=64, total_frames=64,
                          record_rate=100_000, bit_depth=12))
    config = FlameDetectorConfig()
    expected = []
    for i in range(3):
        with open_video(str(tmp_path / f"nova-run-{i + 1}-001.cihx")) as v:
            expected.append(track_video(v, config, 1.0, 0.0, scan="host",
                                        use_absolute_time=True))
    mesh = make_mesh("video")
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        outs = track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, None, True, mesh=mesh,
        )
    assert outs is not None and fused_mod._LAST_CLIPPED
    for out, exp in zip(outs, expected):
        assert _rows(out) == _rows(exp)


def test_fused_env_knob_disables(tmp_path, monkeypatch):
    _write(tmp_path, "nova-run-1-001")
    monkeypatch.setenv("HSIP_FUSED", "0")
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        assert track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], FlameDetectorConfig(), None,
            True,
        ) is None
        # The collection entry still tracks via the general path.
        outs = track_collection_device(coll, FlameDetectorConfig())
        assert outs and outs[0].rows


def test_fused_declines_skip_frames(tmp_path):
    _write(tmp_path, "nova-run-1-001")
    sc = VideoSourceConfig(name="t", skip_frames=[3, 4])
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        assert track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], FlameDetectorConfig(), sc,
            True,
        ) is None


def test_fused_declines_even_kernel_folding_band(tmp_path):
    # height 16 folds the default-sigma band; k=4 is the exactness trap.
    _write(tmp_path, "nova-run-1-001", height=16)
    config = FlameDetectorConfig(morphology_kernel_size=4)
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        assert track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], config, None, True,
        ) is None


def test_fused_stage_attribution(tmp_path):
    from hsip_tpu.utils import StageTimes

    _write(tmp_path, "nova-run-1-001")
    _write(tmp_path, "nova-run-2-001", seed=9)
    st = StageTimes()
    with open_collection(str(tmp_path)) as coll:
        outs = track_collection_device(
            coll, FlameDetectorConfig(), stage_times=st
        )
    assert outs and all(o.rows for o in outs)
    stages = st.as_dict()
    for key in ("read_gather", "h2d", "device_dispatch", "d2h", "tables"):
        assert key in stages, stages
    # The fused native gather+count staging pass folds the counts into
    # read_gather: no separate counts_host stage should be paid when the
    # native codec carries the fused symbols (the host staging payload is
    # swept ONCE).
    from hsip_tpu._native import native_decoder

    dec = native_decoder()
    if dec is not None and dec.has_gather_count:
        assert "counts_host" not in stages, stages


def test_fused_budget_from_device_memory_stats(tmp_path, monkeypatch):
    """The fused budget is a stated fraction of the device's reported
    bytes_limit: a library over it takes the chunked path, and an
    accelerator that reports no stats is an error (no assumed size). A
    CPU device's budget is the same fraction of host RAM."""
    import jax

    import hsip_tpu.track.fused as fused

    assert fused._max_fused_bytes() > 0  # the real CPU device

    class FakeDevice:
        platform, device_kind = "gpu", "Fake GPU"

        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    def use(stats):
        monkeypatch.setattr(jax, "local_devices",
                            lambda *a, **k: [FakeDevice(stats)])

    use({"bytes_limit": 64 << 30, "bytes_in_use": 0})
    assert fused._max_fused_bytes() == int(
        (64 << 30) * fused._FUSED_MEMORY_FRACTION
    )
    use(None)
    with pytest.raises(RuntimeError, match="memory stats"):
        fused._max_fused_bytes()

    for i in range(2):
        _write(tmp_path, f"budget-run-{i + 1}-a", seed=i)
    use({"bytes_limit": 1 << 20})  # far below two recordings' footprint
    with open_collection(str(tmp_path)) as coll:
        videos = list(coll)
        assert track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], FlameDetectorConfig(), None,
            True,
        ) is None
