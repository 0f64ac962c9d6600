"""IO layer tests: CIHX/CIH parsing, 12-bit packing, MRAW round-trips."""

from datetime import datetime

import numpy as np
import pytest

from hsip_tpu.io import (
    CihxSpec,
    MRAWReader,
    frame_nbytes,
    pack_12bit,
    parse_cihx_xml,
    read_cih_header,
    read_cihx_header,
    synthesize_flame_video,
    unpack_12bit,
    write_cih,
    write_cihx,
    write_mraw,
    write_recording,
)


# ---------------------------------------------------------------------------
# 12-bit packing
# ---------------------------------------------------------------------------


def test_pack_unpack_roundtrip_random():
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 4096, size=2048, dtype=np.uint16)
    packed = pack_12bit(pixels)
    assert packed.dtype == np.uint8
    assert packed.size == pixels.size * 3 // 2
    np.testing.assert_array_equal(unpack_12bit(packed), pixels)


def test_unpack_12bit_golden_bytes():
    # Hand-built pattern: pixels 0xABC, 0xDEF pack to bytes AB CD EF (MSB-first).
    packed = np.array([0xAB, 0xCD, 0xEF], dtype=np.uint8)
    np.testing.assert_array_equal(
        unpack_12bit(packed), np.array([0xABC, 0xDEF], dtype=np.uint16)
    )
    # Extremes.
    packed = np.array([0xFF, 0xF0, 0x00], dtype=np.uint8)
    np.testing.assert_array_equal(
        unpack_12bit(packed), np.array([0xFFF, 0x000], dtype=np.uint16)
    )


def test_pack_12bit_rejects_out_of_range():
    with pytest.raises(ValueError):
        pack_12bit(np.array([4096, 0], dtype=np.uint16))
    with pytest.raises(ValueError):
        pack_12bit(np.array([1, 2, 3], dtype=np.uint16))  # odd count


def test_frame_nbytes():
    assert frame_nbytes(128, 64, 8) == 128 * 64
    assert frame_nbytes(128, 64, 12) == 128 * 64 * 3 // 2
    assert frame_nbytes(128, 64, 16) == 128 * 64 * 2
    assert frame_nbytes(128, 64, 10) == 128 * 64 * 5 // 4
    with pytest.raises(ValueError):
        frame_nbytes(3, 3, 12)  # odd pixel count can't pack
    with pytest.raises(ValueError):
        frame_nbytes(2, 3, 10)  # not a multiple of 4
    with pytest.raises(ValueError):
        frame_nbytes(128, 64, 14)


# ---------------------------------------------------------------------------
# CIHX / CIH headers
# ---------------------------------------------------------------------------


def _spec(**kw):
    defaults = dict(width=256, height=64, total_frames=10, record_rate=100_000)
    defaults.update(kw)
    return CihxSpec(**defaults)


def test_parse_cihx_xml_fields(tmp_path):
    spec = _spec(
        start_frame=-50,
        skip_frame=2,
        recorded_frame=5000,
        shutter_speed_ns=2500,
        irig=1,
        date="2023/10/4",
        time="14:29:21",
    )
    path = write_cihx(tmp_path / "test.cihx", spec)
    meta = parse_cihx_xml(path)
    assert meta["record_rate"] == 100_000
    assert meta["start_frame"] == -50
    assert meta["skip_frame"] == 2
    assert meta["recorded_frame"] == 5000
    assert meta["total_frame"] == 10
    assert meta["shutter_speed_ns"] == 2500
    assert meta["irig_enabled"] is True
    assert meta["recording_datetime"] == datetime(2023, 10, 4, 14, 29, 21)


def test_parse_cihx_xml_missing_xml_returns_defaults(tmp_path):
    path = tmp_path / "garbage.cihx"
    path.write_bytes(b"\x00\x01\x02 not xml at all")
    meta = parse_cihx_xml(path)
    assert meta["record_rate"] == 0
    assert meta["recording_datetime"] is None
    assert meta["skip_frame"] == 1


def test_parse_cihx_xml_malformed_xml_returns_defaults(tmp_path):
    path = tmp_path / "broken.cihx"
    path.write_bytes(b"junk<?xml version='1.0'?><cih><unclosed></cih>")
    meta = parse_cihx_xml(path)
    assert meta["record_rate"] == 0


def test_read_cihx_header_geometry(tmp_path):
    spec = _spec(bit_depth=12, device_name="FASTCAM Nova S12")
    path = write_cihx(tmp_path / "geo.cihx", spec)
    info = read_cihx_header(path)
    assert info["Image Width"] == 256
    assert info["Image Height"] == 64
    assert info["EffectiveBit Depth"] == 12
    assert info["Total Frame"] == 10
    assert info["Record Rate(fps)"] == 100_000
    assert info["Camera Type"] == "FASTCAM Nova S12"
    assert info["File Format"] == "MRaw"
    assert abs(info["Shutter Speed(s)"] - 2e-6) < 1e-12


def test_read_cih_header(tmp_path):
    spec = _spec(bit_depth=16, trigger_frame=3)
    path = write_cih(tmp_path / "test.cih", spec)
    info = read_cih_header(path)
    assert info["Image Width"] == 256
    assert info["Record Rate(fps)"] == 100_000
    assert info["EffectiveBit Depth"] == 16
    assert info["Trigger Frame"] == 3
    assert info["Total Frame"] == 10


# ---------------------------------------------------------------------------
# MRAWReader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bit_depth", [8, 12, 16])
def test_mraw_reader_roundtrip(tmp_path, bit_depth):
    rng = np.random.default_rng(bit_depth)
    maxval = (1 << bit_depth) - 1
    frames = rng.integers(0, maxval + 1, size=(6, 32, 48), dtype=np.uint16)
    path = write_mraw(tmp_path / "t.mraw", frames, bit_depth=bit_depth)
    reader = MRAWReader(path, width=48, height=32, bit_depth=bit_depth)
    assert len(reader) == 6
    np.testing.assert_array_equal(reader.read_frame(0), frames[0])
    np.testing.assert_array_equal(reader.read_frame(-1), frames[-1])
    np.testing.assert_array_equal(reader.read_frames(slice(1, 4)), frames[1:4])
    np.testing.assert_array_equal(reader.read_frames(slice(None, None, 2)), frames[::2])


def test_mraw_reader_bounds_and_close(tmp_path):
    frames = np.zeros((3, 8, 16), dtype=np.uint16)
    path = write_mraw(tmp_path / "b.mraw", frames, bit_depth=16)
    reader = MRAWReader(path, width=16, height=8, bit_depth=16)
    with pytest.raises(IndexError):
        reader.read_frame(3)
    reader.close()
    with pytest.raises(ValueError):
        reader.read_frame(0)


def test_mraw_reader_total_frames_exceeds_file(tmp_path):
    frames = np.zeros((3, 8, 16), dtype=np.uint16)
    path = write_mraw(tmp_path / "c.mraw", frames, bit_depth=16)
    with pytest.raises(ValueError):
        MRAWReader(path, width=16, height=8, bit_depth=16, total_frames=10)


def test_frame_bytes_staging_path(tmp_path):
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 4096, size=(4, 16, 32), dtype=np.uint16)
    path = write_mraw(tmp_path / "s.mraw", frames, bit_depth=12)
    reader = MRAWReader(path, width=32, height=16, bit_depth=12)
    raw = reader.frame_bytes(1, 3)
    assert raw.shape == (2, frame_nbytes(32, 16, 12))
    decoded = unpack_12bit(np.ascontiguousarray(raw).reshape(-1)).reshape(2, 16, 32)
    np.testing.assert_array_equal(decoded, frames[1:3])


# ---------------------------------------------------------------------------
# Synthetic flame generator sanity
# ---------------------------------------------------------------------------


def test_synthetic_flame_positions_monotone():
    frames, positions = synthesize_flame_video(20, height=32, width=256)
    assert frames.shape == (20, 32, 256)
    valid = positions[np.isfinite(positions)]
    assert len(valid) > 10
    assert np.all(np.diff(valid) > 0)  # moves right
    # Bright plateau left of front, dark right of front.
    i = 10
    pos = int(positions[i])
    assert frames[i, 16, max(0, pos - 20)] > 2000
    assert frames[i, 16, min(255, pos + 20)] < 200


def test_write_recording_full_roundtrip(tmp_path):
    frames, _ = synthesize_flame_video(8, height=32, width=128)
    meta = write_recording(tmp_path, "rec", frames, record_rate=50_000)
    assert meta.suffix == ".cihx"
    assert (tmp_path / "rec.mraw").exists()
    info = read_cihx_header(meta)
    assert info["Total Frame"] == 8
    reader = MRAWReader(
        tmp_path / "rec.mraw", width=128, height=32, bit_depth=12
    )
    np.testing.assert_array_equal(reader.read_frames(slice(0, 8)), frames)


def test_band_bytes_and_count_above(tmp_path):
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 4096, size=(6, 32, 64), dtype=np.uint16)
    path = write_mraw(tmp_path / "band.mraw", frames, bit_depth=12)
    reader = MRAWReader(path, width=64, height=32, bit_depth=12)

    rows = np.array([0, 15, 16, 31])
    band = reader.band_bytes(1, 4, rows)
    assert band.shape == (3, 4, 64 * 3 // 2)
    decoded = unpack_12bit(np.ascontiguousarray(band).reshape(-1)).reshape(3, 4, 64)
    np.testing.assert_array_equal(decoded, frames[1:4][:, rows, :])

    # Native C++ gather (when built) must match the numpy fancy-index path.
    if reader._native is not None:
        native = reader._native
        reader._native = None
        try:
            np.testing.assert_array_equal(
                band, reader.band_bytes(1, 4, rows)
            )
        finally:
            reader._native = native

    counts = reader.count_above(0, 6, background=100.0, threshold=500.0)
    if counts is None:
        pytest.skip("native codec unavailable")
    expected = [
        int((np.maximum(f.astype(np.float64) - 100.0, 0) > 500.0).sum())
        for f in frames
    ]
    np.testing.assert_array_equal(counts, expected)

    # 16-bit containers also have a native fused count.
    path16 = write_mraw(tmp_path / "b16.mraw", frames, bit_depth=16)
    r16 = MRAWReader(path16, width=64, height=32, bit_depth=16)
    c16 = r16.count_above(0, 2, background=100.0, threshold=500.0)
    assert c16 is not None  # native availability already established above
    expected16 = [
        int((np.maximum(f.astype(np.float64) - 100.0, 0) > 500.0).sum())
        for f in frames[:2]
    ]
    np.testing.assert_array_equal(c16, expected16)
    assert r16.row_nbytes == 128
    # 8-bit: the bytes ARE the pixels, and the fused count covers them too.
    frames8 = np.clip(frames, 0, 255)
    path8 = write_mraw(tmp_path / "b8.mraw", frames8, bit_depth=8)
    r8 = MRAWReader(path8, width=64, height=32, bit_depth=8)
    c8 = r8.count_above(0, 2, background=20.0, threshold=30.0)
    if r8._native is not None and not r8._native.has_count8:
        # The documented stale-.so degradation: a cached library without
        # the count_above8 symbol turns only this rung off. Any OTHER
        # reason for a missing count is a regression and must fail below.
        assert c8 is None
        pytest.skip("native library lacks count_above8 (stale build)")
    assert c8 is not None
    expected8 = [
        int((np.maximum(f.astype(np.float64) - 20.0, 0) > 30.0).sum())
        for f in frames8[:2]
    ]
    np.testing.assert_array_equal(c8, expected8)


@pytest.mark.parametrize("bit_depth", [8, 10, 12, 16])
def test_band_bytes_and_counts_fused_pass(tmp_path, bit_depth):
    """The fused native staging pass (ONE sweep: band rows + counts) must
    be byte/value-identical to band_bytes + count_above."""
    rng = np.random.default_rng(11)
    hi = min(4096, 2 ** bit_depth)
    frames = rng.integers(0, hi, size=(7, 24, 64), dtype=np.uint16)
    path = write_mraw(tmp_path / f"fb{bit_depth}.mraw", frames,
                      bit_depth=bit_depth)
    reader = MRAWReader(path, width=64, height=24, bit_depth=bit_depth)
    if reader._native is None or not reader._native.has_gather_count:
        assert reader.band_bytes_and_counts(
            0, 7, np.array([0, 12]), 10.0, 20.0
        ) is None
        pytest.skip("native fused gather+count unavailable")

    rows = np.array([0, 11, 12, 23])
    bg, thr = 10.0, 30.0
    res = reader.band_bytes_and_counts(1, 5, rows, bg, thr)
    assert res is not None
    band, counts = res
    np.testing.assert_array_equal(band, reader.band_bytes(1, 5, rows))
    np.testing.assert_array_equal(counts, reader.count_above(1, 5, bg, thr))

    # `out=` gathers straight into a caller slice (the library staging
    # shape) and returns the same values.
    big = np.zeros((2, 6, rows.size, reader.row_nbytes), np.uint8)
    band2, counts2 = reader.band_bytes_and_counts(
        0, 6, rows, bg, thr, out=big[1]
    )
    assert np.shares_memory(band2, big)
    np.testing.assert_array_equal(band2, reader.band_bytes(0, 6, rows))
    np.testing.assert_array_equal(counts2, reader.count_above(0, 6, bg, thr))

    # Row bounds validate exactly like band_bytes; stop past EOF truncates.
    with pytest.raises(ValueError):
        reader.band_bytes_and_counts(0, 4, np.array([24]), bg, thr)
    band3, counts3 = reader.band_bytes_and_counts(5, 99, rows, bg, thr)
    assert band3.shape[0] == 2 and counts3.shape == (2,)


def test_write_recording_packs_at_storage_depth(tmp_path):
    """A 12-effective-bits-in-16-bit-words spec (color_bit=16) must
    round-trip: the payload packs at the STORAGE depth the header
    advertises (regression: it packed at the effective depth and the
    reader saw a truncated file)."""
    from hsip_tpu import open_video
    from hsip_tpu.io import CihxSpec, write_recording

    rng = np.random.default_rng(3)
    frames = rng.integers(0, 4096, size=(6, 16, 64), dtype=np.uint16)
    meta = write_recording(
        tmp_path, "cb-run-1-a", frames,
        spec=CihxSpec(width=64, height=16, total_frames=6, bit_depth=12,
                      color_bit=16),
    )
    with open_video(str(meta)) as v:
        assert len(v) == 6
        np.testing.assert_array_equal(v[3], frames[3])
        assert v.bit_depth == 12  # effective depth for normalization
        f64 = v.to_float64(normalize=True)
        assert np.isfinite(f64[3]).all()
        assert f64[3].max() <= 1.0 and f64[3].max() > 0.5  # /4095, not /65535


def test_write_recording_rejects_mismatched_spec(tmp_path):
    from hsip_tpu.io import CihxSpec, write_recording

    frames = np.zeros((4, 8, 16), dtype=np.uint16)
    with pytest.raises(ValueError, match="geometry"):
        write_recording(tmp_path, "bad", frames,
                        spec=CihxSpec(width=99, height=8, total_frames=4))
    with pytest.raises(ValueError, match="spec_overrides"):
        write_recording(tmp_path, "bad2", frames,
                        spec=CihxSpec(width=16, height=8, total_frames=4),
                        record_rate=500)


def test_cihx_xml_escapes_metacharacters(tmp_path):
    from hsip_tpu.io import CihxSpec, read_cihx_header, write_cihx

    spec = CihxSpec(width=16, height=8, total_frames=2,
                    comment="P&ID <test> \"quoted\"",
                    device_name="Cam & Co <X>")
    path = write_cihx(tmp_path / "esc.cihx", spec)
    info = read_cihx_header(path)
    assert info["Total Frame"] == 2  # parsed despite metacharacters


def test_cih_malformed_numeric_values_omitted(tmp_path, capsys):
    """Garbage numerics must be OMITTED (with a warning), not coerced to 0 —
    an absent Total Frame falls back to inferring the count from the
    payload size; a 0 silently produced an empty video."""
    from hsip_tpu import open_video
    from hsip_tpu.io import write_mraw

    rng = np.random.default_rng(1)
    frames = rng.integers(0, 4096, size=(5, 8, 32), dtype=np.uint16)
    write_mraw(tmp_path / "m.mraw", frames, bit_depth=12)
    (tmp_path / "m.cih").write_text(
        "#Camera Information Header\n"
        "Record Rate(fps) : 1000\n"
        "Total Frame : N/A\n"
        "Image Width : 32\n"
        "Image Height : 8\n"
        "EffectiveBit Depth : twelve\n"
        "Color Bit : 12\n"
        "END\n"
    )
    with open_video(str(tmp_path / "m.cih")) as v:
        assert len(v) == 5  # inferred from payload size
        np.testing.assert_array_equal(v[2], frames[2])
        assert v.bit_depth == 12  # Color Bit fallback, not 16 / not 0
        assert np.isfinite(v.to_float64()[0]).all()
    assert "malformed .cih value" in capsys.readouterr().out


def test_flame_level_saturates_instead_of_wrapping():
    from hsip_tpu.io import FlameSpec, synthesize_flame_video

    frames, _ = synthesize_flame_video(
        6, height=8, width=64,
        flame=FlameSpec(flame_level=65500, ignition_frame=1),
        bit_depth=16,
    )
    lit = frames[3]
    # Plateau clamps at the container max; never darker than background.
    assert lit.max() == 65535
    assert lit[:, 0].min() > 30  # left edge is lit, not wrapped to ~5


def test_band_bytes_backend_consistency(tmp_path):
    """Native and numpy band gathers must agree on edge inputs: negative
    rows raise on BOTH paths; stop past EOF truncates on BOTH."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 4096, size=(4, 16, 64), dtype=np.uint16)
    path = write_mraw(tmp_path / "b.mraw", frames, bit_depth=12)
    reader = MRAWReader(path, width=64, height=16, bit_depth=12)
    rows = np.array([0, 7, 15])
    for native in (reader._native, None):
        saved, reader._native = reader._native, native
        try:
            with pytest.raises(ValueError, match="row indices"):
                reader.band_bytes(0, 4, np.array([-1]))
            with pytest.raises(ValueError, match="row indices"):
                reader.band_bytes(0, 4, np.array([16]))
            band = reader.band_bytes(2, 99, rows)  # stop past EOF truncates
            assert band.shape == (2, 3, 96)
        finally:
            reader._native = saved


def test_band_bytes_gathers_into_out_buffer(tmp_path):
    """``out=`` gathers straight into a caller slice (the fused library
    path's batched staging buffer): bytes identical to the allocating
    call on BOTH backends; wrong-shaped buffers rejected by the native
    path before the C++ write."""
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 4096, size=(5, 16, 64), dtype=np.uint16)
    path = write_mraw(tmp_path / "o.mraw", frames, bit_depth=12)
    reader = MRAWReader(path, width=64, height=16, bit_depth=12)
    rows = np.array([0, 7, 15])
    expected = reader.band_bytes(0, 5, rows)
    for native in (reader._native, None):
        saved, reader._native = reader._native, native
        try:
            # One video's slice of a larger batched buffer (n_max pad).
            big = np.zeros((2, 7, 3, 96), np.uint8)
            got = reader.band_bytes(0, 5, rows, out=big[1, :5])
            np.testing.assert_array_equal(got, expected)
            np.testing.assert_array_equal(big[1, :5], expected)
            assert not big[0].any() and not big[1, 5:].any()
            if native is not None:
                with pytest.raises(ValueError, match="out must"):
                    reader.band_bytes(0, 5, rows,
                                      out=np.zeros((5, 3, 95), np.uint8))
        finally:
            reader._native = saved


def test_cih_and_cihx_agree_on_original_total_frame(tmp_path):
    """Both metadata dialects must map 'Original Total Frame' from the
    camera's RECORDED count (frameInfo/recordedFrame), not the saved count."""
    from hsip_tpu.io import CihxSpec, read_header, write_cih, write_cihx

    spec = CihxSpec(width=64, height=32, total_frames=100, recorded_frame=5000)
    a = read_header(write_cihx(tmp_path / "x.cihx", spec))
    b = read_header(write_cih(tmp_path / "x.cih", spec))
    assert a["Original Total Frame"] == b["Original Total Frame"] == 5000
    assert a["Total Frame"] == b["Total Frame"] == 100


def test_native_pack_matches_numpy_and_validates():
    """The native pack twins must be byte-identical to the numpy packers and
    enforce the same out-of-range ValueError (the C++ packer would silently
    bleed high bits)."""
    from hsip_tpu.io.mraw import pack_10bit, pack_12bit

    try:
        from hsip_tpu._native import native_decoder

        d = native_decoder()
    except Exception:
        pytest.skip("native codec unavailable")
    rng = np.random.default_rng(5)
    px12 = rng.integers(0, 4096, 6000, dtype=np.uint16)
    assert np.array_equal(d.pack_12bit(px12), pack_12bit(px12))
    px10 = rng.integers(0, 1024, 6000, dtype=np.uint16)
    assert np.array_equal(d.pack_10bit(px10), pack_10bit(px10))
    with pytest.raises(ValueError, match="4096"):
        d.pack_12bit(np.array([5000, 0], dtype=np.uint16))
    with pytest.raises(ValueError, match="1024"):
        d.pack_10bit(np.array([1500, 0, 0, 0], dtype=np.uint16))


def test_find_mraw_payload_any_case(tmp_path):
    from hsip_tpu.io.mraw import find_mraw_payload

    (tmp_path / "rec.cihx").write_bytes(b"x")
    (tmp_path / "rec.mRAW").write_bytes(b"y")
    assert find_mraw_payload(tmp_path / "rec.cihx").name == "rec.mRAW"


def test_record_rate_device_info_fallback_in_header(tmp_path):
    """read_cihx_header gets the deviceInfo/recordRate fallback the timing
    view already had (the two parsers of one document must not drift)."""
    from hsip_tpu.io import read_header

    xml = (b"<?xml version='1.0'?><cih><frameInfo><totalFrame>5</totalFrame>"
           b"</frameInfo><imageDataInfo><resolution><width>8</width>"
           b"<height>8</height></resolution></imageDataInfo>"
           b"<deviceInfo><recordRate>7000</recordRate></deviceInfo></cih>")
    (tmp_path / "fb.cihx").write_bytes(b"CIHX\x00\x00" + xml)
    info = read_header(tmp_path / "fb.cihx")
    assert info["Record Rate(fps)"] == 7000
