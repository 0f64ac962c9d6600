"""Band-chain parity: batched band preprocess vs host float64 reference ops."""

import numpy as np
import pytest

from hsip_tpu.io import FlameSpec, synthesize_flame_video
from hsip_tpu.kernels import reference as ref
from hsip_tpu.kernels.preprocess import (
    band_margin,
    batch_centerline_profiles,
    reflect_indices,
)


def host_profiles(sub_curr, sub_prior, k, sigma, threshold):
    """Full-frame float64 chain (the validated scipy-parity path)."""
    diff = sub_curr - sub_prior
    diff[diff < threshold] = 0
    opened = ref.grey_opening(diff, (k, k))
    blurred = ref.gaussian_filter(opened, sigma)
    c = sub_curr.shape[0] // 2
    return ref.sobel(blurred, axis=1)[c], ref.gradient_x(blurred)[c]


def test_band_margin_default():
    assert band_margin(3, 1.5) == 9  # (3-1) + int(6.5) + 1


def test_reflect_indices_identity_and_fold():
    np.testing.assert_array_equal(
        reflect_indices(10, 2, 64), np.array([8, 9, 10, 11, 12])
    )
    # Fold at top edge: rows -2, -1 reflect to 1, 0.
    np.testing.assert_array_equal(
        reflect_indices(0, 2, 64), np.array([1, 0, 0, 1, 2])
    )
    # Fold at bottom.
    np.testing.assert_array_equal(
        reflect_indices(63, 2, 64), np.array([61, 62, 63, 63, 62])
    )


@pytest.mark.parametrize("height,width", [(48, 256), (64, 640), (12, 128)])
def test_batch_profiles_match_host_reference(height, width):
    """Band-optimized batched f32 profiles must match full-frame f64 host ops
    to float32 precision, for tall and short (band-folding) frames."""
    flame = FlameSpec(x0=20.0, v0_px=5.0, ignition_frame=1, seed=11)
    frames, _ = synthesize_flame_video(10, height=height, width=width, flame=flame)
    bg = float(np.max(frames[0]))
    k, sigma, thresh = 3, 1.5, 5.0

    prior_index = np.arange(-1, 9, dtype=np.int32)  # chain: i-1, first has none
    sob, grad, intens, rawc, counts = batch_centerline_profiles(
        frames.astype(np.float32),
        np.float32(bg),
        prior_index,
        np.float32(thresh),
        np.float32(max(10.0, bg * 0.5)),
        morphology_kernel_size=k,
        gaussian_sigma=sigma,
    )
    sob, grad, counts = np.array(sob), np.array(grad), np.array(counts)
    intens, rawc = np.array(intens), np.array(rawc)

    for i in range(1, 10):
        sub_curr = ref.subtract_scalar_background(frames[i], bg)
        sub_prior = ref.subtract_scalar_background(frames[i - 1], bg)
        h_sob, h_grad = host_profiles(sub_curr, sub_prior, k, sigma, thresh)
        scale = max(1.0, np.abs(h_sob).max())
        np.testing.assert_allclose(sob[i], h_sob, atol=2e-3 * scale, rtol=1e-4)
        scale_g = max(1.0, np.abs(h_grad).max())
        np.testing.assert_allclose(grad[i], h_grad, atol=2e-3 * scale_g, rtol=1e-4)

    # Frame 0 has no prior: zeros (intensity too); raw center always present.
    assert np.all(sob[0] == 0) and np.all(grad[0] == 0) and np.all(intens[0] == 0)
    c = height // 2
    np.testing.assert_allclose(
        rawc[0], np.maximum(frames[0, c].astype(np.float64) - bg, 0.0), atol=1e-3
    )

    # Empty-frame counts match the host computation exactly.
    for i in range(10):
        sub = ref.subtract_scalar_background(frames[i], bg)
        expected = int(np.sum(sub > max(10.0, bg * 0.5)))
        assert int(counts[i]) == expected


def test_batch_profiles_positions_match_host_decisions():
    """The f32 band path must produce the SAME argmin/rightmost decisions as
    the f64 host path across a long synthetic run (ties are the only risk)."""
    flame = FlameSpec(x0=30.0, v0_px=6.0, accel_px=0.2, ignition_frame=2, seed=5)
    frames, _ = synthesize_flame_video(30, height=48, width=512, flame=flame)
    bg = float(np.max(frames[0]))
    prior_index = np.arange(-1, 29, dtype=np.int32)
    sob, grad, _intens, _rawc, _ = batch_centerline_profiles(
        frames.astype(np.float32), np.float32(bg), prior_index,
        np.float32(5.0), np.float32(max(10.0, bg * 0.5)),
    )
    sob, grad = np.array(sob), np.array(grad)
    for i in range(1, 30):
        sub_curr = ref.subtract_scalar_background(frames[i], bg)
        sub_prior = ref.subtract_scalar_background(frames[i - 1], bg)
        h_sob, h_grad = host_profiles(sub_curr, sub_prior, 3, 1.5, 5.0)
        if np.min(h_grad) < -10.0:
            assert int(np.argmin(grad[i])) == int(np.argmin(h_grad)), f"frame {i}"
        smax = np.max(np.abs(h_sob))
        if smax > 10.0:
            h_above = np.nonzero(np.abs(h_sob) > 0.1 * smax)[0]
            d_smax = np.max(np.abs(sob[i]))
            d_above = np.nonzero(np.abs(sob[i]) > 0.1 * d_smax)[0]
            assert h_above[-1] == d_above[-1], f"frame {i}"


@pytest.mark.parametrize("k", [2, 3, 5])
def test_band_opening_matches_scipy_any_kernel(k):
    """Opening inside the band pipeline must track scipy for non-default k."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(3)
    frames = rng.uniform(0, 100, size=(3, 40, 96)).astype(np.float32)
    sigma = 1.5
    prior_index = np.array([-1, 0, 1], dtype=np.int32)
    sob, grad, _intens, _rawc, _ = batch_centerline_profiles(
        frames, np.float32(0.0), prior_index, np.float32(0.0), np.float32(10.0),
        morphology_kernel_size=k, gaussian_sigma=sigma,
    )
    c = 20
    for i in (1, 2):
        diff = frames[i].astype(np.float64) - frames[i - 1].astype(np.float64)
        diff[diff < 0.0] = 0
        opened = ndi.grey_opening(diff, size=(k, k))
        blurred = ndi.gaussian_filter(opened, sigma=sigma)
        h_sob = ndi.sobel(blurred, axis=1)[c]
        np.testing.assert_allclose(np.array(sob)[i], h_sob, atol=5e-3, rtol=1e-4)


@pytest.mark.parametrize("k", [3, 5])
def test_band_chain_matches_float64_reference_at_width_1024(k):
    """The XLA band chain (what every device path runs) against the float64
    host ops at the bench width: f32 profiles within rtol 1e-5 and an
    absolute 1e-3 plus a few f32 ulps at the operands' scale (the Sobel
    taps subtract sums of up to 4x the band's peak), and the detector's
    integer positions equal."""
    flame = FlameSpec(x0=100.0, v0_px=40.0, ignition_frame=1, seed=29)
    frames, _ = synthesize_flame_video(6, height=48, width=1024, flame=flame)
    bg = float(np.max(frames[0]))
    sigma, thresh = 1.5, 5.0
    sob, grad, intens, _rawc, _ = batch_centerline_profiles(
        frames.astype(np.float32), np.float32(bg),
        np.arange(-1, 5, dtype=np.int32), np.float32(thresh),
        np.float32(max(10.0, bg * 0.5)),
        morphology_kernel_size=k, gaussian_sigma=sigma,
    )
    sob, grad, intens = np.array(sob), np.array(grad), np.array(intens)
    c = 24
    atol = 1e-3 + 8 * np.finfo(np.float32).eps * 4 * (frames.max() - bg)
    for i in range(1, 6):
        diff = (ref.subtract_scalar_background(frames[i], bg)
                - ref.subtract_scalar_background(frames[i - 1], bg))
        diff[diff < thresh] = 0
        blurred = ref.gaussian_filter(ref.grey_opening(diff, (k, k)), sigma)
        h_sob = ref.sobel(blurred, axis=1)[c]
        h_grad = ref.gradient_x(blurred)[c]
        for got, want in ((sob[i], h_sob), (grad[i], h_grad),
                          (intens[i], blurred[c])):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
        assert h_grad.min() < -10.0  # the flame front is in frame
        assert int(np.argmin(grad[i])) == int(np.argmin(h_grad)), i
        h_above = np.nonzero(np.abs(h_sob) > 0.1 * np.abs(h_sob).max())[0]
        d_above = np.nonzero(np.abs(sob[i]) > 0.1 * np.abs(sob[i]).max())[0]
        assert h_above[-1] == d_above[-1], i


def test_chunk_batches_land_on_buckets_with_overlap():
    """Interior chunks take chunk_size-1 new frames so the one-frame prior
    overlap lands the batch EXACTLY on the power-of-two bucket (regression:
    chunk_size new frames spanned chunk_size+1 rows and bucket-padded to
    double the transfer on every steady-state chunk)."""
    from hsip_tpu.track.config import FlameDetectorConfig
    from hsip_tpu.track.scan import compute_profiles_batched

    n, h, w = 200, 32, 128
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 4096, size=(n, h, w), dtype=np.uint16)
    shapes = []

    def spy_fn(batch, *args, **kwargs):
        from hsip_tpu.kernels.preprocess import batch_centerline_profiles

        shapes.append(batch.shape[0])
        return batch_centerline_profiles(batch, *args, **kwargs)

    profiles = compute_profiles_batched(
        read_batch=lambda a, b: frames[a:b],
        n_frames=n,
        frame_shape=(h, w),
        background_scalar=100.0,
        config=FlameDetectorConfig(),
        chunk_size=64,
        device_fn=spy_fn,
    )
    # 64 new + (63+1)*2 + tail: batches 64, 64, 64, 10->16. No 2x padding.
    assert shapes[:3] == [64, 64, 64], shapes
    assert all(s <= 64 for s in shapes), shapes
    assert profiles.frame_indices.size == n


def test_multi_chunk_profiles_match_single_chunk():
    """Chunked map phase (with prior overlap) must produce identical
    profiles to one big batch, for contiguous and skip-listed frames."""
    from hsip_tpu.track.config import FlameDetectorConfig
    from hsip_tpu.track.scan import compute_profiles_batched

    n, h, w = 150, 32, 128
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 4096, size=(n, h, w), dtype=np.uint16)
    config = FlameDetectorConfig()

    def run(chunk, skip=()):
        return compute_profiles_batched(
            read_batch=lambda a, b: frames[a:b],
            n_frames=n,
            frame_shape=(h, w),
            background_scalar=100.0,
            config=config,
            chunk_size=chunk,
            skip_frames=skip,
        )

    for skip in ((), (0, 3, 77, 149)):
        big = run(1024, skip)
        small = run(17, skip)
        np.testing.assert_array_equal(big.frame_indices, small.frame_indices)
        np.testing.assert_array_equal(big.sobel_lines, small.sobel_lines)
        np.testing.assert_array_equal(big.gradient_lines, small.gradient_lines)
        np.testing.assert_array_equal(big.intensity_lines, small.intensity_lines)
        np.testing.assert_array_equal(big.signal_counts, small.signal_counts)


def test_band_kernels_refuse_even_kernel_folding_band():
    """Direct kernel API calls must raise on the one geometry the band
    cannot reproduce (even morphology kernel + folding band) instead of
    silently returning non-scipy-parity profiles."""
    import jax.numpy as jnp

    from hsip_tpu.kernels.preprocess import batch_centerline_profiles
    from hsip_tpu.kernels.unpack import packed_centerline_profiles

    frames = jnp.zeros((2, 12, 256), jnp.uint16)  # 19-row band folds at H=12
    prior = jnp.array([-1, 0], jnp.int32)
    with pytest.raises(ValueError, match="folding"):
        batch_centerline_profiles(
            frames, jnp.float32(10.0), prior, jnp.float32(5.0),
            jnp.float32(50.0), morphology_kernel_size=4,
        )
    packed = jnp.zeros((2, 12 * 384), jnp.uint8)
    with pytest.raises(ValueError, match="folding"):
        packed_centerline_profiles(
            packed, 12, 256, jnp.float32(10.0), prior, jnp.float32(5.0),
            jnp.float32(50.0), morphology_kernel_size=4,
        )


@pytest.mark.parametrize("bit_depth,width", [
    (8, 256), (10, 256), (16, 256),
    # Rows straddling byte boundaries: the band gathers from the flat
    # full-frame decode instead of a byte-axis row gather.
    (10, 250), (12, 255),
])
def test_packed_full_frame_staging_parity(tmp_path, bit_depth, width):
    """The full-frame packed staging ladder is not 12-bit-only and not
    row-aligned-only: 10-bit (5 bytes / 4 px), raw 16-bit, and payloads
    whose rows are NOT byte-aligned all decode on-device to profiles
    identical to the host-decode path."""
    import numpy as np

    from hsip_tpu import open_video
    from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
    from hsip_tpu.track import FlameDetectorConfig
    from hsip_tpu.track.scan import compute_profiles_batched

    frames, _ = synthesize_flame_video(
        24, height=32, width=width,
        flame=FlameSpec(x0=25.0, v0_px=7.0, ignition_frame=2, seed=5),
    )
    frames = np.minimum(frames, 2 ** bit_depth - 1).astype(np.uint16)
    meta = write_recording(
        tmp_path, f"pk{bit_depth}-run-1", frames,
        spec=CihxSpec(width=width, height=32, total_frames=24,
                      record_rate=100_000, bit_depth=bit_depth),
    )
    config = FlameDetectorConfig()
    with open_video(str(meta)) as v:
        assert v.supports_packed_frames
        bg = float(np.max(v[0]))
        common = dict(
            n_frames=len(v), frame_shape=v.frame_shape,
            background_scalar=bg, config=config, chunk_size=8,
        )
        packed = compute_profiles_batched(
            read_batch=v.read_batch, read_packed=v.frame_bytes,
            band_bit_depth=bit_depth, **common,
        )
        host = compute_profiles_batched(read_batch=v.read_batch, **common)
    np.testing.assert_array_equal(packed.sobel_lines, host.sobel_lines)
    np.testing.assert_array_equal(packed.gradient_lines, host.gradient_lines)
    np.testing.assert_array_equal(packed.intensity_lines, host.intensity_lines)
    np.testing.assert_array_equal(packed.raw_center_lines, host.raw_center_lines)
    np.testing.assert_array_equal(packed.signal_counts, host.signal_counts)


def test_packed_band_gated_on_row_alignment(tmp_path):
    """10-bit with width not divisible by 4 has no byte-aligned rows: the
    minimal-transfer BAND path (host-side byte row gather) must gate off,
    while full-frame packed staging stays on (flat-stream decode)."""
    import numpy as np

    from hsip_tpu import open_video
    from hsip_tpu.io import CihxSpec, write_recording

    frames = np.zeros((3, 16, 250), dtype=np.uint16)  # 250 % 4 != 0
    meta = write_recording(
        tmp_path, "pk10odd-run-1", frames,
        spec=CihxSpec(width=250, height=16, total_frames=3,
                      record_rate=1000, bit_depth=10),
    )
    with open_video(str(meta)) as v:
        assert v.supports_packed_frames
        assert not v.supports_packed_band
        read_packed, read_band, count_fn, depth = v.staging_paths()
        assert read_packed is not None and read_band is None
        np.testing.assert_array_equal(v[0], frames[0])
