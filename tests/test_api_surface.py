"""The public API surface documented in docs/API.md must exist.

One assertion per documented symbol/attribute — if a rename breaks this
test, update docs/API.md (and PARITY.md / MIGRATION.md) in the same change.
"""

import hsip_tpu
from hsip_tpu import viz
from hsip_tpu.io import MRAWReader
from hsip_tpu.parallel import TPUVideoProcessor
from hsip_tpu.video import PhotonVideo


def test_top_level_exports():
    for name in hsip_tpu.__all__:
        assert getattr(hsip_tpu, name) is not None, name


def test_io_exports():
    import hsip_tpu.io as io

    for name in io.__all__:
        assert getattr(io, name) is not None, name
    for name in ("band_bytes", "count_above", "read_frame", "read_frames",
                 "frame_bytes"):
        assert hasattr(MRAWReader, name), name


def test_video_tpu_additions():
    for name in ("describe", "staging_paths", "read_batch", "frame_bytes",
                 "band_bytes", "supports_packed_frames",
                 "supports_packed_band"):
        assert hasattr(PhotonVideo, name), name


def test_track_exports():
    import hsip_tpu.track as track

    for name in track.__all__:
        assert getattr(track, name) is not None, name
    # Lazy jax-heavy symbols resolve too.
    for name in ("track_collection_device", "device_tracking_scan",
                 "DeviceScanResult"):
        assert getattr(track, name) is not None, name
    from hsip_tpu.track.scan import compute_profiles_batched, track_video  # noqa: F401


def test_parallel_exports():
    import hsip_tpu.parallel as par

    for name in par.__all__:
        assert getattr(par, name) is not None, name
    for name in ("allgather", "process_collection", "process_videos",
                 "reduce_sum", "allreduce_sum", "distribute_indices",
                 "broadcast", "gather", "scatter", "barrier"):
        assert hasattr(TPUVideoProcessor, name), name


def test_pipeline_and_utils_exports():
    import hsip_tpu.pipeline as pipeline
    import hsip_tpu.utils as utils

    for name in pipeline.__all__:
        assert getattr(pipeline, name) is not None, name
    for name in utils.__all__:
        assert getattr(utils, name) is not None, name


def test_viz_exports():
    for name in ("save_frame_image", "save_frame_image_compact",
                 "save_frame_image_from_video", "generate_stacked_sequence",
                 "generate_stacked_sequence_single_column",
                 "render_diagnostics_parallel"):
        assert hasattr(viz, name), name


def test_cli_entry_points():
    from hsip_tpu.cli import build_parser, entry, load_config, main  # noqa: F401


def test_round2_additions():
    from hsip_tpu.track import fitpack, pallas_scan, spline
    from hsip_tpu.utils import is_gpu_backend

    for mod, names in (
        (fitpack, ("curfit", "splev", "FitpackError")),
        (pallas_scan, ("pallas_tracking_scan", "pallas_tracking_scan_batched",
                       "kernel_enabled")),
        (spline, ("fit_smoothing_spline", "SmoothingSpline")),
    ):
        for name in names:
            assert hasattr(mod, name), name
    assert callable(is_gpu_backend)

    from hsip_tpu.parallel.dryrun import run_pipeline_dryrun  # noqa: F401
