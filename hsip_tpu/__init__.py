"""hsip_tpu — accelerator-native high-speed image processing framework.

A from-scratch JAX/XLA/Pallas rebuild of the Photron high-speed camera
pipeline (CIHX/MRAW loading, flame-front tracking, DDT detection) of
Nadexterbrown/High-Speed-Image-Processing, built around device kernels:

* L0  io/        — CIHX/CIH metadata, memory-mapped MRAW payloads, synthetic data
* L0.5 kernels/  — XLA kernels: on-device 12-bit unpack, fused preprocess
* L1  video      — PhotonVideo, TimingInfo, SpatialCalibration
* L2  collection — VideoCollection global indexing; parallel/ device-mesh runtime
* L3  track/     — detectors, tracker scan, velocities, DDT, exit logic
* L4  pipeline   — orchestration, results tables, CLI; viz — diagnostics

Public API parity target: reference ``src/photron/__init__.py`` +
``src/__init__.py`` (open_video/open_collection facades, re-exports).
"""

from pathlib import Path
from typing import List, Optional, Set, Union

from .video import PhotonVideo, PhotonVideoFloat64, SpatialCalibration, TimingInfo
from .metadata import MetadataConfig
from .collection import VideoCollection
from .io.cihx import parse_cihx_xml

__version__ = "0.2.0"


def open_video(
    filepath: str,
    metadata_fields: Optional[Set[str]] = None,
    trigger_frame: Optional[int] = None,
    calibration: Optional[SpatialCalibration] = None,
) -> PhotonVideo:
    """Open a single Photron recording (.cihx or .cih metadata path).

    Example:
        >>> video = open_video("experiment.cihx")
        >>> frame = video[0]
    """
    return PhotonVideo(
        filepath,
        metadata_fields=metadata_fields,
        trigger_frame=trigger_frame,
        calibration=calibration,
    )


def open_collection(
    source: Union[str, List[str]],
    pattern: str = "*.cihx",
    recursive: bool = False,
    metadata_fields: Optional[Set[str]] = None,
    trigger_frame: Optional[int] = None,
    calibration: Optional[SpatialCalibration] = None,
) -> VideoCollection:
    """Open multiple recordings as a :class:`VideoCollection`.

    ``source`` may be a directory (globbed with ``pattern``) or an explicit
    list of file paths.
    """
    if isinstance(source, (str, Path)) and Path(source).is_dir():
        return VideoCollection.from_directory(
            source,
            pattern=pattern,
            recursive=recursive,
            metadata_fields=metadata_fields,
            trigger_frame=trigger_frame,
            calibration=calibration,
        )
    if isinstance(source, list):
        return VideoCollection.from_files(
            source,
            metadata_fields=metadata_fields,
            trigger_frame=trigger_frame,
            calibration=calibration,
        )
    raise ValueError("source must be a directory path or list of file paths")


# Deferred imports for heavier subsystems (jax-dependent); imported lazily so
# metadata-only workflows never pay JAX start-up cost.
def __getattr__(name):
    if name == "TPUVideoProcessor":
        from .parallel import TPUVideoProcessor

        return TPUVideoProcessor
    if name == "FlameDetector":
        from .track import FlameDetector

        return FlameDetector
    if name == "FlameDetectorConfig":
        from .track import FlameDetectorConfig

        return FlameDetectorConfig
    raise AttributeError(f"module 'hsip_tpu' has no attribute {name!r}")


__all__ = [
    "PhotonVideo",
    "PhotonVideoFloat64",
    "VideoCollection",
    "MetadataConfig",
    "TPUVideoProcessor",
    "SpatialCalibration",
    "TimingInfo",
    "parse_cihx_xml",
    "open_video",
    "open_collection",
    "FlameDetector",
    "FlameDetectorConfig",
    "__version__",
]
