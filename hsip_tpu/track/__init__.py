"""Tracking layer (L3): detectors, tracker state machine, configs.

Parity target: the analysis layer of reference ``scripts/process_videos.py``
(FlameDetector & friends), promoted into the library proper and split at the
map/scan seam for device execution.

The jax-heavy submodules (scan, device_scan, batch) load lazily so that
metadata/config/visualization consumers — including the spawned figure-render
workers — never pay (or contend on) JAX initialization.
"""

from .config import (
    FileCalibration,
    FlameDetectionResult,
    FlameDetectorConfig,
    VideoSourceConfig,
)
from .detectors import (
    DETECTION_METHODS,
    detect_gradient,
    detect_half_maximum,
    detect_profile,
    detect_threshold,
)
from .spline import SmoothingSpline, fit_smoothing_spline
from .tracker import FlameDetector, FlameTracker
from .velocity import (
    ddt_frame_from_velocities,
    velocities_from_positions,
    velocity_entries_from_positions,
)

_LAZY = {
    "track_collection_device": ("batch", "track_collection_device"),
    "ScanHistory": ("batch", "ScanHistory"),
    "device_tracking_scan": ("device_scan", "device_tracking_scan"),
    "DeviceScanResult": ("device_scan", "DeviceScanResult"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{module}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "FileCalibration",
    "FlameDetectionResult",
    "FlameDetectorConfig",
    "VideoSourceConfig",
    "FlameDetector",
    "FlameTracker",
    "SmoothingSpline",
    "fit_smoothing_spline",
    "detect_threshold",
    "detect_half_maximum",
    "detect_gradient",
    "detect_profile",
    "DETECTION_METHODS",
    "track_collection_device",
    "ScanHistory",
    "device_tracking_scan",
    "velocities_from_positions",
    "velocity_entries_from_positions",
    "ddt_frame_from_velocities",
    "DeviceScanResult",
]
