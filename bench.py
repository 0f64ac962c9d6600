"""Benchmark: MRAW frames/sec per GPU for the end-to-end decode+track pipeline.

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}
with the device it ran on (``platform``, ``device_kind``, ``device_count``)
and the card's name and power limit (``card``). Without a GPU it exits
non-zero and prints no number.

Pipeline measured (the north-star metric, BASELINE.json): open a synthetic
CIHX/MRAW recording from disk, decode packed 12-bit frames, run the batched
band preprocess on the GPU, run the tracking state machine (default: the
fully on-device scan; ``--scan host`` for the float64 host scan — both
proven row-identical), produce the results rows. Baseline: the
reference-equivalent serial scipy chain (full-frame grey_opening →
gaussian_filter → sobel → gradient per frame) measured on this host and
extrapolated per-frame.

``--mode both`` (the default) measures one library of ``--videos``
recordings TWO ways on alternating repeats: the per-file loop (the
reference's execution shape, one recording at a time) and the batched
library scan, over identical inputs; ``--mode single`` keeps the
one-recording probe.

Usage: python bench.py [--frames N] [--height H] [--width W] [--repeat R]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

def build_recording(tmpdir: Path, n_frames: int, height: int, width: int):
    from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording

    flame = FlameSpec(
        x0=30.0,
        v0_px=width / (1.3 * n_frames),  # front crosses ~77% of the image
        accel_px=0.0,
        ignition_frame=2,
        seed=42,
    )
    frames, _ = synthesize_flame_video(n_frames, height=height, width=width, flame=flame)
    spec = CihxSpec(
        width=width, height=height, total_frames=n_frames,
        record_rate=100_000, bit_depth=12,
    )
    return write_recording(tmpdir, "bench-run-1-001", frames, spec=spec)


def run_device_pipeline(meta_path, config, chunk_size=256, scan="device",
                     stage_times=None):
    from hsip_tpu import open_video
    from hsip_tpu.track.scan import track_video

    with open_video(str(meta_path)) as video:
        out = track_video(
            video, config,
            calibration_m_per_px=0.000833333,
            position_offset_m=1.0159,
            chunk_size=chunk_size,
            scan=scan,
            stage_times=stage_times,
        )
    return out


def run_per_file_pipeline(lib, config, chunk_size=None, scan="device",
                          stage_times=None):
    """Per-file comparator: the reference's execution shape — one
    recording at a time (`process_videos.py:1308`) — over the SAME
    library the batched mode processes.

    Both modes then move identical bytes per repeat, so the
    single-vs-library ratio compares pipeline shapes, not payloads.

    Returns (outputs, summed scan_phase seconds).
    """
    outs = []
    scan_s = 0.0
    for cihx in sorted(Path(lib).glob("*.cihx")):
        out = run_device_pipeline(cihx, config, chunk_size, scan,
                               stage_times=stage_times)
        if out.phase_timings:
            scan_s += out.phase_timings["scan_s"]
        outs.append(out)
    return outs, scan_s


def time_scipy_baseline(meta_path, config, n_sample: int) -> float:
    """Per-frame seconds of the reference-equivalent serial scipy chain."""
    import scipy.ndimage as ndi

    from hsip_tpu import open_video

    with open_video(str(meta_path)) as video:
        frames = video.read_batch(0, n_sample + 1).astype(np.float64)
    n_sample = min(n_sample, len(frames) - 1)  # short --frames runs
    if n_sample < 1:
        raise ValueError(
            "scipy baseline needs >= 2 frames (frame differencing); "
            f"recording has {len(frames)}"
        )
    bg = float(frames[0].max())
    sub = np.maximum(frames - bg, 0.0)
    k, sigma = config.morphology_kernel_size, config.gaussian_sigma

    best = float("inf")
    for _ in range(3):  # best-of to damp host noise
        start = time.perf_counter()
        for i in range(1, n_sample + 1):
            diff = sub[i] - sub[i - 1]
            diff[diff < config.frame_diff_threshold] = 0
            opened = ndi.grey_opening(diff, size=(k, k))
            blurred = ndi.gaussian_filter(opened, sigma=sigma)
            sob = ndi.sobel(blurred, axis=1)
            grad = np.gradient(blurred, axis=1)
            c = blurred.shape[0] // 2
            _ = sob[c], grad[c]
            if np.min(grad[c]) < -config.min_gradient_strength:
                _ = np.argmin(grad[c])
        best = min(best, time.perf_counter() - start)
    return best / n_sample


def time_device_compute(meta_path, config, repeats: int = 3):
    """Device-compute-only seconds for the single-video pipeline.

    Times the two device stages — the band preprocess and the tracking
    scan — on ALREADY-device-resident inputs (no disk read, host gather,
    or H2D inside the timed region), so the JSON can tell a kernel/scan
    regression from host staging.

    Returns (seconds, n_frames) or None when the recording has no packed
    band path (the measurement would not match the pipeline's kernels).
    """
    import jax

    from hsip_tpu import open_video
    from hsip_tpu.kernels.preprocess import band_margin, reflect_indices
    from hsip_tpu.kernels.unpack import packed_band_profiles
    from hsip_tpu.track.scan import (
        NOISE_THRESHOLD_FLOOR, run_tracking_scan_device, FrameProfiles,
    )

    with open_video(str(meta_path)) as video:
        n = len(video)
        h, w = video.frame_shape
        bg = float(np.max(video[0]))
        _read_packed, read_band, count_fn, depth = video.staging_paths()
        if read_band is None or count_fn is None:
            return None
        margin = band_margin(config.morphology_kernel_size,
                             config.gaussian_sigma)
        rows = reflect_indices(h // 2, margin, h)
        host = np.ascontiguousarray(read_band(0, n, rows))
        noise_threshold = max(NOISE_THRESHOLD_FLOOR, bg * 0.5)
        counts = np.asarray(count_fn(0, n, bg, noise_threshold))
        frame_rate = video.frame_rate

    prior = np.arange(-1, n - 1, dtype=np.int32)
    dev = jax.device_put(host)

    def run_kernel():
        outs = packed_band_profiles(
            dev, np.float32(bg), prior,
            np.float32(config.frame_diff_threshold),
            morphology_kernel_size=config.morphology_kernel_size,
            gaussian_sigma=config.gaussian_sigma,
            bit_depth=depth,
        )
        jax.block_until_ready(outs)
        return outs

    sob, grad, intens, rawc = run_kernel()  # warm-up/compile
    best_kernel = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_kernel()
        best_kernel = min(best_kernel, time.perf_counter() - t0)

    has_prior = np.ones(n, dtype=bool)
    has_prior[0] = False
    profiles = FrameProfiles(
        frame_indices=np.arange(n, dtype=np.int64),
        sobel_lines=sob, gradient_lines=grad, intensity_lines=intens,
        raw_center_lines=rawc, signal_counts=counts.astype(np.int64),
        has_prior=has_prior, width=w, total_pixels=h * w,
    )
    def run_scan():
        return run_tracking_scan_device(
            profiles, config, frame_rate=frame_rate,
            calibration_m_per_px=0.000833333, position_offset_m=1.0159,
        )

    run_scan()  # warm-up/compile
    best_scan = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_scan()
        best_scan = min(best_scan, time.perf_counter() - t0)
    # run_tracking_scan_device includes the blocking result fetch and the
    # small float64 table reconstruction; both belong to the scan stage.
    return best_kernel + best_scan, n


def run_collection_pipeline(video_dir, config, stage_times=None):
    """Library mode: vmapped on-device tracking of every recording."""
    from hsip_tpu import open_collection
    from hsip_tpu.track.batch import track_collection_device

    with open_collection(str(video_dir)) as coll:
        return track_collection_device(coll, config, stage_times=stage_times)


def _build_library(
    tmpdir: Path, n_videos: int, per_video: int, height, width, source=None,
    dirname: str = "lib",
):
    """Materialize ``n_videos`` recordings by hard-linking ONE payload.

    n hard links give identical decode+track work per video at zero extra
    synthesis or disk cost. ``source``
    reuses an already-built recording (the single-mode one in --mode both).
    """
    import shutil

    lib = tmpdir / dirname
    lib.mkdir(exist_ok=True)
    if source is None:
        source = build_recording(lib, per_video, height, width)
    source = Path(source)
    payload = source.with_suffix(".mraw")
    for v in range(n_videos):
        cihx = lib / f"bench-run-{v + 1:02d}-001.cihx"
        mraw = lib / f"bench-run-{v + 1:02d}-001.mraw"
        if cihx != source:
            shutil.copyfile(source, cihx)
        if mraw != payload:
            if mraw.exists():
                mraw.unlink()
            os.link(payload, mraw)
    if source.parent == lib and source.name not in {
        f"bench-run-{v + 1:02d}-001.cihx" for v in range(n_videos)
    }:
        source.unlink()
        payload.unlink()
    return lib


def run_bench(args, config) -> dict:
    """Measure the requested mode(s); returns the result-JSON dict."""
    from hsip_tpu.utils import StageTimes

    extra: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmpdir = Path(tmp)
        single_fps = None
        library_fps = None

        run_single = args.mode in ("both", "single")
        run_library = args.mode in ("both", "library")
        # In --mode both, the single-side comparator is the PER-FILE LOOP
        # over the same library (see run_per_file_pipeline) — identical
        # inputs and wire bytes per repeat. --mode single keeps the legacy
        # one-recording shape for quick probes.
        per_file_loop = args.mode == "both"
        if run_single or run_library:
            meta = build_recording(tmpdir, args.frames, args.height, args.width)
        if run_library:
            # Full-length recordings, one per video: the production shape a
            # library run actually sees. (Splitting --frames ACROSS the
            # videos measured per-run fixed cost — discovery, staging
            # ramp-up, per-video dispatch — instead of steady-state
            # throughput: 256-frame shards ran ~2x slower per frame than
            # one 2048-frame recording on the same chip.)
            per_video = args.frames
            lib = _build_library(
                tmpdir, args.videos, per_video, args.height, args.width,
                source=meta,
            )
            total_frames = per_video * args.videos

        # Warm-ups (compiles), then ALTERNATE single/library repeats:
        # interleaving samples both modes under the same host and card
        # conditions, and the order within each repeat flips so neither
        # mode systematically inherits the state the other leaves behind.
        best_s, best_st_s, best_scan_s = float("inf"), None, None
        best_l, best_st_l = float("inf"), None
        single_key = "per_file_s" if per_file_loop else "single_s"
        samples: dict = {single_key: [], "library_s": []}

        def _measure_single():
            nonlocal best_s, best_st_s, best_scan_s
            st = StageTimes()
            t0 = time.perf_counter()
            if per_file_loop:
                outs_s, scan_s = run_per_file_pipeline(
                    lib, config, args.chunk_size, args.scan, stage_times=st
                )
            else:
                out = run_device_pipeline(
                    meta, config, args.chunk_size, args.scan, stage_times=st
                )
                outs_s, scan_s = [out], (out.phase_timings or {}).get(
                    "scan_s"
                )
            dt = time.perf_counter() - t0
            samples[single_key].append(round(dt, 3))
            if dt < best_s:
                # Stages AND phase timings travel together: publishing the
                # best repeat's stages with another repeat's scan_phase
                # produces impossible artifacts (scan_phase > end_to_end_s).
                best_s, best_st_s, best_scan_s = dt, st, scan_s
            return outs_s

        def _measure_library():
            nonlocal best_l, best_st_l
            st = StageTimes()
            t0 = time.perf_counter()
            outs = run_collection_pipeline(lib, config, stage_times=st)
            dt = time.perf_counter() - t0
            samples["library_s"].append(round(dt, 3))
            if dt < best_l:
                best_l, best_st_l = dt, st
            return outs

        if run_single:
            if per_file_loop:
                run_per_file_pipeline(lib, config, args.chunk_size, args.scan)
            else:
                run_device_pipeline(meta, config, args.chunk_size, args.scan)
        if run_library:
            run_collection_pipeline(lib, config)
        outs_single: list = []
        outs = []
        for rep in range(args.repeat):
            legs = []
            if run_single:
                legs.append("s")
            if run_library:
                legs.append("l")
            if rep % 2:
                legs.reverse()
            for leg in legs:
                if leg == "s":
                    outs_single = _measure_single()
                else:
                    outs = _measure_library()
        # Per-repeat wall-clock samples ride in the artifact so the spread
        # is carried by the JSON itself, not by prose.
        extra["samples"] = {k: v for k, v in samples.items() if v}
        # Stage semantics, stated where the numbers live: each stage is
        # host wall-clock inside that stage; overlapping pool threads SUM,
        # so thread-pooled stages can exceed the mode's end_to_end_s.
        extra["stages_note"] = (
            "stages are from each mode's BEST repeat (cleanest run); "
            "per-stage host wall-clock; library staging stages are summed "
            "across overlapping pool threads and may exceed end_to_end_s"
        )

        # Central statistic: the MEDIAN of the interleaved, order-
        # alternating repeats (best-of-N rewards whichever mode has the
        # higher dispersion with one lucky draw); best-based figures ride
        # alongside (*_fps_best).
        import statistics

        med_s = statistics.median(samples[single_key]) if run_single else None
        med_l = (
            statistics.median(samples["library_s"]) if run_library else None
        )
        extra["statistic"] = (
            "median of interleaved order-alternating repeats "
            "(see samples); *_fps_best = legacy best-of"
        )
        if run_single and run_library:
            # Per-repeat pairing shares conditions WITHIN each repeat, so
            # the pairwise ratio isolates pipeline cost better than the two
            # medians' quotient. > 1 means the batched library beat the
            # per-file loop inside that repeat.
            pair_ratios = sorted(
                pf / lb for pf, lb in
                zip(samples[single_key], samples["library_s"])
            )
            extra["library_speedup_pairwise_median"] = round(
                statistics.median(pair_ratios), 3
            )
            extra["library_speedup_pairs"] = [
                round(r, 3) for r in pair_ratios
            ]
            if len(pair_ratios) >= 4:
                # An IQR whose lower quartile clears 1.0 puts the
                # library's edge outside the noise, pair count permitting.
                q = statistics.quantiles(pair_ratios, n=4)
                extra["library_speedup_pairs_iqr"] = [
                    round(q[0], 3), round(q[2], 3)
                ]

        if run_single:
            single_frames = total_frames if per_file_loop else args.frames
            single_fps = single_frames / med_s
            extra["single_fps_best"] = round(single_frames / best_s, 1)
            extra["single_stages"] = best_st_s.as_dict(3)
            extra["single_end_to_end_s"] = round(best_s, 3)
            extra["single_median_s"] = round(med_s, 3)
            if best_scan_s is not None:
                extra["single_stages"]["scan_phase"] = round(best_scan_s, 4)
            extra["single_mode"] = (
                f"per-file loop over the same {args.videos}-recording "
                "library (reference execution shape; identical inputs and "
                "wire bytes to library mode per repeat)"
                if per_file_loop else "one recording"
            )
            print(
                f"single[{'per-file' if per_file_loop else 'one-video'}]: "
                f"frames={single_frames} {args.height}x{args.width} "
                f"end_to_end_s={best_s:.3f} "
                f"rows={len(outs_single[0].rows) if outs_single else 0} "
                f"stages={extra['single_stages']}",
                file=sys.stderr,
            )
            dev = time_device_compute(meta, config)
            if dev is not None:
                dev_s, dev_n = dev
                extra["device_compute_fps"] = round(dev_n / dev_s, 1)
                print(
                    f"device-compute-only: {dev_s * 1e3:.2f} ms for {dev_n} "
                    f"frames ({extra['device_compute_fps']:.0f} fps)",
                    file=sys.stderr,
                )
        if run_library:
            library_fps = total_frames / med_l
            extra["library_fps_best"] = round(total_frames / best_l, 1)
            extra["library_stages"] = best_st_l.as_dict(3)
            extra["library_end_to_end_s"] = round(best_l, 3)
            extra["library_median_s"] = round(med_l, 3)
            # Host-staging ceiling: the host side of staging — the fused
            # native gather+count pass (read_gather; counts_host only on
            # the two-pass fallback). Library gathers are serialized, so
            # the stage sum IS wall-clock here.
            lib_stages = best_st_l.as_dict(6)
            host_s = (lib_stages.get("read_gather", 0.0)
                      + lib_stages.get("counts_host", 0.0))
            if host_s > 0:
                extra["host_staging_fps"] = round(total_frames / host_s, 1)
            print(
                f"library: videos={args.videos} frames={total_frames} "
                f"end_to_end_s={best_l:.3f} rows={len(outs[0].rows)} "
                f"stages={extra['library_stages']}",
                file=sys.stderr,
            )

        # Amortization point: the same interleaved pairing at V=16 — twice
        # the library over the same per-video payload. Batching cost is
        # per-program, so the batched mode's edge should GROW with V; a
        # V=16 pairwise median below the V=8 one would falsify that.
        if (per_file_loop and run_library and args.v16_pairs > 0
                and args.videos16 > args.videos):
            src16 = sorted(lib.glob("*.cihx"))[0]
            lib16 = _build_library(
                tmpdir, args.videos16, per_video, args.height,
                args.width, source=src16, dirname="lib16",
            )
            total16 = per_video * args.videos16
            v16: dict = {"per_file_s": [], "library_s": []}
            # One warm-up library pass: V=16 is a fresh program shape
            # (the V-axis is static in the fused/scan programs).
            run_collection_pipeline(lib16, config)
            for rep in range(args.v16_pairs):
                legs = ["s", "l"] if rep % 2 == 0 else ["l", "s"]
                for leg in legs:
                    t0 = time.perf_counter()
                    if leg == "s":
                        run_per_file_pipeline(
                            lib16, config, args.chunk_size, args.scan
                        )
                        v16["per_file_s"].append(
                            round(time.perf_counter() - t0, 3)
                        )
                    else:
                        run_collection_pipeline(lib16, config)
                        v16["library_s"].append(
                            round(time.perf_counter() - t0, 3)
                        )
            pairs16 = sorted(
                pf / lb for pf, lb in
                zip(v16["per_file_s"], v16["library_s"])
            )
            extra["library_v16"] = {
                "videos": args.videos16,
                "library_fps": round(
                    total16 / statistics.median(v16["library_s"]), 1
                ),
                "samples": v16,
                "speedup_pairs": [round(r, 3) for r in pairs16],
                "speedup_pairwise_median": round(
                    statistics.median(pairs16), 3
                ),
            }
            print(
                f"library_v16: videos={args.videos16} "
                f"frames={total16} {extra['library_v16']}",
                file=sys.stderr,
            )

        baseline_per_frame = time_scipy_baseline(
            meta, config, args.baseline_sample
        )
        baseline_fps = 1.0 / baseline_per_frame

    # Headline: the library (vmapped whole-source) number -- the
    # representative production shape -- with the single-video figure
    # alongside; single-video becomes the headline when it ran alone.
    fps = library_fps if library_fps is not None else single_fps
    if single_fps is not None:
        extra["single_video_fps"] = round(single_fps, 1)
    if library_fps is not None:
        extra["library_fps"] = round(library_fps, 1)
        extra["library_videos"] = args.videos
        # The library's recordings hard-link ONE payload, so cold I/O and
        # page-cache pressure are paid once, not N times — the figure
        # covers decode+track throughput, not distinct-file cold-disk I/O.
        extra["library_payload"] = "hard-linked (shared page cache)"
    extra["scipy_serial_fps"] = round(baseline_fps, 1)
    return {
        "metric": "mraw_frames_per_sec_per_chip_decode_track",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 2),
        **extra,
    }


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=2048)
    parser.add_argument("--height", type=int, default=128)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument(
        "--repeat", type=int, default=12,
        help="interleaved repeats; the headline uses the MEDIAN, and 12 "
        "pairs put the pairwise-ratio IQR in the artifact",
    )
    parser.add_argument(
        "--videos16", type=int, default=16,
        help="video count for the optional amortization point (library "
        "vs per-file pairs at a larger V; 0 or <= --videos disables)",
    )
    parser.add_argument(
        "--v16-pairs", type=int, default=2,
        help="interleaved pairs at --videos16",
    )
    parser.add_argument("--baseline-sample", type=int, default=48)
    parser.add_argument("--chunk-size", type=int, default=None)
    parser.add_argument(
        "--scan", choices=("host", "device"), default="device",
        help="tracking-scan backend (both proven row-identical); 'device' "
        "keeps profile lines on the GPU and runs the state machine as one "
        "kernel -- the flagship fully on-device path",
    )
    parser.add_argument(
        "--mode", choices=("both", "single", "library"), default="both",
        help="which pipeline shapes to measure; 'both' compares the "
        "per-file loop vs the batched scan over the SAME --videos-"
        "recording library; the headline value is the library (batched "
        "whole-source) number when it runs",
    )
    parser.add_argument(
        "--videos", type=int, default=8,
        help="library-mode video count (each video is --frames long)",
    )
    return parser


def device_fields() -> dict:
    """The device the numbers come from: JAX's view plus the card's name
    and power limit. Raises when the default backend is not a GPU."""
    import jax

    from hsip_tpu.utils.backend import card_name_and_power_limit

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {devices[0].platform!r}; "
            "this benchmark measures the GPU and reports nothing else"
        )
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card_name_and_power_limit(),
    }


def main() -> int:
    parser = _build_parser()
    args = parser.parse_args()
    if args.scan == "host" and args.mode != "single":
        parser.error("--scan host applies to single-video mode only "
                     "(library mode always runs the vmapped device scan)")
    try:
        device = device_fields()
    except RuntimeError as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 1

    from hsip_tpu.track import FlameDetectorConfig
    from hsip_tpu.utils import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    result = run_bench(args, FlameDetectorConfig())
    print(json.dumps({**result, **device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
