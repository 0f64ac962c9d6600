#!/usr/bin/env python
"""Scan and band-chain timings on the GPU, and end to end each way.

    python tools/scan_bench.py [--quick] [--out hsip-output/scan_bench.json]

Measures, on the recording ``chip_smoke.py`` synthesizes (2048 frames,
128x1024, 12-bit; its real profiles drive the scans):

* the tracking scan in µs/step — the Triton kernel at several
  ``num_warps`` and ``lax.scan`` at several ``unroll`` values — at
  V = 1, 8, 16 and W = 1024 for the ``combined`` and ``gradient``
  detectors (best of 5 after a warm-up, host clock around
  ``block_until_ready``);
* XLA's band chain (``packed_band_profiles``) on device-resident packed
  band bytes, against the time HBM needs for its bytes at 3.35 TB/s, and
  a large device copy for the bandwidth this card reaches; then a profiler
  trace of three chain calls, reduced to device time per kernel;
* end-to-end frames/s of ``hsip --backend device`` on one recording and
  ``hsip --library`` on eight, with the scan on the kernel and on
  ``lax.scan`` (warm runs, alternating, 3 pairs each).

``--quick`` compiles every detector once at a short length, checks it
against ``lax.scan`` and prints single timings: the first call after a
kernel change. Needs a GPU; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet (NVIDIA)


def best_of(fn, reps=5):
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def scan_inputs(prof, empty, V, method):
    import jax
    import numpy as np

    m = prof.frame_indices.size
    rows = (prof.intensity_lines if method != "combined"
            else prof.sobel_lines)
    prior = (prof.has_prior if method == "combined"
             else np.ones(m, bool))
    args = (np.tile(np.arange(m, dtype=np.int32), (V, 1)),
            np.tile(rows[None], (V, 1, 1)),
            np.tile(prof.gradient_lines[None], (V, 1, 1)),
            np.tile(empty[None], (V, 1)),
            np.tile(prior[None], (V, 1)),
            np.tile(prof.intensity_lines[None], (V, 1, 1)),
            np.full(V, 8.33e-4, np.float32), np.full(V, 1e5, np.float32),
            np.full(V, 3, np.int32))
    return jax.device_put(args)


def time_scans(prof, empty, res, quick):
    import jax
    import numpy as np

    from hsip_tpu.track.device_scan import device_tracking_scan
    from hsip_tpu.track.pallas_scan import pallas_tracking_scan_batched

    m = prof.frame_indices.size
    methods = (("combined", "threshold", "half_maximum", "gradient")
               if quick else ("combined", "gradient"))
    videos = (1,) if quick else (1, 8, 16)
    warps = (1, 4) if quick else (1, 2, 4, 8)
    unrolls = (1,) if quick else (1, 2, 4, 8, 16)
    for method in methods:
        kw = dict(width=prof.width, min_gradient_strength=np.float32(10.0),
                  sobel_threshold_fraction=np.float32(0.1),
                  ddt_velocity_jump=np.float32(1250.0), method=method,
                  method_fraction=np.float32(0.5))
        for V in videos:
            a = scan_inputs(prof, empty, V, method)
            ref = None
            for u in unrolls:
                f = jax.jit(jax.vmap(
                    lambda fi, s, g, e, hp, it, c, r, d, u=u:
                    device_tracking_scan(
                        fi, s, g, e, hp, calibration=c, frame_rate=r,
                        max_displacement_px=d, intensity_lines=it,
                        unroll=u, **kw)))
                t0 = time.perf_counter()
                out = jax.block_until_ready(f(*a))
                compile_s = time.perf_counter() - t0
                ref = ref if ref is not None else out
                dt = best_of(lambda: f(*a))
                key = f"scan/{method}/V{V}/lax_unroll{u}"
                res[key] = {"us_per_step": dt / m * 1e6,
                            "first_call_s": compile_s}
                print(f"{key}: {dt / m * 1e6:.2f} us/step "
                      f"(first call {compile_s:.1f} s)", flush=True)
            for nw in warps:
                def kern(nw=nw):
                    return pallas_tracking_scan_batched(
                        *a[:5], calibration=a[6], frame_rate=a[7],
                        max_displacement_px=a[8], intensity_lines=a[5],
                        num_warps=nw, **kw)
                t0 = time.perf_counter()
                out = jax.block_until_ready(kern())
                compile_s = time.perf_counter() - t0
                for name in ref._fields:
                    x = np.asarray(getattr(ref, name))
                    y = np.asarray(getattr(out, name)).astype(x.dtype)
                    if not np.array_equal(x, y):
                        raise AssertionError(
                            f"kernel != lax.scan: {method} V={V} "
                            f"num_warps={nw} field {name}")
                dt = best_of(kern)
                key = f"scan/{method}/V{V}/kernel_warps{nw}"
                res[key] = {"us_per_step": dt / m * 1e6,
                            "first_call_s": compile_s}
                print(f"{key}: {dt / m * 1e6:.2f} us/step "
                      f"(first call {compile_s:.1f} s, == lax.scan)",
                      flush=True)


def time_band_chain(meta, res):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hsip_tpu import open_video
    from hsip_tpu.kernels.preprocess import band_margin, reflect_indices
    from hsip_tpu.kernels.unpack import packed_band_profiles
    from hsip_tpu.track import FlameDetectorConfig

    cfg = FlameDetectorConfig()
    with open_video(str(meta)) as video:
        n = len(video)
        h, w = video.frame_shape
        bg = float(video[0].max())
        _p, read_band, _c, depth = video.staging_paths()
        rows = reflect_indices(
            h // 2, band_margin(cfg.morphology_kernel_size,
                                cfg.gaussian_sigma), h)
        host = np.ascontiguousarray(read_band(0, n, rows))
    dev = jax.device_put(host)
    prior = jax.device_put(np.arange(-1, n - 1, dtype=np.int32))

    def chain():
        return packed_band_profiles(
            dev, np.float32(bg), prior, np.float32(cfg.frame_diff_threshold),
            morphology_kernel_size=cfg.morphology_kernel_size,
            gaussian_sigma=cfg.gaussian_sigma, bit_depth=depth)

    dt = best_of(chain, reps=20)
    res["band_chain_kernels"] = trace_kernels(chain, calls=3)
    in_bytes = host.nbytes
    out_bytes = 4 * n * w * 4
    big = jnp.ones((1 << 28,), jnp.float32)  # 1 GiB
    copy = jax.jit(lambda x: x + 1.0)
    dt_copy = best_of(lambda: copy(big), reps=10)
    copy_bw = 2 * big.nbytes / dt_copy
    res["band_chain"] = {
        "shape": list(host.shape), "s": dt,
        "input_bytes": in_bytes, "output_bytes": out_bytes,
        "floor_input_s": in_bytes / HBM_BYTES_PER_S,
        "floor_in_out_s": (in_bytes + out_bytes) / HBM_BYTES_PER_S,
        "copy_GBps": copy_bw / 1e9,
    }
    print(f"band chain {host.shape} u8: {dt * 1e6:.1f} us; bytes floor at "
          f"3.35 TB/s: {in_bytes / HBM_BYTES_PER_S * 1e6:.1f} us (input), "
          f"{(in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e6:.1f} us "
          f"(input+output); 1 GiB copy reaches {copy_bw / 1e9:.0f} GB/s",
          flush=True)


def trace_kernels(fn, calls):
    """Device time per kernel name over ``calls`` calls of ``fn``, from a
    ``jax.profiler`` trace: for each line of each GPU plane, the total
    duration and count of each event name (µs per call), largest first."""
    import glob

    import jax
    from jax.profiler import ProfileData

    with tempfile.TemporaryDirectory(prefix="hsip-trace-") as tmp:
        with jax.profiler.trace(tmp):
            for _ in range(calls):
                jax.block_until_ready(fn())
        (path,) = glob.glob(f"{tmp}/**/*.xplane.pb", recursive=True)
        data = ProfileData.from_file(path)
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            per = {}
            for ev in line.events:
                tot, n = per.get(ev.name, (0.0, 0))
                per[ev.name] = (tot + ev.duration_ns, n + 1)
            top = sorted(per.items(), key=lambda kv: -kv[1][0])
            out[f"{plane.name}/{line.name}"] = [
                {"name": name[:120], "us_per_call": tot / calls / 1e3,
                 "events_per_call": n / calls}
                for name, (tot, n) in top[:12]
            ]
            total = sum(t for t, _ in per.values()) / calls / 1e3
            print(f"trace {plane.name} {line.name}: {total:.1f} us/call in "
                  f"{sum(n for _, n in per.values()) / calls:.0f} events; "
                  + "; ".join(f"{k[:40]} {t / calls / 1e3:.1f}"
                              for k, (t, _) in top[:6]), flush=True)
    return out


def time_end_to_end(work, data, n_frames, n_videos, res, pairs=3):
    import hsip_tpu.track.pallas_scan as ps
    from chip_smoke import CALIBRATION, OFFSET, hsip

    common = ["--no-images", "--no-sequences", "--quiet",
              "--calibration", CALIBRATION, "--position-offset", OFFSET]
    real_gate = ps.kernel_enabled
    shapes = {
        "per_file": (["--video-path", data["one"], "--backend", "device"],
                     n_frames),
        "library": (["--video-path", data["lib"], "--library"],
                    n_frames * n_videos),
    }
    samples = {}
    try:
        for way in ("kernel", "lax.scan"):  # warm-ups (compiles)
            ps.kernel_enabled = real_gate if way == "kernel" else (
                lambda: False)
            for shape, (argv, _n) in shapes.items():
                hsip([*argv, "--output-dir", work / "e2e", *common])
        for i in range(pairs):
            order = ("kernel", "lax.scan") if i % 2 == 0 else (
                "lax.scan", "kernel")
            for way in order:
                ps.kernel_enabled = real_gate if way == "kernel" else (
                    lambda: False)
                for shape, (argv, n) in shapes.items():
                    t0 = time.perf_counter()
                    hsip([*argv, "--output-dir", work / "e2e", *common])
                    dt = time.perf_counter() - t0
                    samples.setdefault(f"{shape}/{way}", []).append(dt)
    finally:
        ps.kernel_enabled = real_gate
    for key, ts in sorted(samples.items()):
        shape = key.split("/")[0]
        fps = [shapes[shape][1] / t for t in ts]
        res[f"e2e/{key}"] = {"s": ts, "frames_per_s": fps}
        print(f"end-to-end {key}: " + ", ".join(f"{f:.1f}" for f in fps)
              + " frames/s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=str(REPO / "hsip-output"
                                         / "scan_bench.json"))
    args = ap.parse_args(argv)

    import jax

    from chip_smoke import FRAMES, VIDEOS, real_profiles, write_library
    from hsip_tpu.utils import enable_persistent_compilation_cache
    from hsip_tpu.utils.backend import card_name_and_power_limit

    if jax.devices()[0].platform != "gpu":
        print("scan_bench: needs a GPU", file=sys.stderr)
        return 2
    card = card_name_and_power_limit()
    enable_persistent_compilation_cache()
    res = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "jax": jax.__version__}
    print(f"card: {card}; jax {jax.__version__}", flush=True)
    n_frames = 256 if args.quick else FRAMES
    with tempfile.TemporaryDirectory(prefix="hsip-scanbench-") as tmp:
        work = Path(tmp)
        data = write_library(work, n_frames, VIDEOS)
        prof, empty = real_profiles(data["meta"])
        time_scans(prof, empty, res, args.quick)
        time_band_chain(data["meta"], res)
        if not args.quick:
            time_end_to_end(work, data, n_frames, VIDEOS, res)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
