#!/usr/bin/env python
"""Smoke test of hsip on an NVIDIA GPU: the main path at real size.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the four-card phase only

One card (the default) runs, in this one process:

1. environment — the card's name and power limit (nvidia-smi), JAX's
   version and device, the compile-cache directory. No GPU: exit 2.
2. main path — one synthetic 2048-frame 128x1024 12-bit recording,
   hard-linked eight times; ``hsip --backend device`` on one recording and
   ``hsip --library`` on all eight, every table byte-compared with
   ``hsip --backend exact`` (the float64 host scan); prints the library
   path (fused or chunked) and the pipelined group count G.
3. scan kernel parity — the compiled Triton scan against ``lax.scan``
   for all four detectors at V = 1, 8, 16 and W = 1024, 1000: every
   output field bit-identical.
4. band chain parity — XLA's band chain against the float64 reference
   ops on the recording's 19x1024 bands: profiles within tolerance,
   integer positions equal.

``--four-cards`` runs ``hsip --library`` on one card, ``--mesh 4`` in one
process, and ``--distributed`` as four processes with one card each, and
requires the three sets of tables to be byte-identical. Each of those runs
is its own process; this one opens the cards only after they have exited.

Any failed phase exits non-zero. The card's name and power limit are on
the line before the last; the last line is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
HEIGHT, WIDTH, FRAMES, VIDEOS = 128, 1024, 2048, 8
CALIBRATION, OFFSET = "0.000833333", "1.0159"


def log(msg: str) -> None:
    print(msg, flush=True)


def write_library(work: Path, n_frames: int, n_videos: int) -> dict:
    """One synthetic recording plus ``n_videos`` hard-linked copies."""
    from hsip_tpu.io import CihxSpec, FlameSpec, write_recording
    from hsip_tpu.io import synthesize_flame_video

    # At 0.525 px/frame a 2048-frame front is tracked until it leaves the
    # domain at frame 1844 (543 detections), so the exit truncation runs
    # too. A faster front trips the velocity-drop stop within a few frames.
    flame = FlameSpec(x0=30.0, v0_px=0.525, ignition_frame=2, seed=42)
    frames, _ = synthesize_flame_video(n_frames, height=HEIGHT, width=WIDTH,
                                       flame=flame)
    spec = CihxSpec(width=WIDTH, height=HEIGHT, total_frames=n_frames,
                    record_rate=100_000, bit_depth=12)
    one = work / "one"
    meta = write_recording(one, "smoke-run-01-001", frames, spec=spec)
    del frames
    lib = work / "lib"
    lib.mkdir()
    for v in range(n_videos):
        stem = lib / f"smoke-run-{v + 1:02d}-001"
        shutil.copyfile(meta, stem.with_suffix(".cihx"))
        os.link(meta.with_suffix(".mraw"), stem.with_suffix(".mraw"))
    return {"one": one, "lib": lib, "meta": meta}


def tables(out_dir: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(out_dir.glob("*.txt"))}


def same_tables(got: dict, want_single: dict, label: str) -> None:
    """Every table in ``got`` equals the one-recording table of the same
    kind (all recordings are copies of one payload)."""
    if not got:
        raise AssertionError(f"{label}: no tables written")
    kinds = {name.split("-001-", 1)[1]: data
             for name, data in want_single.items()}
    for name, data in got.items():
        kind = name.split("-001-", 1)[1]
        if kinds.get(kind) != data:
            raise AssertionError(f"{label}: {name} differs from the "
                                 "float64 host scan's table")
    missing = set(kinds) - {n.split("-001-", 1)[1] for n in got}
    if missing:
        raise AssertionError(f"{label}: missing tables {sorted(missing)}")


def hsip(args) -> None:
    from hsip_tpu.cli import main

    rc = main([str(a) for a in args])
    if rc != 0:
        raise RuntimeError(f"hsip {' '.join(map(str, args))} exited {rc}")


def phase_main_path(work: Path, data: dict, n_frames: int, n_videos: int,
                    timings: dict) -> dict:
    from hsip_tpu.track import batch, fused

    common = ["--no-images", "--no-sequences", "--quiet",
              "--calibration", CALIBRATION, "--position-offset", OFFSET]
    t0 = time.perf_counter()
    hsip(["--video-path", data["one"], "--output-dir", work / "exact",
          "--backend", "exact", *common])
    timings["exact_s"] = time.perf_counter() - t0
    exact = tables(work / "exact")
    rows = sum(len(t.splitlines()) for t in exact.values())
    log(f"exact (float64 host scan): {len(exact)} tables, {rows} lines, "
        f"{timings['exact_s']:.1f} s")

    for run in ("cold", "warm"):
        out = work / f"device-{run}"
        t0 = time.perf_counter()
        hsip(["--video-path", data["one"], "--output-dir", out,
              "--backend", "device", *common])
        dt = time.perf_counter() - t0
        timings[f"per_file_{run}_s"] = dt
        same_tables(tables(out), exact, f"per-file device ({run})")
        log(f"per-file --backend device ({run}): {dt:.3f} s, "
            f"{n_frames / dt:.1f} frames/s, tables == exact")

    # "cold" and "warm" take the routing's own group count G; "G=4" forces
    # the pipelined route (HSIP_FUSED_GROUPS), which the routing leaves
    # aside where device_put returns before the copy ends.
    for run, groups_env in (("cold", None), ("warm", None), ("G=4", "4")):
        out = work / f"library-{run.replace('=', '')}"
        saved = os.environ.pop("HSIP_FUSED_GROUPS", None)
        if groups_env:
            os.environ["HSIP_FUSED_GROUPS"] = groups_env
        t0 = time.perf_counter()
        try:
            hsip(["--video-path", data["lib"], "--output-dir", out,
                  "--library", *common])
        finally:
            os.environ.pop("HSIP_FUSED_GROUPS", None)
            if saved is not None:
                os.environ["HSIP_FUSED_GROUPS"] = saved
        dt = time.perf_counter() - t0
        timings[f"library_{run}_s"] = dt
        got = tables(out)
        if len({n.split("-001-")[0] for n in got}) != n_videos:
            raise AssertionError(f"library ({run}): expected tables for "
                                 f"{n_videos} recordings, got {sorted(got)}")
        same_tables(got, exact, f"library ({run})")
        paths = list(batch.LAST_GROUP_PATHS)
        groups = len(fused._LAST_PIPELINE_TRACE) if paths == ["fused"] else 0
        log(f"library ({run}): {dt:.3f} s, "
            f"{n_videos * n_frames / dt:.1f} frames/s, path={paths}, "
            f"G={groups}, {len(got)} tables == exact")
        if groups_env and groups != min(int(groups_env), n_videos):
            raise AssertionError(f"library ({run}) took G={groups}")


def real_profiles(meta: Path):
    """The recording's device profiles, as the per-file pipeline makes
    them (packed band staging + the XLA band chain)."""
    from hsip_tpu import open_video
    from hsip_tpu.track import FlameDetectorConfig
    from hsip_tpu.track.scan import MIN_SIGNAL_FRACTION
    from hsip_tpu.track.scan import compute_profiles_batched

    with open_video(str(meta)) as video:
        read_packed, read_band, count_fn, depth = video.staging_paths()
        p = compute_profiles_batched(
            read_batch=video.read_batch, n_frames=len(video),
            frame_shape=video.frame_shape,
            background_scalar=float(video[0].max()),
            config=FlameDetectorConfig(), chunk_size=4096,
            read_packed=read_packed, read_band=read_band, count_fn=count_fn,
            read_band_counts=(video.band_bytes_and_counts
                              if read_band is not None else None),
            band_bit_depth=depth,
        )
    empty = p.signal_counts / p.total_pixels < MIN_SIGNAL_FRACTION
    return p, empty


def phase_scan_parity(meta: Path) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hsip_tpu.track.device_scan import device_tracking_scan
    from hsip_tpu.track.pallas_scan import pallas_tracking_scan_batched

    prof, empty0 = real_profiles(meta)
    real = {"combined": (prof.sobel_lines, prof.gradient_lines),
            "named": prof.intensity_lines}
    m = prof.frame_indices.size
    rng = np.random.default_rng(7)
    for W in (1024, 1000):
        for V in (1, 8, 16):
            # Video 0 is the real recording; the rest are noise rows with a
            # planted front, each with its own calibration and step cap.
            sob = rng.normal(0, 30, (V, m, W)).astype(np.float32)
            grad = rng.normal(0, 15, (V, m, W)).astype(np.float32)
            intens = np.abs(rng.normal(60, 40, (V, m, W))).astype(np.float32)
            for v in range(1, V):
                pos = (20 + (v % 7 + 1) * np.arange(m) // 4) % (W - 40)
                intens[v, np.arange(m)[:, None],
                       pos[:, None] + np.arange(8)] += 400.0
            sob[0] = real["combined"][0][:, :W]
            grad[0] = real["combined"][1][:, :W]
            intens[0] = real["named"][:, :W]
            empty = rng.random((V, m)) < 0.05
            empty[0] = empty0
            fidx = np.tile(np.arange(m, dtype=np.int32), (V, 1))
            cal = np.linspace(5e-4, 2e-3, V).astype(np.float32)
            fr = np.full(V, 1e5, np.float32)
            md = (np.arange(V, dtype=np.int32) % 6) + 1
            for method in ("combined", "threshold", "half_maximum",
                           "gradient"):
                prior = np.ones((V, m), bool)
                if method == "combined":
                    prior[:, 0] = False
                kw = dict(width=W, min_gradient_strength=np.float32(10.0),
                          sobel_threshold_fraction=np.float32(0.1),
                          ddt_velocity_jump=np.float32(1250.0),
                          method=method, method_fraction=np.float32(0.5))
                a = jax.vmap(
                    lambda f, s, g, it, e, hp, c, r, d: device_tracking_scan(
                        f, s, g, e, hp, calibration=c, frame_rate=r,
                        max_displacement_px=d, intensity_lines=it, **kw)
                )(fidx, sob, grad, intens, empty, prior, cal, fr, md)
                b = pallas_tracking_scan_batched(
                    fidx, sob, grad, jnp.asarray(empty), jnp.asarray(prior),
                    calibration=cal, frame_rate=fr, max_displacement_px=md,
                    intensity_lines=jnp.asarray(intens), **kw,
                )
                for name in a._fields:
                    va = np.asarray(getattr(a, name))
                    vb = np.asarray(getattr(b, name)).astype(va.dtype)
                    if not np.array_equal(va, vb):
                        raise AssertionError(
                            f"kernel != lax.scan: {method} V={V} W={W} "
                            f"field {name} ({int((va != vb).sum())} differ)"
                        )
                hits = int((np.asarray(a.final_position) >= 0).sum())
                log(f"scan parity {method:12s} V={V:2d} W={W}: "
                    f"bit-identical, {hits} detections")


def phase_band_parity(meta: Path) -> None:
    import numpy as np

    from hsip_tpu import open_video
    from hsip_tpu.kernels import reference as ref
    from hsip_tpu.track import FlameDetectorConfig

    cfg = FlameDetectorConfig()
    prof, _ = real_profiles(meta)
    with open_video(str(meta)) as video:
        n = len(video)
        bg = float(video[0].max())
        picks = np.linspace(8, n - 1, 16).astype(int)
        c = video.frame_shape[0] // 2
        k, sigma, thr = (cfg.morphology_kernel_size, cfg.gaussian_sigma,
                         cfg.frame_diff_threshold)
        peak = 0.0
        worst = 0.0
        for i in picks:
            cur = ref.subtract_scalar_background(video.read_batch(i, i + 1)[0], bg)
            pri = ref.subtract_scalar_background(
                video.read_batch(i - 1, i)[0], bg)
            peak = max(peak, float(cur.max()))
            diff = cur - pri
            diff[diff < thr] = 0
            blurred = ref.gaussian_filter(ref.grey_opening(diff, (k, k)),
                                          sigma)
            h_sob = ref.sobel(blurred, axis=1)[c]
            h_grad = ref.gradient_x(blurred)[c]
            # f32 against f64: a few f32 ulps at the operands' scale (the
            # Sobel taps subtract sums of up to 4x the band's peak).
            atol = 1e-3 + 8 * np.finfo(np.float32).eps * 4 * float(cur.max())
            for label, got, want in (
                ("sobel", prof.sobel_lines[i], h_sob),
                ("gradient", prof.gradient_lines[i], h_grad),
                ("intensity", prof.intensity_lines[i], blurred[c]),
            ):
                err = np.abs(np.asarray(got, np.float64) - want)
                worst = max(worst, float((err / (atol + 1e-5 * np.abs(want)))
                                         .max()))
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                           err_msg=f"{label} frame {i}")
            if h_grad.min() < -cfg.min_gradient_strength:
                if int(np.argmin(prof.gradient_lines[i])) != int(
                        np.argmin(h_grad)):
                    raise AssertionError(f"argmin(gradient) frame {i}")
            smax = np.abs(h_sob).max()
            if smax > cfg.min_gradient_strength:
                h_pos = np.nonzero(np.abs(h_sob) > 0.1 * smax)[0][-1]
                d = np.abs(prof.sobel_lines[i])
                d_pos = np.nonzero(d > 0.1 * d.max())[0][-1]
                if h_pos != d_pos:
                    raise AssertionError(f"rightmost Sobel frame {i}")
    log(f"band chain parity: {len(picks)} frames of {WIDTH} px, profiles "
        f"within tolerance (worst {worst:.3f} of it), positions equal")


def one_card(args) -> int:
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default backend is "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 2
    from hsip_tpu.utils import enable_persistent_compilation_cache

    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    log(f"compile cache: {enable_persistent_compilation_cache()}")

    timings: dict = {}
    failed = []
    with tempfile.TemporaryDirectory(prefix="hsip-smoke-") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        data = write_library(work, args.frames, args.videos)
        log(f"synthesized {args.frames}x{HEIGHT}x{WIDTH} 12-bit recording "
            f"x{args.videos} (hard links) in {time.perf_counter() - t0:.1f} s")
        phases = (
            ("main path", lambda: phase_main_path(
                work, data, args.frames, args.videos, timings)),
            ("scan kernel parity", lambda: phase_scan_parity(data["meta"])),
            ("band chain parity", lambda: phase_band_parity(data["meta"])),
        )
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn()
                log(f"PHASE OK   {name} ({time.perf_counter() - t0:.1f} s)")
            except Exception:
                traceback.print_exc()
                log(f"PHASE FAIL {name}")
                failed.append(name)
    log("timings: " + json.dumps({k: round(v, 4) for k, v in timings.items()}))
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    return finish(devices)


def run_cli(argv, env=None, **popen):
    return subprocess.Popen(
        [sys.executable, "-m", "hsip_tpu.cli", *map(str, argv)],
        cwd=REPO, env=env, **popen,
    )


def four_cards(args) -> int:
    """hsip --library on one card vs --mesh 4 vs four --distributed
    processes (one card each): byte-identical tables."""
    common = ["--library", "--no-images", "--no-sequences", "--quiet",
              "--platform", "cuda", "--calibration", CALIBRATION,
              "--position-offset", OFFSET]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with tempfile.TemporaryDirectory(prefix="hsip-smoke4-") as tmp:
        work = Path(tmp)
        data = write_library(work, args.frames, args.videos)
        runs = {}
        for label, extra, dev_env in (
            ("one card", [], {"CUDA_VISIBLE_DEVICES": "0"}),
            ("--mesh 4", ["--mesh", "4"], {}),
        ):
            out = work / label.replace(" ", "_")
            t0 = time.perf_counter()
            proc = run_cli(["--video-path", data["lib"], "--output-dir", out,
                            *common, *extra], env={**env, **dev_env})
            if proc.wait(timeout=900) != 0:
                log(f"FAILED: hsip {label} exited {proc.returncode}")
                return 1
            runs[label] = tables(out)
            log(f"{label}: {len(runs[label])} tables, "
                f"{time.perf_counter() - t0:.1f} s (process incl. compile)")

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out = work / "distributed"
        t0 = time.perf_counter()
        procs = [
            run_cli(["--video-path", data["lib"], "--output-dir", out,
                     *common, "--distributed",
                     "--coordinator", f"localhost:{port}",
                     "--num-processes", "4", "--process-id", str(i)],
                    env=env)
            for i in range(4)
        ]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(rcs):
            log(f"FAILED: --distributed ranks exited {rcs}")
            return 1
        runs["--distributed x4"] = tables(out)
        log(f"--distributed x4: {len(runs['--distributed x4'])} tables, "
            f"{time.perf_counter() - t0:.1f} s (processes incl. compile)")

    ref = runs["one card"]
    if len(ref) < args.videos:
        log(f"FAILED: one-card run wrote {len(ref)} tables")
        return 1
    for label, got in runs.items():
        if got != ref:
            log(f"FAILED: {label} tables differ from the one-card run")
            return 1
        log(f"{label}: {len(got)} tables byte-identical to the one-card run")

    import jax  # only now: the runs above had the cards to themselves

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < 4:
        log(f"FAILED: expected 4 GPUs, JAX sees {devices}")
        return 1
    return finish(devices)


def finish(devices) -> int:
    from hsip_tpu.utils.backend import card_name_and_power_limit

    log("card: " + card_name_and_power_limit().replace("\n", " | "))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--videos", type=int, default=VIDEOS)
    args = ap.parse_args(argv)

    from hsip_tpu.utils.backend import card_name_and_power_limit

    try:
        log("card: " + card_name_and_power_limit().replace("\n", " | "))
    except RuntimeError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    return four_cards(args) if args.four_cards else one_card(args)


if __name__ == "__main__":
    sys.exit(main())
