"""Stage-attributed profiling of the single-video and library pipelines.

Builds (and caches under --cache-dir, default build/stage_cache in the
checkout) a synthetic recording + an N-video library of hard links, then times both
pipeline shapes with :class:`hsip_tpu.utils.StageTimes` attribution.

Usage: python tools/stage_profile.py [--frames 2048] [--videos 8]
       [--repeat 3] [--mode both|single|library] [--platform cpu]

The cache survives across runs so iterating on staging/overlap changes
does not repeat the synthesis.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--videos", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--mode", choices=("both", "single", "library"),
                    default="both")
    ap.add_argument(
        "--cache-dir",
        default=str(Path(__file__).resolve().parent.parent / "build"
                    / "stage_cache"),
    )
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu) before backend init")
    args = ap.parse_args()

    if args.platform:
        os.environ.setdefault("XLA_FLAGS", "")
        if args.platform == "cpu" and "--xla_cpu_max_isa" not in os.environ["XLA_FLAGS"]:
            os.environ["XLA_FLAGS"] += " --xla_cpu_max_isa=AVX2"
        import jax

        jax.config.update("jax_platforms", args.platform)

    from hsip_tpu.io import (
        CihxSpec, FlameSpec, synthesize_flame_video, write_recording,
    )
    from hsip_tpu import open_collection, open_video
    from hsip_tpu.track import FlameDetectorConfig
    from hsip_tpu.track.batch import track_collection_device
    from hsip_tpu.track.scan import track_video
    from hsip_tpu.utils import StageTimes, enable_persistent_compilation_cache

    enable_persistent_compilation_cache()

    cache = Path(args.cache_dir) / (
        f"f{args.frames}-h{args.height}-w{args.width}"
    )
    meta = cache / "bench-run-1-001.cihx"
    if not meta.exists():
        cache.mkdir(parents=True, exist_ok=True)
        print(f"synthesizing {args.frames} frames into {cache} ...",
              file=sys.stderr)
        flame = FlameSpec(
            x0=30.0, v0_px=args.width / (1.3 * args.frames),
            accel_px=0.0, ignition_frame=2, seed=42,
        )
        frames, _ = synthesize_flame_video(
            args.frames, height=args.height, width=args.width, flame=flame
        )
        spec = CihxSpec(width=args.width, height=args.height,
                        total_frames=args.frames, record_rate=100_000,
                        bit_depth=12)
        write_recording(cache, "bench-run-1-001", frames, spec=spec)
    lib = cache / f"lib{args.videos}"
    if not (lib / f"bench-run-{args.videos:02d}-001.cihx").exists():
        lib.mkdir(exist_ok=True)
        for v in range(args.videos):
            cihx = lib / f"bench-run-{v + 1:02d}-001.cihx"
            mraw = lib / f"bench-run-{v + 1:02d}-001.mraw"
            if not cihx.exists():
                shutil.copyfile(meta, cihx)
            if not mraw.exists():
                os.link(meta.with_suffix(".mraw"), mraw)

    config = FlameDetectorConfig()
    report = {}

    if args.mode in ("both", "single"):
        with open_video(str(meta)) as v:  # warm-up (compiles)
            track_video(v, config, 0.000833333, scan="device")
        best, best_st = float("inf"), None
        for _ in range(args.repeat):
            st = StageTimes()
            t0 = time.perf_counter()
            with open_video(str(meta)) as v:
                out = track_video(
                    v, config, 0.000833333, scan="device", stage_times=st
                )
            dt = time.perf_counter() - t0
            if dt < best:
                best, best_st = dt, st
        report["single"] = {
            "end_to_end_s": round(best, 3),
            "fps": round(args.frames / best, 1),
            "rows": len(out.rows),
            "stages": best_st.as_dict(),
        }

    if args.mode in ("both", "library"):
        with open_collection(str(lib)) as coll:  # warm-up
            track_collection_device(coll, config)
        best, best_st = float("inf"), None
        for _ in range(args.repeat):
            st = StageTimes()
            t0 = time.perf_counter()
            with open_collection(str(lib)) as coll:
                outs = track_collection_device(coll, config, stage_times=st)
            dt = time.perf_counter() - t0
            if dt < best:
                best, best_st = dt, st
        total = args.frames * args.videos
        report["library"] = {
            "end_to_end_s": round(best, 3),
            "fps": round(total / best, 1),
            "videos": args.videos,
            "rows": len(outs[0].rows),
            "stages": best_st.as_dict(),
        }

    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
