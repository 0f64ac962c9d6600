#!/usr/bin/env python
"""Render the fused library's staging↔compute pipeline timeline.

The fused library path (``hsip_tpu/track/fused.py``) can split a library
into G sub-batch programs: group g is gathered, shipped and DISPATCHED
before group g+1's gather begins, and no result is fetched until every
group is in flight — so group g's device compute runs under group g+1's
host gather. This tool makes that overlap *visible* from the recorded
per-group timestamps (``fused._LAST_PIPELINE_TRACE``) instead of arguing
it from end-to-end numbers, which link weather can hide:

    python tools/pipeline_trace.py [--videos 8] [--frames 256]
        [--groups 1 4] [--platform cpu] [--width 512] [--height 64]

For each requested G it prints one row per group — gather window,
dispatch time, the moment the group's inputs were released, and when its
results landed — plus the derived summary:

    overlap_s   host gather time spent while >=1 earlier program was in
                flight (the pipelining; 0 by construction at G=1)
    tail_s      wall from the LAST dispatch to the last result — the
                device compute left exposed (first-order: compute/G)

Outputs are checked row-identical across every swept G (grouping is
output-invariant by construction; per-video results are independent).

The tool is measurement evidence for BASELINE.md's staging↔compute
pipelining statement; ``docs/evidence/pipeline_trace_r5_cpu.log``
archives a CPU run (host timestamps only — no device metric).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--videos", type=int, default=8)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--groups", type=int, nargs="*", default=[1, 4],
                    help="G values to sweep (HSIP_FUSED_GROUPS per run)")
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform (e.g. cpu) before backend "
                    "init")
    ap.add_argument("--repeats", type=int, default=3,
                    help="runs per G; the reported run is the fastest")
    args = ap.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
        if args.platform == "cpu" and "--xla_cpu_max_isa" not in os.environ.get(
            "XLA_FLAGS", ""
        ):
            # The dev VM faults on ISA extensions CPUID enumerates but the
            # kernel gates (CLAUDE.md); cap like the test conftest does.
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2"
            ).strip()

    # Platform forcing above must precede these (they pull jax/Pallas in).
    import tempfile

    from hsip_tpu import open_collection
    from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, \
        write_recording
    from hsip_tpu.track import FlameDetectorConfig
    import hsip_tpu.track.fused as fused

    config = FlameDetectorConfig()
    rows_by_g = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        print(f"building {args.videos} x {args.frames}-frame "
              f"{args.height}x{args.width} recordings ...", file=sys.stderr)
        flame = FlameSpec(x0=25.0, v0_px=args.width / (1.3 * args.frames),
                          accel_px=0.0, ignition_frame=2, seed=7)
        frames, _ = synthesize_flame_video(
            args.frames, height=args.height, width=args.width, flame=flame)
        spec = CihxSpec(width=args.width, height=args.height,
                        total_frames=args.frames, record_rate=100_000,
                        bit_depth=12)
        src = write_recording(d, "trace-run-01-001", frames, spec=spec)
        payload = Path(src).with_suffix(".mraw")
        for v in range(1, args.videos):
            cihx = d / f"trace-run-{v + 1:02d}-001.cihx"
            cihx.write_bytes(Path(src).read_bytes())
            os.link(payload, cihx.with_suffix(".mraw"))

        with open_collection(str(d)) as coll:
            videos = list(coll)
            w = videos[0].frame_shape[1]
            for g in args.groups:
                os.environ["HSIP_FUSED_GROUPS"] = str(g)
                best = None
                for _ in range(args.repeats):
                    t0 = time.perf_counter()
                    outs = fused.track_uniform_videos_fused(
                        videos, w, config, None, True)
                    wall = time.perf_counter() - t0
                    if outs is None:
                        print("fused path declined the group; nothing to "
                              "trace", file=sys.stderr)
                        return 2
                    if best is None or wall < best[0]:
                        best = (wall, list(fused._LAST_PIPELINE_TRACE))
                rows_by_g[g] = [
                    [(r[0], r[2]) for r in o.rows] for o in outs
                ]
                wall, trace = best
                t_base = trace[0]["gather_start_t"]
                print(f"\n=== G={g}  end_to_end={wall:.3f}s  "
                      f"(best of {args.repeats}) ===")
                print(f"{'grp':>3} {'gather':>15} {'dispatch':>9} "
                      f"{'inputs_rel':>10} {'finals':>8}")
                overlap = 0.0
                for i, tr in enumerate(trace):
                    gs = tr["gather_start_t"] - t_base
                    ge = tr["gather_end_t"] - t_base
                    dp = tr["dispatch_t"] - t_base
                    ir = tr["inputs_ready_t"] - t_base
                    fr = tr.get("finals_ready_t", float("nan")) - t_base
                    print(f"{i:>3} {gs:>7.3f}-{ge:>7.3f} {dp:>9.3f} "
                          f"{ir:>10.3f} {fr:>8.3f}")
                    if i > 0:
                        # Gather time spent while an earlier program was
                        # already dispatched (and not yet fetched) — the
                        # pipelined overlap window.
                        prev_dispatch = trace[i - 1]["dispatch_t"] - t_base
                        overlap += max(0.0, ge - max(gs, prev_dispatch))
                tail = (trace[-1].get("finals_ready_t", t_base) -
                        trace[-1]["dispatch_t"])
                gather_wall = sum(t["gather_end_t"] - t["gather_start_t"]
                                  for t in trace)
                print(f"  gather_wall={gather_wall:.3f}s  "
                      f"overlap_s={overlap:.3f}  tail_s={tail:.3f}")

    g0 = args.groups[0]
    for g in args.groups[1:]:
        if rows_by_g[g] != rows_by_g[g0]:
            print(f"\nFAIL: rows differ between G={g0} and G={g}",
                  file=sys.stderr)
            return 1
    print(f"\nrows identical across G={args.groups} "
          f"({sum(len(r) for r in rows_by_g[g0])} rows/video-set)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
