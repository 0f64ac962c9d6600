"""Multi-chip dry-run: the full sharded processing step on tiny shapes.

Validates that the production sharding compiles and executes at a given
device count without real hardware: a 2-D (video × frame) mesh, the
halo-exchange map phase per video, cross-axis collectives, and on-device
candidate extraction (the device half of the scan).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "build_multichip_step",
    "run_multichip_dryrun",
    "run_pipeline_dryrun",
]


def build_multichip_step(mesh, height: int, width: int, axis_frame: str = "frame",
                         axis_video: str = "video"):
    """Jitted full step over a ('video', 'frame') mesh.

    Input: (V, N, H, W) frames, sharded (video, frame, -, -). Per shard:
    background-subtract, band-extract, halo-exchange differencing priors over
    the frame axis, opening→blur→Sobel/gradient centerline profiles, then
    on-device candidate extraction (argmin gradient + rightmost-|Sobel|) and
    a cross-video psum of signal counts (exercises the second mesh axis).
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..kernels.preprocess import band_margin, gaussian_taps, reflect_indices
    from .sharding import shard_band_profiles

    margin = band_margin(3, 1.5)
    rows = reflect_indices(height // 2, margin, height)
    taps = gaussian_taps(1.5)
    n_frame_shards = mesh.shape[axis_frame]

    def per_shard(frames, background, diff_threshold, noise_threshold):
        # frames: (v_local, n_local, H, W). The band/halo/diff math is THE
        # production shard body (sharding.shard_band_profiles), vmapped over
        # the video axis — the dry-run validates exactly what ships.
        sob, grad, _intens, _raw, counts = jax.vmap(
            lambda fr: shard_band_profiles(
                fr, background, diff_threshold, noise_threshold,
                rows=rows, margin=margin, morphology_kernel_size=3,
                taps=taps, axis_name=axis_frame, n_shards=n_frame_shards,
            )
        )(frames)

        # On-device candidate extraction (device half of the scan).
        pos_min_grad = jnp.argmin(grad, axis=-1)             # (v, n)
        abs_sob = jnp.abs(sob)
        smax = jnp.max(abs_sob, axis=-1, keepdims=True)
        above = abs_sob > 0.1 * smax
        col = jax.lax.broadcasted_iota(jnp.int32, abs_sob.shape, abs_sob.ndim - 1)
        pos_rightmost = jnp.max(jnp.where(above, col, -1), axis=-1)

        # Cross-video collective: total above-noise pixels across ALL videos
        # and frames (a global run statistic) — psum over both axes.
        total_signal = jax.lax.psum(
            jax.lax.psum(jnp.sum(counts), axis_frame), axis_video
        )
        return pos_min_grad, pos_rightmost, total_signal, sob, grad

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis_video, axis_frame, None, None), P(), P(), P()),
        out_specs=(
            P(axis_video, axis_frame),
            P(axis_video, axis_frame),
            P(),
            P(axis_video, axis_frame, None),
            P(axis_video, axis_frame, None),
        ),
        check_vma=False,
    )
    return jax.jit(sharded)


def run_multichip_dryrun(n_devices: int, height: int = 24, width: int = 128,
                         frames_per_shard: int = 2) -> Tuple:
    """Build an ``n_devices`` mesh, jit the full step, run once on tiny shapes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} devices, "
            f"found {len(devices)}"
        )
    # Factor the device count into (video, frame) axes — 2 video groups when
    # even (real dp over videos), else a single group.
    v = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    f = n_devices // v
    mesh = Mesh(np.array(devices).reshape(v, f), ("video", "frame"))

    n_frames = f * frames_per_shard
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 4096, size=(v, n_frames, height, width), dtype=np.uint16)

    step = build_multichip_step(mesh, height, width)
    sharding = NamedSharding(mesh, P("video", "frame", None, None))
    frames_dev = jax.device_put(frames, sharding)
    pos_g, pos_s, total, sob, grad = step(
        frames_dev, jnp.float32(100.0), jnp.float32(5.0), jnp.float32(50.0)
    )
    jax.block_until_ready((pos_g, pos_s, total))
    assert pos_g.shape == (v, n_frames)
    assert pos_s.shape == (v, n_frames)

    # Second half of the FULL production step: the tracking state machine
    # as a vmapped lax.scan over the video axis (what library mode ships,
    # track/batch.py), video-sharded on the same mesh.
    from ..track.device_scan import device_tracking_scan

    def vshard(x, *rest_axes):
        return jax.device_put(
            np.asarray(x), NamedSharding(mesh, P("video", *rest_axes))
        )

    fi = np.broadcast_to(np.arange(n_frames, dtype=np.int32), (v, n_frames))
    empty = np.zeros((v, n_frames), dtype=bool)
    has_prior = np.ones((v, n_frames), dtype=bool)
    has_prior[:, 0] = False
    scan_v = jax.vmap(
        lambda f, s, g, e, hp: device_tracking_scan(
            f, s, g, e, hp,
            width=width,
            min_gradient_strength=jnp.float32(10.0),
            sobel_threshold_fraction=jnp.float32(0.1),
            ddt_velocity_jump=jnp.float32(1250.0),
            calibration=jnp.float32(8.3e-4),
            frame_rate=jnp.float32(100_000.0),
            max_displacement_px=jnp.int32(3),
        )
    )
    res = jax.jit(scan_v)(
        vshard(fi, None),
        vshard(sob, None, None),
        vshard(grad, None, None),
        vshard(empty, None),
        vshard(has_prior, None),
    )
    jax.block_until_ready(res)
    assert res.final_position.shape == (v, n_frames)

    return np.asarray(pos_g), np.asarray(pos_s), float(np.asarray(total))


def run_pipeline_dryrun(n_devices: int) -> int:
    """End-to-end ORCHESTRATION dry-run on an ``n_devices`` video mesh.

    Where :func:`run_multichip_dryrun` validates the sharded kernel step in
    isolation, this exercises the production path the CLI ships —
    ``pipeline.process_video_source_library``: recording discovery, the
    staged map phase per video, the vmapped on-device scan sharded over the
    mesh's video axis, and results-table writing — and asserts the tables
    are byte-identical to an unsharded library run. Returns the number of
    recordings processed.
    """
    import shutil
    import tempfile
    from pathlib import Path

    import jax

    from ..io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
    from ..pipeline import process_video_source_library
    from ..track.config import FlameDetectorConfig, VideoSourceConfig
    from .mesh import make_mesh

    mesh = make_mesh("video", devices=jax.devices()[:n_devices],
                     n_devices=n_devices)

    tmp = Path(tempfile.mkdtemp(prefix="hsip-dryrun-"))
    try:
        spec = CihxSpec(width=128, height=24, total_frames=14,
                        record_rate=100_000, bit_depth=12)
        for i, flame in enumerate((
            FlameSpec(x0=15.0, v0_px=7.0, ignition_frame=1, seed=31),
            FlameSpec(x0=12.0, v0_px=5.0, ignition_frame=2, seed=32),
            FlameSpec(x0=18.0, v0_px=6.0, ignition_frame=1, seed=33),
        )):
            frames, _ = synthesize_flame_video(14, height=24, width=128,
                                               flame=flame)
            write_recording(tmp / "v", f"dry-run-{i + 1}-001", frames,
                            spec=spec)

        def run(out_name, use_mesh, method="combined"):
            cfg = VideoSourceConfig(
                name="Dryrun", calibration=8.3e-4,
                save_frame_images=False, save_stacked_sequences=False,
                detection_method=method,
            )
            cfg.video_path = str(tmp / "v")
            cfg.output_dir = str(tmp / out_name)
            outs = process_video_source_library(
                cfg, FlameDetectorConfig(), verbose=False,
                mesh=mesh if use_mesh else None,
            )
            return outs

        def compare(mesh_dir, single_dir):
            mesh_tables = sorted((tmp / mesh_dir).glob("*.txt"))
            single_tables = sorted((tmp / single_dir).glob("*.txt"))
            assert mesh_tables, f"{mesh_dir}: mesh run wrote no tables"
            assert [t.name for t in mesh_tables] == [
                t.name for t in single_tables
            ], (mesh_tables, single_tables)
            for mt, st in zip(mesh_tables, single_tables):
                assert mt.read_bytes() == st.read_bytes(), (
                    f"sharded table differs: {mt.name}"
                )

        from ..track.batch import LAST_GROUP_PATHS

        outs = run("out-mesh", use_mesh=True)
        # The uniform-shape group must take the FUSED one-program path
        # under the mesh: a silent fallback to the chunked
        # path would pass the byte-identity below while the artifact
        # claimed the fused property. (The artifact tail names the path.)
        mesh_paths = list(LAST_GROUP_PATHS)
        assert mesh_paths == ["fused"], (
            f"uniform-shape mesh group did not fuse: {mesh_paths}"
        )
        run("out-single", use_mesh=False)
        compare("out-mesh", "out-single")
        # Named-detector variant: the sharded kernel step carries the
        # intensity rows (a different shard_map arity) — certify it too.
        run("out-mesh-g", use_mesh=True, method="gradient")
        run("out-single-g", use_mesh=False, method="gradient")
        compare("out-mesh-g", "out-single-g")
        return len(outs), mesh_paths[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
