"""Whole-library fused tracking: V videos, G pipelined device programs.

The general library path (:mod:`hsip_tpu.track.batch`) runs a per-video
map phase (one kernel dispatch per chunk per video) before the batched
scan — ~10+ device executions per video, each paying a fixed dispatch and
synchronisation cost on top of its bytes.

This module restructures the library batch into the minimal dispatch
shape (fewer, larger XLA programs; one device-resident intermediate
graph; no host round-trips):

1. HOST: per-video band gather + packed noise counts (C++ codec),
   free-running ``device_put`` train of the packed payloads — nothing
   else is dispatched while payloads stream.
2. DEVICE, one jitted program per group: pad + stack the payload batch,
   unpack the packed bits, background-subtract, frame-difference against
   per-video priors, the Gaussian+morphology+Sobel band chain, then the
   tracking scan (the Pallas kernel on a GPU, one program per video) —
   profiles never leave device memory.
3. HOST: ONE blocking fetch per group of the (V, n) integer positions;
   float64 velocity/truncation reconstruction (`build_device_scan_output`)
   exactly as every other backend.

**Staging↔compute pipelining:** on links where host staging is the
bottleneck rather than the wire, the library splits into G sub-batch
programs (:func:`_fused_group_count`). Group g is gathered, shipped and
DISPATCHED before group g+1's gather begins, and no result is fetched
until every group is in flight — so group g's device compute runs under
group g+1's host gather. A lazily staged link keeps ONE program: grouping
would split the concurrent lazy put train that sets its transfer rate.

Bit-parity: the device chain is the same `band_to_profiles` +
`pallas_tracking_scan_batched` / vmapped `device_tracking_scan` every
other path uses; per-video results are independent, so grouping cannot
change them — outputs are REQUIRED to be identical to the per-video
host scan (tested in tests/test_fused.py).

Reference seam: this replaces the reference's per-video loop
(`/root/reference/scripts/process_videos.py:1308`) — the whole library
is G device programs instead of V sequential CPU pipelines.
"""

from __future__ import annotations

import os
import threading
import time
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

from .config import FlameDetectorConfig, VideoSourceConfig
from .tracker import FlameTracker

__all__ = ["track_uniform_videos_fused"]

# Share of the device's allocator limit the fused program's payload and
# dominant intermediates may claim (see _fused_budget_bytes). The rest is
# left to XLA's temporaries and, when the pipelined grouping engages, to the
# next group in flight.
_FUSED_MEMORY_FRACTION = 0.5


def _max_fused_bytes() -> int:
    """Per-device byte budget for one fused dispatch.

    ``_FUSED_MEMORY_FRACTION`` of the device's ``bytes_limit`` (its
    allocator limit: the memory this process may use). A CPU device
    reports no memory stats; its memory is the host's, so the budget is
    the same fraction of physical RAM. Any other device without stats is
    an error: the budget is derived, never assumed.
    """
    import jax

    dev = jax.local_devices()[0]
    stats = dev.memory_stats()
    if stats and "bytes_limit" in stats:
        limit = int(stats["bytes_limit"])
    elif dev.platform == "cpu":
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    else:
        raise RuntimeError(
            f"{dev.platform} device {dev.device_kind!r} reports no memory "
            "stats; cannot size the fused library budget"
        )
    return int(limit * _FUSED_MEMORY_FRACTION)


@lru_cache(maxsize=1)
def _puts_are_lazy() -> bool:
    """Measure whether ``device_put`` stages lazily on this link.

    One warm 8 MiB put: a lazily staged link (a remote-device tunnel)
    returns from the put call at once and pays the whole wire inside
    ``block_until_ready``; an eager-DMA link (PCIe) completes most of the
    wire inside the put call itself. The ratio routes the pipelined group
    count (:func:`_fused_group_count`) and the empty-range clip —
    measured once per process.

    Every routing outcome is row-identical by contract, so a "wrong"
    reading costs only the wire-shape optimization, never correctness.
    """
    import jax

    x = np.ones((8 << 20,), np.uint8)
    jax.block_until_ready(jax.device_put(x))  # warm the transfer path
    t0 = time.perf_counter()
    buf = jax.device_put(x)
    t_put = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(buf)
    t_block = time.perf_counter() - t0
    return t_block > t_put


def _staging_mode(mesh=None) -> str:
    """Route the library staging shape: ``one_put`` vs ``put_train``.

    Both link families take the per-video put train:

    - eager-DMA puts (PCIe): per-video puts issued as each gather lands
      overlap transfer k with gather k+1 — the train hides most of the
      wire behind host staging.
    - lazily staged puts: per-video puts left UNBLOCKED until the one
      fused program demands them transfer CONCURRENTLY.

    Mesh runs get the same routing: ``put_train`` there means PER-SHARD
    trains — each shard's videos assemble on its own device the moment
    that shard's gathers land (n_shards concurrent transfers), then one
    global array is built from the per-device shards with zero data
    movement. ``one_put`` stages one sharded transfer instead.

    ``HSIP_STAGING`` ∈ {auto, one_put, put_train} overrides.
    """
    mode = os.environ.get("HSIP_STAGING", "auto")
    if mode in ("one_put", "put_train"):
        return mode
    return "put_train"


def _fused_group_count(n_videos: int, mesh=None) -> int:
    """Pipelined sub-batch program count G for the fused library.

    G > 1 overlaps group g+1's host gather with group g's device compute
    (staging↔compute pipelining): each group is staged, shipped and
    dispatched before the next group's gather begins, and no result is
    fetched until every group is in flight. The serial exposure is
    ~(1/G)·(first gather + last compute), so G=4 hides ~3/4 of the
    device compute behind host staging.

    Default routing by link family: eager-DMA links (PCIe — where host
    staging, not the wire, bounds end-to-end) pipeline with ``min(4, V)``
    groups; lazily staged links keep ONE program, because grouping would
    split the concurrent lazy put train that sets their transfer rate.
    Mesh runs keep one (sharded) dispatch — the video axis is already
    spread over devices. ``HSIP_FUSED_GROUPS`` overrides (an integer;
    ``auto`` = this rule).
    """
    if mesh is not None or n_videos < 2:
        return 1
    env = os.environ.get("HSIP_FUSED_GROUPS", "auto")
    if env != "auto":
        try:
            return max(1, min(int(env), n_videos))
        except ValueError:
            return 1
    if _puts_are_lazy():
        return 1
    return min(4, n_videos)


# Reusable host staging buffers, shared by both staging modes.
# Allocating a fresh multi-hundred-MB array per call made every call
# re-pay the OS's first-touch page zeroing. Reuse is safe in BOTH modes: one_put blocks the transfer
# inside its h2d stage, and put_train blocks every per-video input
# buffer right after the program dispatch — either way the pool is idle
# before the next gather touches it. Keyed on (kind, shape); pipelined
# groups alternate between at most two shapes (equal groups ±1 video),
# so a small bounded pool avoids re-allocating every group.
_STAGING_POOL: dict = {}
_STAGING_POOL_MAX = 4  # ≤2 shapes per kind (buf/clip) in practice


def _pooled(kind: str, shape) -> np.ndarray:
    key = (kind, tuple(shape))
    buf = _STAGING_POOL.get(key)
    if buf is None:
        while len(_STAGING_POOL) >= _STAGING_POOL_MAX:
            _STAGING_POOL.pop(next(iter(_STAGING_POOL)))
        _STAGING_POOL[key] = buf = np.empty(shape, np.uint8)
    return buf


def _pooled_staging(shape) -> np.ndarray:
    return _pooled("buf", shape)


def _pooled_clip(shape) -> np.ndarray:
    """Second pooled host buffer for the clipped payload (same reuse
    contract as :func:`_pooled_staging`: BOTH staging modes guarantee
    the pool is idle before the call returns — one_put blocks the
    transfer inside its h2d stage; put_train blocks the shipped inputs
    right after the program dispatch)."""
    return _pooled("clip", shape)


# Introspection for tests: did the last fused call ship a clipped payload?
_LAST_CLIPPED = False

# Introspection for tests/tools: per-group pipeline timeline of the last
# fused call. One dict per group: gather/ship/dispatch host timestamps
# (perf_counter) plus finals_ready_t stamped when that group's results
# are fetched. tools/pipeline_trace.py renders it; the overlap claim
# (gather g+1 under program g) is read straight off these numbers.
_LAST_PIPELINE_TRACE: List[dict] = []


def _clip_threshold() -> float:
    """Coverage above which the empty-range clip is not worth its copy.

    ``HSIP_CLIP_EMPTY`` overrides (a float in (0, 1]; ``off``/``0``
    disables). Default 0.7: the clip costs one host memcpy of exactly the
    shipped bytes, so it must buy back ≥30% of the wire to clearly win.
    """
    raw = os.environ.get("HSIP_CLIP_EMPTY", "0.7")
    if raw in ("off", "0"):
        return 0.0
    try:
        return float(raw)
    except ValueError:
        return 0.7


def _clip_ranges(empty: np.ndarray, lengths, n_max: int):
    """Per-video non-empty ranges for the wire clip, or None to skip.

    Returns ``(lo, L_each, L)`` — each video's range start
    ``max(0, first_nonempty - 1)`` (keeping the first signal frame's
    differencing prior in-range), per-video range lengths, and the padded
    common length — when total coverage is below the threshold; ``None``
    when the batch is dense (ship-everything stays zero-copy) or the clip
    is disabled.
    """
    thr = _clip_threshold()
    if thr <= 0.0:
        return None
    Vp = empty.shape[0]
    lo = np.zeros(Vp, np.int64)
    L_each = np.zeros(Vp, np.int64)
    for i, n in enumerate(lengths):
        nz = np.flatnonzero(~empty[i, :n])
        if nz.size == 0:
            continue  # all-empty video: nothing ships, rows stay masked
        lo[i] = max(0, int(nz[0]) - 1)
        L_each[i] = int(nz[-1]) - lo[i] + 1
    total = int(L_each.sum())
    if total == 0 or total / float(Vp * n_max) > thr:
        return None
    # Bucket the padded length to a power of two (clamped to n_max): the
    # fused program jit-caches on shape, and ragged clip lengths would
    # otherwise trigger a compile per library. Pow-2 buckets bound the
    # shape variety to log2(n_max) programs.
    L = max(1, int(L_each.max()))
    L = min(n_max, 1 << (L - 1).bit_length())
    if L / float(n_max) > thr:
        return None  # bucketing ate the saving; ship-everything is free
    return lo, L_each, L


def _gather_workers(n_videos: int) -> int:
    """Concurrent per-video gathers for the library staging pool.

    Each native gather is already internally parallel (the codec floors
    OpenMP at 16 threads for page-fault I/O concurrency), so stacking
    several of them oversubscribes a small host. Default: serialize and
    let the codec's own threads do the overlapping. ``HSIP_GATHER_WORKERS`` overrides for
    many-core hosts where genuinely parallel gathers win.
    """
    env = os.environ.get("HSIP_GATHER_WORKERS")
    if env:
        return max(1, min(int(env), n_videos))
    return 1


def _fused_budget_bytes(n_videos: int, n_max: int, w: int, band_rows: int,
                        depth: int) -> int:
    """Payload + dominant intermediates for the fused program, in bytes.

    The staging buffer is PADDED to the longest video (one batched array),
    so the budget counts n_videos * n_max, not the sum of true lengths.
    """
    n_total = n_videos * n_max
    payload = n_total * band_rows * (w * depth // 8)
    band_f32 = n_total * band_rows * w * 4
    profiles = 3 * n_total * w * 4
    return payload + 2 * band_f32 + profiles


@lru_cache(maxsize=32)
def _fused_program(
    width: int,
    bit_depth: int,
    morphology_kernel_size: int,
    gaussian_sigma: float,
    method: str,
    use_frame_diff: bool,
    use_kernel: bool,
    interpret: bool,
    edge_margin_px: int,
    search_window_px: int,
    exit_margin_px: int,
    mesh=None,
    video_axis: str = "video",
    staging: str = "one_put",
):
    """Build (and cache) the one jitted device program for a static config.

    The returned callable takes the per-video packed payloads plus the
    host-prepared scan-side arrays and returns ONLY the (V, n_max) integer
    positions — everything else (profiles, advisory stop latches) is dead
    code XLA eliminates, so no intermediate ever crosses the link.

    ``staging`` selects the payload calling convention (see
    :func:`_staging_mode` for the routing):

    - ``"one_put"``: ONE batched (V, n_max, B, row_nbytes) array — one
      transfer (sharded under a mesh). Mesh put_train runs also use this
      convention: their per-shard trains assemble into the same one
      global array before dispatch (zero data movement).
    - ``"put_train"`` (no mesh): a TUPLE of V per-video
      (n_max, B, row_nbytes) arrays, each ``device_put`` as soon as its
      gather lands — transfer k overlaps gather k+1 on eager-DMA links
      (PCIe), and on lazily staged links the unblocked puts transfer
      CONCURRENTLY at program demand; the program stacks them on device
      (a device-side copy, ~free next to the wire).

    With ``mesh`` the WHOLE program (unpack → band chain → scan) is
    ``shard_map``-ped over ``video_axis`` — each device decodes and tracks
    only its own videos; nothing but the final (V, n_max) positions is
    ever assembled. The differencing-prior indices are computed inside the
    program from the shard-local shape, so every gather stays device-local
    (no cross-shard collective exists in the fused graph at all).
    """
    import jax
    import jax.numpy as jnp

    from ..kernels.preprocess import band_to_profiles
    from ..kernels.unpack import _UNPACKERS
    from . import pallas_scan
    from .device_scan import device_tracking_scan

    def run(stacked, bgs, fidx, empty, has_prior,
            cals, fpss, mds,
            frame_diff_threshold, min_grad, sobel_frac, ddt_jump,
            method_frac):
        # stacked: (V, n_max, B, row_nbytes) u8 — ONE host array, gathered
        # per-video straight into its slices (zero intermediate copies)
        # and shipped as ONE transfer — or, in put_train staging, a tuple
        # of V per-video arrays stacked here on device. Under shard_map V
        # is the LOCAL video count.
        if staging == "put_train":
            stacked = jnp.stack(stacked)
        V, n_max = stacked.shape[:2]
        # Frame j's differencing prior is frame j-1 of the SAME video
        # (j=0 has none). Rows past a video's true length are scan-masked
        # (`empty`), so their profile values are never read.
        flat_idx = jnp.arange(V * n_max, dtype=jnp.int32)
        prior_global = jnp.where(flat_idx % n_max > 0, flat_idx - 1, -1)
        pix = _UNPACKERS[bit_depth](stacked, out_dtype=jnp.float32)
        band = jnp.maximum(pix - bgs[:, None, None, None], 0.0)
        B = band.shape[2]
        flat = band.reshape(V * n_max, B, width)
        sob, grad, intens = band_to_profiles(
            flat, prior_global, frame_diff_threshold,
            morphology_kernel_size, gaussian_sigma,
        )
        sob = sob.reshape(V, n_max, width)
        grad = grad.reshape(V, n_max, width)
        if method == "combined":
            intens_sel = None
        elif use_frame_diff:
            intens_sel = intens.reshape(V, n_max, width)
        else:
            margin = (B - 1) // 2
            intens_sel = band[:, :, margin, :]  # raw centerline
        if use_kernel:
            res = pallas_scan.pallas_tracking_scan_batched(
                fidx, sob, grad, empty, has_prior,
                width=width,
                min_gradient_strength=min_grad,
                sobel_threshold_fraction=sobel_frac,
                ddt_velocity_jump=ddt_jump,
                calibration=cals,
                frame_rate=fpss,
                max_displacement_px=mds,
                edge_margin_px=edge_margin_px,
                search_window_px=search_window_px,
                exit_margin_px=exit_margin_px,
                interpret=interpret,
                method=method,
                intensity_lines=intens_sel,
                method_fraction=method_frac,
            )
        else:
            res = jax.vmap(
                lambda f, s, g, it, e, hp, c, r, md: device_tracking_scan(
                    f, s, g, e, hp,
                    width=width,
                    min_gradient_strength=min_grad,
                    sobel_threshold_fraction=sobel_frac,
                    ddt_velocity_jump=ddt_jump,
                    calibration=c,
                    frame_rate=r,
                    max_displacement_px=md,
                    edge_margin_px=edge_margin_px,
                    search_window_px=search_window_px,
                    exit_margin_px=exit_margin_px,
                    method=method,
                    intensity_lines=it,
                    method_fraction=method_frac,
                )
            )(
                fidx, sob, grad,
                (jnp.zeros_like(sob) if intens_sel is None else intens_sel),
                empty, has_prior, cals, fpss, mds,
            )
        return res.final_position

    if mesh is None:
        return jax.jit(run)

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    vm4 = P(video_axis, None, None, None)
    vm = P(video_axis, None)
    vs = P(video_axis)
    s = P()
    return jax.jit(shard_map(
        run,
        mesh=mesh,
        in_specs=(vm4, vs, vm, vm, vm, vs, vs, vs, s, s, s, s, s),
        out_specs=vm,
        check_vma=False,
    ))


def _shard_putters(mesh, video_axis: str, shape):
    """Per-shard device assignment for the mesh put train.

    Returns ``(vg, devices)``: the per-shard video count and the device
    owning each shard s (videos ``[s*vg, (s+1)*vg)``), in shard order —
    exactly the placement ``NamedSharding(mesh, P(video_axis, ...))``
    would produce, so the per-device arrays assemble into the sharded
    global array with zero data movement.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(
        mesh, P(video_axis, *([None] * (len(shape) - 1)))
    )
    idx_map = sharding.addressable_devices_indices_map(tuple(shape))
    n_shards = len(idx_map)
    vg = shape[0] // n_shards
    devices = [None] * n_shards
    for dev, idx in idx_map.items():
        devices[idx[0].start // vg] = dev
    return vg, devices, sharding


def track_uniform_videos_fused(
    videos,
    w: int,
    config: FlameDetectorConfig,
    source_config: Optional[VideoSourceConfig],
    use_absolute_time: bool,
    stage_times=None,
    mesh=None,
    video_axis: str = "video",
) -> Optional[List["TrackingOutput"]]:  # noqa: F821 — runtime import below
    """Fused library tracking for a uniform-shape video group.

    Returns the per-video :class:`TrackingOutput` list (identical to the
    serial host scan), or ``None`` when the group doesn't satisfy the fast
    path's preconditions — the caller then uses the general chunked path:

    - every video exposes the packed BAND staging path + C++ counts
      (byte-aligned rows, a supported bit depth) at one (H, W, depth);
    - no per-video skip lists;
    - the fused program's PER-DEVICE footprint fits the device budget
      (:func:`_max_fused_bytes`).

    On staging-bound links the library is split into G pipelined groups
    (:func:`_fused_group_count`): each group is gathered, shipped and
    dispatched before the next group's gather starts, and results are
    fetched only after every group is in flight — device compute runs
    under the next group's host staging. Per-video results are
    independent, so grouping is output-invariant by construction.

    With ``mesh`` the video axis is sharded: the batch pads to a multiple
    of the axis size with inert videos (all-empty frames — the scan
    records nothing for them), the staged payload lands with a
    :class:`~jax.sharding.NamedSharding` so each device receives only its
    shard — via ONE sharded put, or per-shard put trains when
    ``put_train`` routing is active (each shard ships the moment its
    gathers land; n_shards concurrent transfers) — and the whole program
    runs under ``shard_map`` (tables byte-identical to the unsharded run
    by the same contract as every other backend).

    Videos with dark preambles/tails additionally skip the wire and the
    device compute for their empty ranges (the empty-range clip — see
    :func:`_clip_ranges`); outputs stay bit-identical because both scan
    backends hard-gate empty rows. The clip engages when its copy can be
    traded against unshipped bytes: always for ``one_put`` (the batched
    put hasn't been issued yet), and for lazily staged put trains without
    a mesh (the per-video puts haven't moved a byte and are re-issued
    clipped); eager-DMA trains already paid the full wire inside the
    gathers, so clipping there would only add traffic.
    """
    import jax

    from ..kernels.preprocess import band_folds, band_margin, reflect_indices
    from ..utils.profiling import StageTimes
    from . import batch as _batch
    from .scan import MIN_SIGNAL_FRACTION, NOISE_THRESHOLD_FLOOR

    if os.environ.get("HSIP_FUSED", "1") == "0":
        return None
    if source_config is not None and tuple(source_config.skip_frames):
        return None
    method = source_config.detection_method if source_config else "combined"
    use_frame_diff = source_config.use_frame_diff if source_config else True

    staging = []
    shape0 = videos[0].frame_shape
    for v in videos:
        if v.frame_shape != shape0 or len(v) == 0:
            return None
        read_packed, read_band, count_fn, depth = v.staging_paths()
        if read_band is None or count_fn is None:
            return None
        staging.append((read_band, count_fn, depth))
    depth0 = staging[0][2]
    if any(d != depth0 for _, _, d in staging):
        return None
    h = shape0[0]
    margin = band_margin(config.morphology_kernel_size, config.gaussian_sigma)
    # Even morphology windows do not commute with a folding reflect band
    # (CLAUDE.md exactness trap): that configuration needs the float64
    # host ops, which only the general chunked path routes to.
    if config.morphology_kernel_size % 2 == 0 and band_folds(
        h // 2, margin, h
    ):
        return None
    n_shards = 1 if mesh is None else int(mesh.shape[video_axis])
    V = len(videos)
    n_max = max(len(v) for v in videos)
    Vp_total = V + ((-V) % n_shards)
    if (_fused_budget_bytes(Vp_total, n_max, w, 2 * margin + 1, depth0)
            > _max_fused_bytes() * n_shards):
        return None

    if stage_times is None:
        stage_times = StageTimes()

    rows = reflect_indices(h // 2, margin, h)
    rnb = w * depth0 // 8
    B = 2 * margin + 1
    staging_mode = _staging_mode(mesh)

    from . import pallas_scan

    def _stage_dispatch_group(group: List[int]) -> dict:
        """Gather, ship and DISPATCH one video group; no result fetch.

        Returns everything :func:`_finish_group` needs. On return the
        pooled host buffers are idle (one_put blocks its transfer inside
        h2d; put_train blocks the shipped inputs right after the
        dispatch), so the caller may immediately stage the next group —
        which is the pipelining: this group's program executes on device
        while the next group gathers on host.
        """
        from concurrent.futures import ThreadPoolExecutor

        trace = {"gather_start_t": time.perf_counter()}
        g_videos = [videos[i] for i in group]
        g_staging = [staging[i] for i in group]
        Vg = len(g_videos)
        v_pad = (-Vg) % n_shards
        Vp = Vg + v_pad

        # --- host staging: EVERY video gathers straight into its slice of
        # ONE batched (Vp, n_max, B, row_nbytes) pooled array (the C++
        # gather's `out` path — zero intermediate copies). Pad rows/videos
        # may hold stale bytes, which is safe — the scan hard-gates every
        # masked step on `empty`, so masked profile values are never
        # consumed. Mesh-pad video slices are re-zeroed for determinism.
        big = _pooled_staging((Vp, n_max, B, rnb))
        if v_pad:
            big[Vg:] = 0
        targets = [big[i] for i in range(Vg)]
        dev_bufs: List = [None] * Vp
        shard_bufs: List = [None] * n_shards
        bgs = np.zeros(Vp, np.float32)
        count_futs = [None] * Vg
        counts_done = [None] * Vg  # resolved counts from the fused one-pass

        # Per-shard trains assume exactly one device per video shard; a
        # mesh with extra axes replicates shards across devices, which
        # make_array_from_single_device_arrays would need one array per
        # DEVICE for — route that (no current caller builds one) to the
        # sharded one_put, which NamedSharding handles for any mesh.
        mesh_train = (staging_mode == "put_train" and mesh is not None
                      and mesh.devices.size == n_shards)
        eff_staging = staging_mode
        if mesh is not None and not mesh_train:
            eff_staging = "one_put"
        if mesh_train:
            vg_shard, shard_devices, sharding = _shard_putters(
                mesh, video_axis, (Vp, n_max, B, rnb)
            )
            # Videos remaining per shard before its slice can ship; the
            # pad videos of the last shard are zeroed above, so only real
            # gathers gate it. Guarded by a lock: HSIP_GATHER_WORKERS > 1
            # completes gathers out of order.
            shard_left = [
                max(0, min((s + 1) * vg_shard, Vg) - s * vg_shard)
                for s in range(n_shards)
            ]
            shard_lock = threading.Lock()
            # Pad-only shards (zeroed above) have no gather to trigger
            # their ship — put them on the wire now.
            for s in range(n_shards):
                if shard_left[s] == 0:
                    with stage_times.stage("h2d"):
                        shard_bufs[s] = jax.device_put(
                            big[s * vg_shard:(s + 1) * vg_shard],
                            shard_devices[s],
                        )

        def _gather_one(i):
            video = g_videos[i]
            read_band, count_fn, _d = g_staging[i]
            n = len(video)
            with stage_times.stage("read_gather"):
                bg = float(np.max(video[0]))
                bgs[i] = bg
                noise = max(NOISE_THRESHOLD_FLOOR, bg * 0.5)
                # Fused native pass: band rows AND counts in ONE sweep over
                # the packed payload (half the host DRAM traffic of
                # gather+count — the staging hot path is memory-bound).
                # Falls back to the two-pass shape only on a stale .so /
                # exotic container.
                fused_rc = video.band_bytes_and_counts(
                    0, n, rows, bg, noise, out=targets[i][:n]
                )
                if fused_rc is not None:
                    counts_done[i] = fused_rc[1]
                else:
                    count_futs[i] = count_pool.submit(
                        stage_times.wrap("counts_host", count_fn), 0, n, bg,
                        noise,
                    )
                    read_band(0, n, rows, out=targets[i][:n])
            if eff_staging == "put_train":
                # Ship the moment the bytes are ready: on an eager-DMA
                # link the put call IS the wire, so transfer i overlaps
                # gather i+1. On a lazily staged link the put returns in
                # microseconds and the transfers run CONCURRENTLY once the
                # fused program demands them — do NOT block per video here
                # (a blocked train serializes the transfers).
                if mesh_train:
                    # Per-SHARD train: ship shard s to its own device the
                    # moment its last gather lands.
                    s = i // vg_shard
                    with shard_lock:
                        shard_left[s] -= 1
                        ready = shard_left[s] == 0
                    if ready:
                        with stage_times.stage("h2d"):
                            shard_bufs[s] = jax.device_put(
                                big[s * vg_shard:(s + 1) * vg_shard],
                                shard_devices[s],
                            )
                else:
                    with stage_times.stage("h2d"):
                        dev_bufs[i] = jax.device_put(targets[i])

        with ThreadPoolExecutor(max_workers=1) as count_pool, \
                ThreadPoolExecutor(
                    max_workers=_gather_workers(Vg)) as gather_pool:
            gather_futs = [
                gather_pool.submit(_gather_one, i) for i in range(Vg)
            ]
            # Phase A: land EVERY gather (one_put: before its ONE put — the
            # transfer's wire pacing runs on the host CPU, so host work
            # concurrent with it slows the wire; put_train: the per-video/
            # per-shard puts already rode out inside the gathers).
            for fut in gather_futs:
                fut.result()
            trace["gather_end_t"] = time.perf_counter()

            # --- host-side scan metadata (resolves the count futures)
            # BEFORE any blocking transfer, so the wire owns the CPU
            # outright ---
            fidx = np.zeros((Vp, n_max), np.int32)
            fidx[:] = np.arange(n_max, dtype=np.int32)  # pad videos: inert
            empty = np.ones((Vp, n_max), bool)
            has_prior = np.ones((Vp, n_max), bool)
            cals = np.ones(Vp, np.float32)
            fpss = np.ones(Vp, np.float32)
            mds = np.ones(Vp, np.int32)
            calibs: List[Tuple[float, float]] = []
            profiles_meta = []
            for i, video in enumerate(g_videos):
                n = len(video)
                fidx[i, :n] = np.arange(n, dtype=np.int32)
                fidx[i, n:] = n + np.arange(n_max - n, dtype=np.int32)
                counts = np.asarray(
                    counts_done[i] if counts_done[i] is not None
                    else count_futs[i].result(),
                    dtype=np.int64,
                )
                empty[i, :n] = counts / float(h * w) < MIN_SIGNAL_FRACTION
                # First processed frame has no differencing prior. Named
                # methods on raw profiles need no prior at all.
                if method == "combined" or use_frame_diff:
                    has_prior[i, 0] = False
                if source_config is not None:
                    cal, off = source_config.get_calibration_for_file(
                        video.filepath.name
                    )
                else:
                    cal, off = 1.0, 0.0
                calibs.append((cal, off))
                cals[i] = cal
                fpss[i] = video.frame_rate
                mds[i] = FlameTracker(
                    config, video.frame_rate, cal
                ).max_displacement_px
                profiles_meta.append(_FusedMeta(fidx[i, :n], w))

            # --- empty-range wire clip ---
            # The reference's is_empty_frame skip avoids PROCESSING dark
            # frames but still reads them (`process_videos.py:743-763`);
            # here the counts land during the fused gather pass, so videos
            # with dark preambles/tails can additionally skip the WIRE and
            # device compute: ship only each video's [first_nonempty-1,
            # last] range (the -1 keeps the first signal frame's
            # differencing prior in-range) and scatter the scan outputs
            # back to full length on host. Rows outside the range are
            # empty by definition — the scan hard-gates them, so outputs
            # are bit-identical. The clip engages only when it pays
            # (coverage below HSIP_CLIP_EMPTY, default 0.7) AND the full
            # bytes haven't already crossed: one_put hasn't issued its put
            # yet; a LAZY put train's per-video puts haven't moved a byte
            # (dropping them and re-putting the clipped slices is free).
            # On an eager-DMA train (mesh or not) the wire is already
            # paid, so clipping would only add traffic.
            clip = None
            if eff_staging == "one_put" or (
                mesh is None and _puts_are_lazy()
            ):
                clip = _clip_ranges(empty, [len(v) for v in g_videos], n_max)
            if clip is not None:
                with stage_times.stage("clip_copy"):
                    lo, L_each, L = clip
                    small = _pooled_clip((Vp, L, B, rnb))
                    fidx_c = np.zeros((Vp, L), np.int32)
                    fidx_c[:] = n_max + np.arange(L, dtype=np.int32)
                    empty_c = np.ones((Vp, L), bool)
                    prior_c = np.ones((Vp, L), bool)
                    for i in range(Vp):
                        li = L_each[i]
                        if li == 0:
                            continue
                        small[i, :li] = big[i, lo[i]:lo[i] + li]
                        fidx_c[i, :li] = fidx[i, lo[i]:lo[i] + li]
                        fidx_c[i, li:] = fidx_c[i, li - 1] + np.arange(
                            1, L - li + 1, dtype=np.int32
                        )
                        empty_c[i, :li] = empty[i, lo[i]:lo[i] + li]
                        prior_c[i, :li] = has_prior[i, lo[i]:lo[i] + li]
                        if lo[i] > 0 and (
                            method == "combined" or use_frame_diff
                        ):
                            # The clip's row 0 is an empty frame whose
                            # profile is never read; mark it prior-less
                            # like row 0 of a full run (the program derives
                            # the actual differencing prior from array
                            # position).
                            prior_c[i, 0] = False
                    ship, fidx_s, empty_s, prior_s = small, fidx_c, \
                        empty_c, prior_c
            else:
                ship, fidx_s, empty_s, prior_s = big, fidx, empty, has_prior
            global _LAST_CLIPPED
            _LAST_CLIPPED = _LAST_CLIPPED or clip is not None

            # Phase B: ship the payload. one_put: ONE put of the whole
            # batch — the CPU is idle (gathers and counts all resolved), no
            # compute dispatched until the payload is in flight; under a
            # mesh the put is SHARDED so each device receives only its
            # videos' bytes. put_train: every per-video (or per-shard) put
            # already rode out inside its gather — unless the clip engaged,
            # in which case the full-length lazy puts never moved a byte
            # and are swapped for puts of the clipped per-video slices
            # here.
            with stage_times.stage("h2d"):
                if mesh_train:
                    stacked_dev = jax.make_array_from_single_device_arrays(
                        (Vp, n_max, B, rnb), sharding, shard_bufs
                    )
                elif eff_staging == "put_train":
                    if clip is not None:
                        dev_bufs = [jax.device_put(ship[i])
                                    for i in range(Vp)]
                    stacked_dev = tuple(dev_bufs)
                elif mesh is None:
                    stacked_dev = jax.device_put(ship)
                else:
                    from jax.sharding import NamedSharding, PartitionSpec \
                        as P

                    stacked_dev = jax.device_put(
                        ship,
                        NamedSharding(
                            mesh, P(video_axis, None, None, None)
                        ),
                    )
                if eff_staging == "one_put":
                    # Block the ONE put here so "h2d" measures the wire and
                    # the later blocking fetch measures device wait + fetch
                    # (device_put is lazily staged on some backends, which
                    # would silently shift wire time into d2h). Perf-neutral for a single
                    # put: nothing else runs until the program that
                    # consumes it is dispatched right after. It also makes
                    # the pooled host buffer provably idle before the next
                    # group/call reuses it.
                    jax.block_until_ready(stacked_dev)
                big = ship = None

        program = _fused_program(
            width=w,
            bit_depth=depth0,
            morphology_kernel_size=config.morphology_kernel_size,
            gaussian_sigma=config.gaussian_sigma,
            method=method,
            use_frame_diff=use_frame_diff,
            use_kernel=pallas_scan.kernel_enabled(),
            interpret=pallas_scan.INTERPRET,
            edge_margin_px=config.edge_margin_px,
            search_window_px=config.search_window_px,
            exit_margin_px=config.exit_margin_px,
            mesh=mesh,
            video_axis=video_axis,
            staging="one_put" if mesh_train else staging_mode,
        )
        kernel_fraction = np.float32(
            config.threshold_fraction if method == "threshold"
            else config.half_maximum_fraction
        )
        trace["dispatch_t"] = time.perf_counter()
        with stage_times.stage("device_dispatch"):
            finals_dev = program(
                stacked_dev, bgs, fidx_s, empty_s, prior_s,
                cals, fpss, mds,
                np.float32(config.frame_diff_threshold),
                np.float32(config.min_gradient_strength),
                np.float32(config.sobel_threshold_fraction),
                np.float32(config.ddt_velocity_jump_m_s),
                kernel_fraction,
            )
        if eff_staging == "put_train":
            # Block the INPUT train (or the per-shard arrays) only now,
            # AFTER the dispatch demanded all the lazy transfers — they
            # run concurrently (the measured 2x over one blocked put) —
            # and attribute the wait to "h2d" where it belongs. This also
            # makes the pooled host staging buffers provably idle before
            # the next group/call reuses them; the program itself keeps
            # executing on device while the host moves on.
            with stage_times.stage("h2d"):
                jax.block_until_ready(stacked_dev)
        del stacked_dev
        trace["inputs_ready_t"] = time.perf_counter()
        _LAST_PIPELINE_TRACE.append(trace)

        return {
            "finals_dev": finals_dev,
            "videos": g_videos,
            "profiles_meta": profiles_meta,
            "fidx": fidx,
            "empty": empty,
            "calibs": calibs,
            "clip": clip,
            "Vp": Vp,
            "trace": trace,
        }

    def _finish_group(rec) -> List:
        finals_dev = rec["finals_dev"]
        clip = rec["clip"]
        if clip is not None:
            # Scatter the clipped scan outputs back to full length so
            # every downstream consumer (float64 reconstruction,
            # truncation, empty counting) sees exactly the arrays an
            # unclipped run produces.
            lo, L_each, _L = clip
            with stage_times.stage("d2h"):
                fin = np.asarray(finals_dev)
            full = np.full((rec["Vp"], n_max), -1, np.int32)
            for i in range(rec["Vp"]):
                li = int(L_each[i])
                if li:
                    full[i, lo[i]:lo[i] + li] = fin[i, :li]
            finals_dev = full
        outs = _batch._outputs_from_scan(
            _FusedResult(finals_dev), rec["videos"], rec["profiles_meta"],
            rec["fidx"], rec["empty"], rec["calibs"], use_absolute_time,
            config, stage_times=stage_times,
        )
        rec["trace"]["finals_ready_t"] = time.perf_counter()
        return outs

    global _LAST_CLIPPED
    _LAST_CLIPPED = False
    _LAST_PIPELINE_TRACE.clear()

    n_groups = _fused_group_count(V, mesh)
    bounds = np.linspace(0, V, n_groups + 1).astype(int)
    groups = [list(range(bounds[g], bounds[g + 1]))
              for g in range(n_groups) if bounds[g + 1] > bounds[g]]

    # The pipeline: stage+dispatch every group back to back (group g's
    # program executes under group g+1's host gather), then fetch results
    # in order — the only blocking device waits of the whole call.
    pending = [_stage_dispatch_group(g) for g in groups]
    outputs: List = []
    for rec in pending:
        outputs.extend(_finish_group(rec))
    return outputs


class _FusedMeta:
    """The slice of FrameProfiles `_outputs_from_scan` actually reads
    (`frame_indices.size` and `width`)."""

    def __init__(self, frame_indices: np.ndarray, width: int):
        self.frame_indices = frame_indices
        self.width = width


class _FusedResult:
    """DeviceScanResult-shaped holder for the fused program's one output."""

    def __init__(self, final_position):
        self.final_position = final_position
