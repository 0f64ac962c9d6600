"""Test configuration: an 8-device virtual CPU mesh by default.

Tests run on CPU with 8 virtual XLA devices so sharding/shard_map paths
execute without accelerator hardware — the idiomatic replacement for the
reference's "serial fallback as test harness" (src/photron/parallel.py:47-54).
Must be set before jax is imported anywhere. The card-only tests (marker
``gpu``) run with an explicit ``JAX_PLATFORMS=cuda`` on a machine with a
GPU; everywhere else they skip.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import re as _re

flags = os.environ.get("XLA_FLAGS", "")
# Force EXACTLY 8 virtual devices, replacing any preset count.
flags = _re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
flags += " --xla_force_host_platform_device_count=8"
# Cap XLA:CPU codegen at AVX2: some virtual machines mask CPUID features that
# LLVM's native detection still reports (amx/avx512fp16 & co), and the
# resulting executables can hit SIGILL/segfaults. The cap also silences
# the per-compile cpu_aot_loader machine-feature-mismatch errors.
if "--xla_cpu_max_isa" not in flags:
    flags += " --xla_cpu_max_isa=AVX2"
os.environ["XLA_FLAGS"] = flags.strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hsip_tpu.io import (  # noqa: E402
    CihxSpec,
    FlameSpec,
    synthesize_flame_video,
    write_recording,
)


@pytest.fixture(scope="session")
def flame_recording(tmp_path_factory):
    """A small synthetic flame recording on disk (cihx + mraw) with its
    analytic trajectory."""
    tmp = tmp_path_factory.mktemp("videos")
    flame = FlameSpec(x0=40.0, v0_px=7.0, ignition_frame=2, seed=123)
    frames, positions = synthesize_flame_video(
        n_frames=40, height=64, width=384, flame=flame
    )
    spec = CihxSpec(
        width=384,
        height=64,
        total_frames=40,
        record_rate=80_000,
        bit_depth=12,
        start_frame=-8,
        skip_frame=1,
    )
    meta_path = write_recording(tmp, "synthetic-run-1-a", frames, spec=spec)
    return {
        "path": meta_path,
        "frames": frames,
        "positions": positions,
        "spec": spec,
        "flame": flame,
        "dir": tmp,
    }


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time, so
    every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")
