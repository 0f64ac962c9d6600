"""Card-only checks: the COMPILED Triton scan kernel against lax.scan.

Interpret mode (tests/test_pallas_scan.py) proves the kernel's logic; only
the compiled kernel shows what Triton's code generation does to it (its
own division, contraction and reduction lowering). Run on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py

Elsewhere every test here skips (the ``gpu`` fixture decides at run time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hsip_tpu.track.device_scan import device_tracking_scan
from hsip_tpu.track.pallas_scan import pallas_tracking_scan_batched

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("W", [1024, 1000])
@pytest.mark.parametrize(
    "method", ["combined", "threshold", "half_maximum", "gradient"]
)
def test_compiled_kernel_matches_lax_scan(gpu, method, W):
    V, M = 8, 512
    rng = np.random.default_rng(W + len(method))
    sob = rng.normal(0, 30, (V, M, W)).astype(np.float32)
    grad = rng.normal(0, 15, (V, M, W)).astype(np.float32)
    intens = np.abs(rng.normal(60, 40, (V, M, W))).astype(np.float32)
    for v in range(V):
        pos = (20 + (3 + v) * np.arange(M)) % (W - 30)
        intens[v, np.arange(M)[:, None], pos[:, None] + np.arange(8)] += 400
    empty = rng.random((V, M)) < 0.1
    prior = np.ones((V, M), bool)
    fidx = np.tile(np.arange(M, dtype=np.int32), (V, 1))
    cal = np.linspace(8e-4, 1.2e-3, V).astype(np.float32)
    fr = np.full(V, 1e5, np.float32)
    md = (np.arange(V, dtype=np.int32) % 5) + 1
    kw = dict(width=W, min_gradient_strength=np.float32(10.0),
              sobel_threshold_fraction=np.float32(0.1),
              ddt_velocity_jump=np.float32(1250.0), method=method,
              method_fraction=np.float32(0.5))
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
        np.testing.assert_array_equal(
            np.asarray(getattr(a, name)),
            np.asarray(getattr(b, name)).astype(
                np.asarray(getattr(a, name)).dtype),
            err_msg=name,
        )
    assert int((np.asarray(a.final_position) >= 0).sum()) > V * M // 4
