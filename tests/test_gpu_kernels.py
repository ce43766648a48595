"""The compositing kernels compiled for a real GPU (not interpret mode).

Skipped without a card; ``chip_smoke.py`` runs them on one:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gsplat_tpu as gt
from gsplat_tpu.parity import forward_parity, small_scene

pytestmark = pytest.mark.gpu


def test_full_width_forward_matches_tiles(gpu):
    """1M splats at 1920×1080, production config: the kernel matches the
    pure-XLA compositor (≤ 1e-5 at eps 0, ≤ eps at eps 1e-3) and drops no
    pair."""
    splats = gt.random_splats(
        jax.random.PRNGKey(0), 1_000_000, extent=1.2,
        scale_range=(0.002, 0.01), sh_scale=0.1,
    )
    cam = gt.make_camera(eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=1920, height=1080)
    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3)
    cfg = gt.tune_pair_budget(splats, cam, cfg, headroom=1.02)
    r = forward_parity(splats, cam, cfg, backend="pallas")
    assert r["ok"], r


@pytest.mark.parametrize("soft", [False, True])
def test_depth_tested_image_and_grads(gpu, soft):
    """Depth-tested compositing (the extra payload row and per-pixel kill)
    through the compiled kernels, hard and soft cutoff: image and
    gradients match the tiles backend."""
    splats, cam = small_scene(n=1024, size=128)
    cfg = gt.RenderConfig(transmittance_eps=0.0, soft_cutoff=soft, pairs_per_splat=16.0)
    depth = jnp.full((128, 128), 4.0).at[:, 64:].set(2.6)
    def loss(s, backend):
        img = gt.render(s, cam, cfg, backend=backend, background_depth=depth)
        return jnp.sum(img[..., :3]), img

    (_, a), ga = jax.jit(jax.value_and_grad(lambda s: loss(s, "tiles"), has_aux=True))(splats)
    (_, b), gb = jax.jit(jax.value_and_grad(lambda s: loss(s, "pallas"), has_aux=True))(splats)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-5)
    for f in ("pos", "orient", "scale", "opacity", "color", "sh"):
        x = np.asarray(getattr(ga, f))
        y = np.asarray(getattr(gb, f))
        np.testing.assert_allclose(y, x, atol=2e-4 * max(1.0, np.abs(x).max()), err_msg=f)
    # the depth test really kills something
    assert not np.array_equal(np.asarray(a), np.asarray(gt.render(splats, cam, cfg, backend="tiles")))
