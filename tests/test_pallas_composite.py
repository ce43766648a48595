"""Compositing-kernel equivalence tests (the Triton-route Pallas kernels
through the Pallas interpreter on the CPU).

Validates the fused forward/backward kernels against the pure-XLA tiled
backend — same binning, same math, so tolerances are float-rounding level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsplat_tpu import RenderConfig, make_camera, random_splats, render_tiles
from gsplat_tpu.render import render_pallas

CFG = RenderConfig(tile_capacity=512, transmittance_eps=0.0)


def scene(n=150, seed=0, w=64, h=64, sh=0.2):
    splats = random_splats(jax.random.PRNGKey(seed), n, extent=0.8, sh_scale=sh)
    cam = make_camera(eye=[0.2, 0.4, 3.0], target=[0, 0, 0], width=w, height=h)
    return splats, cam


class TestForward:
    @pytest.mark.parametrize("seed,n", [(0, 150), (1, 400)])
    def test_matches_tiled(self, seed, n):
        splats, cam = scene(n=n, seed=seed)
        a = np.asarray(render_tiles(splats, cam, CFG))
        b = np.asarray(render_pallas(splats, cam, CFG, interpret=True))
        np.testing.assert_allclose(b, a, atol=1e-6)

    def test_odd_image_size(self):
        splats, cam = scene(n=100, w=70, h=45)
        a = np.asarray(render_tiles(splats, cam, CFG))
        b = np.asarray(render_pallas(splats, cam, CFG, interpret=True))
        np.testing.assert_allclose(b, a, atol=1e-6)

    def test_empty_scene_tiles(self):
        # camera looking away: every tile empty
        splats, _ = scene(n=20)
        cam = make_camera([0, 0, -5], [0, 0, -10], 64, 64)
        img = np.asarray(render_pallas(splats, cam, CFG, interpret=True))
        assert np.abs(img).max() == 0.0

    def test_early_termination_close_to_exact(self):
        # opaque scene: early stop (eps=1e-4) must match exact to ~eps
        splats, cam = scene(n=400, sh=0.0)
        splats = dataclasses.replace(splats, opacity=jnp.full((400,), 0.95))
        exact = np.asarray(render_pallas(splats, cam, CFG, interpret=True))
        fast_cfg = dataclasses.replace(CFG, transmittance_eps=1e-4)
        fast = np.asarray(render_pallas(splats, cam, fast_cfg, interpret=True))
        assert np.abs(fast - exact).max() < 1e-3


class TestBackward:
    def test_grads_match_tiled_autodiff(self):
        splats, cam = scene(n=150)
        w = jax.random.normal(jax.random.PRNGKey(5), (64, 64, 4))
        g1 = jax.grad(lambda s: jnp.sum(render_tiles(s, cam, CFG) * w))(splats)
        g2 = jax.grad(lambda s: jnp.sum(render_pallas(s, cam, CFG, interpret=True) * w))(splats)
        for f in ("pos", "orient", "scale", "opacity", "color", "sh"):
            a = np.asarray(getattr(g1, f))
            b = np.asarray(getattr(g2, f))
            tol = 2e-4 * max(1.0, np.abs(a).max())
            np.testing.assert_allclose(b, a, atol=tol, err_msg=f)

    def test_grads_with_early_termination_finite(self):
        # early stop truncates gradient tails but must stay finite and close
        splats, cam = scene(n=300)
        splats = dataclasses.replace(splats, opacity=jnp.full((300,), 0.9))
        cfg = dataclasses.replace(CFG, transmittance_eps=1e-3)
        g = jax.grad(
            lambda s: jnp.mean(render_pallas(s, cam, cfg, interpret=True)[..., :3])
        )(splats)
        for f in ("pos", "orient", "scale", "opacity", "color", "sh"):
            assert np.isfinite(np.asarray(getattr(g, f))).all(), f

    def test_soft_cutoff_mode(self):
        splats, cam = scene(n=100)
        cfg = dataclasses.replace(CFG, soft_cutoff=True)
        a = np.asarray(render_tiles(splats, cam, cfg))
        b = np.asarray(render_pallas(splats, cam, cfg, interpret=True))
        np.testing.assert_allclose(b, a, atol=1e-6)
        w = jax.random.normal(jax.random.PRNGKey(6), (64, 64, 4))
        g1 = jax.grad(lambda s: jnp.sum(render_tiles(s, cam, cfg) * w))(splats)
        g2 = jax.grad(lambda s: jnp.sum(render_pallas(s, cam, cfg, interpret=True) * w))(splats)
        for f in ("pos", "orient", "scale", "opacity", "color", "sh"):
            a_ = np.asarray(getattr(g1, f))
            b_ = np.asarray(getattr(g2, f))
            tol = 2e-4 * max(1.0, np.abs(a_).max())
            np.testing.assert_allclose(b_, a_, atol=tol, err_msg=f)


class TestPackedPayload:
    """payload_dtype="packed": geometry f32, color+opacity bf16-rounded
    (the production quantization).  Image and gradient parity with the
    tiled backend hold at float-rounding level: both read the same
    quantized payload."""

    PCFG = dataclasses.replace(CFG, payload_dtype="packed")

    def test_image_matches_tiled(self):
        splats, cam = scene(n=400, seed=1)
        a = np.asarray(render_tiles(splats, cam, self.PCFG))
        b = np.asarray(render_pallas(splats, cam, self.PCFG, interpret=True))
        np.testing.assert_allclose(b, a, atol=1e-6)

    def test_round_bf16_matches_convert(self):
        from gsplat_tpu.ops.rasterize_ref import round_bf16

        x = jnp.asarray(
            np.array([1.0000001, 0.1, 3.14159265, -2.7182818, 0.0, 1e-4],
                     np.float32)
        )
        r = np.asarray(jax.jit(round_bf16)(x))
        want = np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32))
        assert np.array_equal(r, want)  # integer RNE == convert RNE

    def test_round_bf16_straight_through_grad(self):
        from gsplat_tpu.ops.rasterize_ref import round_bf16

        g = jax.grad(lambda x: jnp.sum(round_bf16(x) * 3.0))(jnp.ones((4,)))
        np.testing.assert_array_equal(np.asarray(g), 3.0)

    def test_grads_match_tiled(self):
        splats, cam = scene(n=400, seed=1)
        w = jax.random.normal(jax.random.PRNGKey(7), (64, 64, 4))

        def loss(render):
            return lambda s: jnp.sum(render(s) * w)

        gt_ = jax.grad(loss(lambda s: render_tiles(s, cam, self.PCFG)))(splats)
        gp = jax.grad(
            loss(lambda s: render_pallas(s, cam, self.PCFG, interpret=True))
        )(splats)
        for f in ("pos", "orient", "scale", "opacity", "color", "sh"):
            a = np.asarray(getattr(gt_, f))
            b = np.asarray(getattr(gp, f))
            np.testing.assert_allclose(b, a, atol=2e-4 * max(1.0, np.abs(a).max()))


class TestKernelWrapper:
    """The wrapper around the kernels: tile layout, padding, empty tiles."""

    @pytest.mark.parametrize("w,h", [(45, 70), (33, 31)])
    def test_unpack_depth_layout_roundtrip(self, w, h):
        # pack_depth_tiles and unpack_image are inverse layouts for an
        # image that is not a multiple of the 32-px tile: off-image pixels
        # pad with +inf and are cropped away again.
        from gsplat_tpu.ops.binning import tile_grid
        from gsplat_tpu.ops.pallas.composite import (
            NPIX, pack_depth_tiles, unpack_image,
        )

        nty, ntx = tile_grid(w, h, 32, 32)
        d = jax.random.uniform(jax.random.PRNGKey(0), (h, w))
        tiles = pack_depth_tiles(d, nty, ntx)
        assert tiles.shape == (nty * ntx, NPIX)
        assert np.isinf(np.asarray(tiles)).sum() == nty * ntx * NPIX - h * w
        four = jnp.broadcast_to(tiles[:, None, :], (nty * ntx, 4, NPIX))
        back = np.asarray(unpack_image(four, nty, ntx, h, w))
        for c in range(4):
            np.testing.assert_array_equal(back[..., c], np.asarray(d))

    def test_empty_and_occupied_tiles(self):
        # One splat in a corner: most tiles are empty (count 0, nothing
        # walked) and must stay exactly transparent, with exact zero
        # gradients flowing to nothing; the occupied tile matches tiles.
        from gsplat_tpu import make_splats

        splats = make_splats(
            pos=[[-0.9, 0.9, 0.0]], scale=[[0.05] * 3], opacity=[0.8],
            color=[[1.0, 0.5, 0.25]],
        )
        cam = make_camera([0, 0, 3], [0, 0, 0], 96, 70)
        a = np.asarray(render_tiles(splats, cam, CFG))
        b = np.asarray(render_pallas(splats, cam, CFG, interpret=True))
        np.testing.assert_allclose(b, a, atol=1e-6)
        lit = (b[..., 3] > 0)
        assert 0 < lit.sum() < lit.size // 4
        g = jax.grad(
            lambda s: jnp.sum(render_pallas(s, cam, CFG, interpret=True))
        )(splats)
        assert np.isfinite(np.asarray(g.pos)).all()
        assert np.abs(np.asarray(g.opacity)).max() > 0
