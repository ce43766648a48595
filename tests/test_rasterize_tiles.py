"""Tiled-backend equivalence tests (BASELINE.json config 2 structure):
image and gradient parity between the tiled rasterizer and the oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsplat_tpu import RenderConfig, make_camera, make_splats, random_splats, render_reference
from gsplat_tpu.ops.binning import bin_splats, tile_grid
from gsplat_tpu.ops.projection import project_splats
from gsplat_tpu.ops.rasterize_ref import sanitize_projected
from gsplat_tpu.ops.rasterize_tiles import render_tiles, sort_by_depth


CFG = RenderConfig(tile_h=8, tile_w=16, tile_capacity=256)


def scene(n=200, seed=0, w=64, h=48, sh_scale=0.2):
    splats = random_splats(jax.random.PRNGKey(seed), n, extent=0.8, sh_scale=sh_scale)
    cam = make_camera(eye=[0.2, 0.4, 3.0], target=[0, 0, 0], width=w, height=h)
    return splats, cam


class TestBinning:
    def test_pairs_cover_each_tile_in_depth_order(self):
        splats, cam = scene()
        p = sort_by_depth(sanitize_projected(project_splats(splats, cam, 0)))
        binned = bin_splats(p, cam.width, cam.height, CFG)
        pt = np.asarray(binned.pair_tile)
        ps = np.asarray(binned.pair_splat)
        nty, ntx = tile_grid(cam.width, cam.height, CFG.tile_h, CFG.tile_w)
        t = nty * ntx
        # valid pairs form ascending tile segments (sorted order, no gaps)
        assert (np.diff(pt[pt < t]) >= 0).all()
        # segments are disjoint and in tile order, so the compositing
        # kernel's per-tile checkpoint slots (start // chunk + t + c for its
        # ceil(count / chunk) chunks c) never collide and fit the buffer
        from gsplat_tpu.ops.pallas.composite import checkpoint_slots

        starts_ = np.asarray(binned.tile_start)
        counts_ = np.asarray(binned.tile_count)
        assert (starts_[1:] >= starts_[:-1] + counts_[:-1]).all()
        slots = [
            starts_[k] // CFG.chunk + k + c
            for k in range(t)
            for c in range(-(-counts_[k] // CFG.chunk))
        ]
        assert len(set(slots)) == len(slots)
        assert max(slots) < checkpoint_slots(
            binned.pair_splat.shape[0], t, CFG.chunk
        )
        # within a tile, splat rank (== depth order) strictly increases
        for tile in np.unique(pt[pt < t]):
            seg = ps[pt == tile]
            assert (np.diff(seg) > 0).all()
        # starts/counts consistent
        starts = np.asarray(binned.tile_start)
        counts = np.asarray(binned.tile_count)
        for tile in range(t):
            seg = np.nonzero(pt == tile)[0]
            if len(seg):
                assert starts[tile] == seg[0]
                assert counts[tile] == min(len(seg), CFG.tile_capacity)
        assert int(binned.dropped_pairs) == 0

    def test_budget_overflow_reported(self):
        splats, cam = scene(n=100)
        cfg = dataclasses.replace(CFG, pairs_per_splat=0.5)
        p = sort_by_depth(sanitize_projected(project_splats(splats, cam, 0)))
        binned = bin_splats(p, cam.width, cam.height, cfg)
        assert int(binned.dropped_pairs) > 0

    def test_offscreen_and_transparent_culled(self):
        splats = make_splats(
            pos=[[50.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 9.0]],
            scale=[[0.05] * 3] * 3,
            opacity=[0.9, 0.001, 0.9],  # second below 1/255 cutoff
            color=[[1, 1, 1]] * 3,
        )
        cam = make_camera([0, 0, 3], [0, 0, 0], 32, 32)
        p = sort_by_depth(sanitize_projected(project_splats(splats, cam, 0)))
        binned = bin_splats(p, cam.width, cam.height, CFG)
        # offscreen, sub-cutoff, and behind-camera splats generate no pairs
        assert int(jnp.sum(binned.tile_count)) == 0


class TestTiledVsOracle:
    @pytest.mark.parametrize("seed,n,sh", [(0, 200, 0.0), (1, 200, 0.3), (2, 500, 0.1)])
    def test_image_allclose(self, seed, n, sh):
        splats, cam = scene(n=n, seed=seed, sh_scale=sh)
        ref = render_reference(splats, cam, CFG)
        tiled = render_tiles(splats, cam, CFG)
        np.testing.assert_allclose(np.asarray(tiled), np.asarray(ref), atol=2e-5)

    def test_odd_image_size(self):
        # width/height not multiples of the tile size
        splats, cam = scene(n=150, w=53, h=41)
        ref = render_reference(splats, cam, CFG)
        tiled = render_tiles(splats, cam, CFG)
        np.testing.assert_allclose(np.asarray(tiled), np.asarray(ref), atol=2e-5)

    def test_grad_allclose(self):
        splats, cam = scene(n=100, w=32, h=32)
        w = jax.random.normal(jax.random.PRNGKey(5), (32, 32, 4))

        def loss_ref(s):
            return jnp.sum(render_reference(s, cam, CFG) * w)

        def loss_tiled(s):
            return jnp.sum(render_tiles(s, cam, CFG) * w)

        g_ref = jax.grad(loss_ref)(splats)
        g_tiled = jax.grad(loss_tiled)(splats)
        for f in ("pos", "orient", "scale", "opacity", "color", "sh"):
            a = np.asarray(getattr(g_ref, f))
            b = np.asarray(getattr(g_tiled, f))
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-3, err_msg=f)

    def test_jit_compiles_and_matches_eager(self):
        splats, cam = scene(n=64, w=32, h=24)
        jitted = jax.jit(lambda s: render_tiles(s, cam, CFG))
        np.testing.assert_allclose(
            np.asarray(jitted(splats)), np.asarray(render_tiles(splats, cam, CFG)), atol=1e-6
        )
