"""Config-surface features: only_sh debug mode + dropped-pair warning.

Reference behaviours covered:
  * ``onlySH`` shader debug flag (gsplat_plugin/shaders/GSplatShaderCoreLib.h:117-179)
    — base color replaced by 0.5 grey, SH bands still applied;
  * budget-cull warning (gsplat_plugin/src/GSplatRenderer.C:366-376) — pair
    overflow surfaces a once-per-condition warning instead of silent drop.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gsplat_tpu as gt
from gsplat_tpu.ops.projection import ROW_B, ROW_R, project_splats
from gsplat_tpu.ops.sh import shade_sh
from gsplat_tpu.utils.logging import get_logger


def _scene(n=64, seed=0):
    splats = gt.random_splats(jax.random.PRNGKey(seed), n, extent=0.6, sh_scale=0.2)
    cam = gt.make_camera(eye=[0.1, 0.2, 2.5], target=[0, 0, 0], width=64, height=64)
    return splats, cam


def test_only_sh_matches_shade_sh():
    """project_splats(only_sh=True) == shade_sh with a 0.5-grey base."""
    splats, cam = _scene()
    p = project_splats(splats, cam, sh_order=3, only_sh=True)
    got = p.fields[ROW_R : ROW_B + 1].T  # (N, 3)

    d = splats.pos - cam.position[:, None]
    d = d / jnp.linalg.norm(d, axis=0, keepdims=True)
    sh = splats.sh.T.reshape(-1, 15, 3)
    want = shade_sh(
        jnp.full((splats.count, 3), 0.5), sh, d.T, sh_order=3, only_sh=True
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_only_sh_changes_render():
    splats, cam = _scene()
    img = gt.render(splats, cam, gt.RenderConfig(), backend="tiles")
    img_dbg = gt.render(splats, cam, gt.RenderConfig(only_sh=True), backend="tiles")
    # alpha identical (geometry untouched), color differs
    np.testing.assert_allclose(
        np.asarray(img[..., 3]), np.asarray(img_dbg[..., 3]), atol=1e-6
    )
    assert not np.allclose(np.asarray(img[..., :3]), np.asarray(img_dbg[..., :3]))


def test_only_sh_order0_is_grey():
    splats, cam = _scene()
    p = project_splats(splats, cam, sh_order=0, only_sh=True)
    np.testing.assert_allclose(
        np.asarray(p.fields[ROW_R : ROW_B + 1]), 0.5, atol=1e-7
    )


class TestPayloadDtype:
    """payload_dtype='bfloat16' — the reference's reduced-precision storage
    policy (pos fp32, color/scale/orient/SH fp16; include/GR_GSplat.h:120-127)
    as a uniform payload-rounding config."""

    def test_backends_agree_under_bf16(self):
        """All backends apply the same quantization → tiles ≡ pallas-interpret
        stays (near-)bit-exact under bf16, and both match the oracle."""
        splats, cam = _scene(n=128, seed=2)
        cfg = gt.RenderConfig(payload_dtype="bfloat16")
        t = np.asarray(gt.render(splats, cam, cfg, backend="tiles"))
        p = np.asarray(gt.render(splats, cam, cfg, backend="pallas_interpret"))
        r = np.asarray(gt.render(splats, cam, cfg, backend="reference"))
        assert np.abs(t - p).max() < 1e-5
        assert np.abs(t - r).max() < 1e-5

    def test_quality_close_to_fp32(self):
        """Quantizing the payload moves the image by less than ~1% (bf16 has
        8 mantissa bits; the discontinuous cutoff can flip a few edge
        pixels, so the gate is on the 99.9th percentile, not the max)."""
        splats, cam = _scene(n=256, seed=3)
        a = np.asarray(gt.render(splats, cam, gt.RenderConfig(), backend="tiles"))
        b = np.asarray(
            gt.render(
                splats, cam, gt.RenderConfig(payload_dtype="bfloat16"),
                backend="tiles",
            )
        )
        diff = np.abs(a - b)
        # bf16 keeps 8 mantissa bits: payload rounding shifts Gaussian edges
        # by up to ~0.4% of the quad basis, measured q999 ≈ 0.04 intensity.
        assert np.quantile(diff, 0.999) < 0.06
        assert diff.mean() < 5e-3
        assert not np.array_equal(a, b)  # the knob actually does something

    def test_grads_close_to_fp32(self):
        """Training-mode check: gradients under the bf16 payload stay within
        a few percent of fp32 gradients (soft_cutoff avoids the hard-mask
        kinks, where an ULP of payload rounding legitimately flips masks)."""
        splats, cam = _scene(n=96, seed=4)
        w = jax.random.normal(jax.random.PRNGKey(9), (64, 64, 4))

        def loss(s, cfg):
            return jnp.sum(gt.render(s, cam, cfg, backend="tiles") * w)

        cfg32 = gt.RenderConfig(soft_cutoff=True)
        cfg16 = gt.RenderConfig(soft_cutoff=True, payload_dtype="bfloat16")
        g32 = jax.grad(lambda s: loss(s, cfg32))(splats)
        g16 = jax.grad(lambda s: loss(s, cfg16))(splats)
        # bf16 payload rounding perturbs the primal by ~2^-9 relative, which
        # the quadratic falloff amplifies; measured ≤6% on this scene.
        for name in ["pos", "orient", "scale", "opacity", "color", "sh"]:
            a = np.asarray(getattr(g32, name)).ravel()
            b = np.asarray(getattr(g16, name)).ravel()
            scale = np.abs(a).max() + 1e-12
            assert np.abs(a - b).max() / scale < 0.10, name

    def test_sharded_matches_single_under_bf16(self):
        """The per-shard rounding commutes with the gather: sharded output is
        bit-identical to single-device output under bf16."""
        from gsplat_tpu.parallel.mesh import splat_mesh
        from gsplat_tpu.parallel.render_sharded import (
            pad_splats,
            render_sharded,
            shard_splats,
        )

        n_dev = len(jax.devices())
        if n_dev < 2:
            pytest.skip("needs multiple devices")
        mesh = splat_mesh(n_dev)
        splats, cam = _scene(n=16 * n_dev, seed=5)
        cfg = gt.RenderConfig(
            payload_dtype="bfloat16", tile_capacity=256, transmittance_eps=0.0
        )
        multi = np.asarray(
            render_sharded(shard_splats(splats, mesh), cam, cfg, mesh, backend="tiles")
        )
        single = np.asarray(
            gt.render(pad_splats(splats, n_dev), cam, cfg, backend="tiles")
        )
        np.testing.assert_array_equal(multi, single)

    def test_invalid_dtype_rejected(self):
        with pytest.raises(ValueError):
            gt.RenderConfig(payload_dtype="float16")


class TestSATCull:
    def test_cull_is_image_and_grad_exact(self, monkeypatch):
        """The separating-axis pair cull (incl. the opacity-aware ρ
        tightening) removes only pairs whose tile holds no pixel the kernel
        would keep: the image must match a render with the cull
        force-disabled BIT-FOR-BIT (tiles backend shares bin_splats with the
        Pallas path, so this pins both).  Gradients match to accumulation
        -order noise ONLY: removing a zero pair shifts other pairs' scan
        steps, which reorders a splat's per-pair gradient additions — float
        addition is non-associative, so last-ulp churn is expected from ANY
        binning change (verified: the observed diffs are ≤ 5e-7 on O(1)
        gradients, exactly ulp scale).  Low opacities down to just above
        1/255 make the ρ < QUAD_EXTENT branch really engage."""
        import dataclasses as dc

        from gsplat_tpu.ops import binning

        splats, cam = _scene(n=400, seed=11)
        splats = dc.replace(
            splats,
            opacity=jax.random.uniform(
                jax.random.PRNGKey(42), (splats.count,),
                minval=0.004, maxval=1.0,
            ),
        )
        # Roomy budget/capacity: truncation picks DIFFERENT far pairs with
        # vs without the cull, which would confound the exactness claim.
        cfg = gt.RenderConfig(pairs_per_splat=64.0)
        w = jax.random.normal(jax.random.PRNGKey(9), (cam.height, cam.width, 3))

        def render_sum(s):
            img, stats = gt.render(s, cam, cfg, backend="tiles", with_stats=True)
            return jnp.sum(img[..., :3] * w), (img, stats.dropped_pairs)

        (_, (img, drop)), g = jax.value_and_grad(render_sum, has_aux=True)(splats)

        monkeypatch.setattr(binning, "_SAT_CULL_ENABLED", False)
        (_, (img0, drop0)), g0 = jax.value_and_grad(render_sum, has_aux=True)(splats)

        assert int(drop) == 0 and int(drop0) == 0
        np.testing.assert_array_equal(np.asarray(img), np.asarray(img0))
        for a, b in zip(
            jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(g0)
        ):
            a, b = np.asarray(a), np.asarray(b)
            tol = 1e-5 * max(1.0, float(np.abs(a).max()))
            np.testing.assert_allclose(b, a, rtol=0, atol=tol)

        # and the cull really culls something on this scene
        from gsplat_tpu.ops.projection import project_splats
        from gsplat_tpu.ops.rasterize_ref import sanitize_projected
        from gsplat_tpu.ops.rasterize_tiles import sort_by_depth

        p = sort_by_depth(
            sanitize_projected(
                project_splats(splats, cam, cfg.sh_order, tight_footprint=True)
            )
        )
        monkeypatch.setattr(binning, "_SAT_CULL_ENABLED", True)
        b_cull = binning.bin_splats(p, cam.width, cam.height, cfg)
        monkeypatch.setattr(binning, "_SAT_CULL_ENABLED", False)
        b_aabb = binning.bin_splats(p, cam.width, cam.height, cfg)
        assert int(np.asarray(b_cull.tile_count).sum()) < int(
            np.asarray(b_aabb.tile_count).sum()
        )

        # oracle cross-check: the culled image still matches the O(N·H·W)
        # per-pixel reference
        ref = gt.render(splats, cam, cfg, backend="reference")
        np.testing.assert_allclose(
            np.asarray(img), np.asarray(ref), rtol=0, atol=2e-6
        )


class TestBudgetTuning:
    def test_measure_pairs_matches_binning(self):
        """The counting pass sizes the AABB expansion exactly: with the SAT
        coverage cull disabled (wireframe config reuses pure-AABB binning)
        the binned pair count matches the measurement bit-for-bit; with the
        cull active the binned count can only shrink (culled pairs are exact
        zero contributors), never exceed the measured budget."""
        import dataclasses

        from gsplat_tpu.ops.binning import bin_splats
        from gsplat_tpu.ops.projection import project_splats
        from gsplat_tpu.ops.rasterize_ref import sanitize_projected
        from gsplat_tpu.ops.rasterize_tiles import sort_by_depth

        splats, cam = _scene(n=300, seed=6)
        cfg = gt.RenderConfig()
        n = gt.measure_pairs(splats, cam, cfg)
        p = sort_by_depth(
            sanitize_projected(
                project_splats(splats, cam, cfg.sh_order, tight_footprint=True)
            )
        )
        cfg_aabb = dataclasses.replace(cfg, wireframe=True)
        b_aabb = bin_splats(p, cam.width, cam.height, cfg_aabb)
        assert n == int(np.asarray(b_aabb.tile_count).sum()) + int(
            np.asarray(b_aabb.dropped_pairs)
        )
        b = bin_splats(p, cam.width, cam.height, cfg)
        binned = int(np.asarray(b.tile_count).sum()) + int(
            np.asarray(b.dropped_pairs)
        )
        assert binned <= n
        # the SAT cull must fire on at least one rotated-quad corner pair in
        # this scene, or it is dead code
        assert binned < n

    def test_tuned_budget_render_identical(self):
        """A tuned budget that covers the scene renders bit-identically and
        sets a smaller pair array than the pairs_per_splat default."""
        splats, cam = _scene(n=4096, seed=7)
        cfg = gt.RenderConfig(pairs_per_splat=64.0)  # wasteful default
        tuned = gt.tune_pair_budget(splats, cam, cfg, bucket=1024)
        assert 0 < tuned.pair_budget_override < cfg.pair_budget(splats.count)
        a = np.asarray(gt.render(splats, cam, cfg, backend="tiles"))
        b = np.asarray(gt.render(splats, cam, tuned, backend="tiles"))
        np.testing.assert_array_equal(a, b)

    def test_multiple_cameras_take_worst(self):
        splats, cam = _scene(n=512, seed=8)
        far = gt.make_camera(eye=[0.1, 0.2, 8.0], target=[0, 0, 0],
                             width=64, height=64)
        both = gt.tune_pair_budget(splats, [cam, far], bucket=256)
        one = gt.tune_pair_budget(splats, far, bucket=256)
        assert both.pair_budget_override >= one.pair_budget_override


def test_dropped_pairs_warns(caplog):
    """Overflowing the pair budget fires the cull warning (once), and the
    key re-arms when a later render has no overflow."""
    log = get_logger("binning")
    log.reset_once("dropped_pairs")
    splats, cam = _scene(n=256)
    # huge splats + tiny budget -> guaranteed overflow
    big = gt.GaussianSplats(
        pos=splats.pos,
        orient=splats.orient,
        scale=jnp.full_like(splats.scale, 0.5),
        opacity=jnp.ones_like(splats.opacity),
        color=splats.color,
        sh=splats.sh,
    )
    cfg = gt.RenderConfig(pairs_per_splat=0.1)
    with caplog.at_level(logging.WARNING, logger="gsplat_tpu.binning"):
        img = gt.render(big, cam, cfg, backend="tiles")
        jax.block_until_ready(img)
        jax.effects_barrier()
    assert any("dropped" in r.message for r in caplog.records)

    # once-per-condition: a second overflowing render does not re-log
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="gsplat_tpu.binning"):
        img = gt.render(big, cam, cfg, backend="tiles")
        jax.block_until_ready(img)
        jax.effects_barrier()
    assert not any("dropped" in r.message for r in caplog.records)

    # clearing the condition re-arms the key (small splats, ample budget)
    with caplog.at_level(logging.WARNING, logger="gsplat_tpu.binning"):
        img = gt.render(splats, cam, gt.RenderConfig(pairs_per_splat=8.0), backend="tiles")
        jax.block_until_ready(img)
        jax.effects_barrier()
        img = gt.render(big, cam, cfg, backend="tiles")
        jax.block_until_ready(img)
        jax.effects_barrier()
    assert any("dropped" in r.message for r in caplog.records)


def test_warn_on_drop_false_is_silent(caplog):
    log = get_logger("binning")
    log.reset_once("dropped_pairs")
    splats, cam = _scene(n=256)
    cfg = gt.RenderConfig(pairs_per_splat=0.1, warn_on_drop=False)
    with caplog.at_level(logging.WARNING, logger="gsplat_tpu.binning"):
        img = gt.render(splats, cam, cfg, backend="tiles")
        jax.block_until_ready(img)
        jax.effects_barrier()
    assert not any("dropped" in r.message for r in caplog.records)


def test_stats_warn_without_callbacks(caplog, monkeypatch):
    """The callback-free overflow transport: where host callbacks are
    skipped (multi-process runs), the drop counters ride out of the jitted
    render as ordinary outputs (``with_stats``) and ``report_stats`` warns
    host-side — once per condition, with re-arm."""
    from gsplat_tpu.ops import binning
    from gsplat_tpu.utils.logging import get_logger

    # as in a multi-process run: host callbacks skipped
    monkeypatch.setattr(binning, "_host_callbacks_ok", lambda: False)
    get_logger("binning").reset_once("dropped_pairs")

    splats, cam = _scene(n=256)
    big = gt.GaussianSplats(
        pos=splats.pos,
        orient=splats.orient,
        scale=jnp.full_like(splats.scale, 0.5),
        opacity=jnp.ones_like(splats.opacity),
        color=splats.color,
        sh=splats.sh,
    )
    cfg = gt.RenderConfig(pairs_per_splat=0.1)
    with caplog.at_level(logging.WARNING, logger="gsplat_tpu.binning"):
        img, stats = gt.render(big, cam, cfg, backend="tiles", with_stats=True)
        jax.block_until_ready(img)
    # the async-callback path was disabled: nothing logged yet
    assert not any("dropped" in r.message for r in caplog.records)
    assert int(stats.dropped_pairs) > 0
    assert stats.any_dropped_host()

    with caplog.at_level(logging.WARNING, logger="gsplat_tpu.binning"):
        gt.report_stats(stats, cfg)
    assert any("dropped" in r.message for r in caplog.records)

    # once-per-condition + re-arm on a clean frame
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="gsplat_tpu.binning"):
        gt.report_stats(stats, cfg)
    assert not any("dropped" in r.message for r in caplog.records)
    _, clean = gt.render(
        splats, cam, gt.RenderConfig(pairs_per_splat=8.0),
        backend="tiles", with_stats=True,
    )
    gt.report_stats(clean, cfg)  # zero drops -> re-arms
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="gsplat_tpu.binning"):
        gt.report_stats(stats, cfg)
    assert any("dropped" in r.message for r in caplog.records)


def test_scene_registry_reports_previous_frame_stats(caplog, monkeypatch):
    """SceneRegistry carries the overflow counters as jit outputs and
    reports them host-side at the start of the NEXT frame (no per-frame
    device sync) — with the callback path disabled, as in a multi-process
    run."""
    from gsplat_tpu.ops import binning
    from gsplat_tpu.utils.logging import get_logger

    monkeypatch.setattr(binning, "_host_callbacks_ok", lambda: False)
    get_logger("binning").reset_once("dropped_pairs")
    splats, cam = _scene(n=256)
    big = gt.GaussianSplats(
        pos=splats.pos,
        orient=splats.orient,
        scale=jnp.full_like(splats.scale, 0.5),
        opacity=jnp.ones_like(splats.opacity),
        color=splats.color,
        sh=splats.sh,
    )
    reg = gt.SceneRegistry(gt.RenderConfig(pairs_per_splat=0.1))
    rid = reg.register_update("sop", big)
    reg.include_in_render_pass(rid)
    with caplog.at_level(logging.WARNING, logger="gsplat_tpu.binning"):
        reg.render(cam, backend="tiles")  # frame 1: stats captured
        assert reg._last_stats is not None
        reg.post_render()
        reg.include_in_render_pass(rid)
        reg.render(cam, backend="tiles")  # frame 2: frame 1's stats reported
    assert any("dropped" in r.message for r in caplog.records)


@pytest.mark.parametrize(
    "kw,ok",
    [
        (dict(chunk=8), True),
        (dict(chunk=12), False),                        # not a power of two
        (dict(chunk=64, tile_capacity=96), False),      # does not divide capacity
    ],
)
def test_chunk_validation(kw, ok):
    """The compositing kernel's pair chunk: a power of two that divides
    ``tile_capacity``."""
    if ok:
        assert gt.RenderConfig(**kw).chunk == kw["chunk"]
    else:
        with pytest.raises(ValueError):
            gt.RenderConfig(**kw)
