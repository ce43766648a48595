"""Top-level render entry point.

The analogue of the reference's per-frame driver — the scene hook
calling ``generateRenderGeometry → render → postRender``
(``gsplat_plugin/src/DM_GSplatHook.C:30-39``) — collapsed into one pure
function ``image = render(splats, camera, config)``: project → global depth
sort → tile binning → fused compositing, differentiable end-to-end.

Backends:
  * ``"pallas"``   — fused Pallas compositing kernels for the GPU (Triton
    route; the production path).
  * ``"pallas_interpret"`` — the same kernels through the Pallas
    interpreter (CPU tests).
  * ``"tiles"``    — pure-XLA tiled compositing (any platform; mid oracle).
  * ``"reference"``— O(N·H·W) per-pixel oracle (ground truth).
  * ``"auto"``     — ``pallas`` on a GPU, ``tiles`` on the CPU
    (:func:`gsplat_tpu.utils.platform.resolve_backend`).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from .models.camera import Camera
from .models.splats import GaussianSplats
from .ops.binning import (
    RenderStats,
    bin_splats,
    count_pairs,
    tile_grid,
    warn_if_dropped,
)
from .ops.pallas.composite import composite_splats, pack_depth_tiles, unpack_image
from .ops.permute import permute_cols
from .ops.projection import N_FIELDS, ProjectedSplats, project_splats
from .ops.rasterize_ref import quantize_payload, render_reference, sanitize_projected
from .ops.rasterize_tiles import render_tiles, sort_by_depth
from .utils.config import RenderConfig
from .utils.platform import resolve_backend


def render_pallas(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    interpret: bool = False,
    order: jnp.ndarray = None,
    with_stats: bool = False,
    bg_depth: jnp.ndarray = None,
) -> jnp.ndarray:
    """Fused-kernel render.  Returns (H, W, 4) premultiplied RGBA — or
    ``(image, RenderStats)`` with ``with_stats=True`` (overflow counters as
    jit outputs; see :class:`gsplat_tpu.ops.binning.RenderStats`).

    ``order``: optional precomputed depth permutation (amortized sort).
    """
    if config.tile_h != 32 or config.tile_w != 32:
        raise ValueError("pallas backend requires tile_h == tile_w == 32")
    projected = project_splats(
        splats, camera, config.sh_order,
        tight_footprint=not config.soft_cutoff, only_sh=config.only_sh,
    )
    p = quantize_payload(sanitize_projected(projected), config)
    # Fields are permuted into depth order here, so the binning works in
    # rank space and each tile's payload reads are nearly sorted; with a
    # cached ``order`` (amortized sort) the same permutation is applied.
    n_rows = 15 if config.depth_test else 14
    if order is None:
        p = sort_by_depth(p, n_rows=n_rows)
    else:
        p = ProjectedSplats(
            fields=jnp.pad(
                permute_cols(p.fields[:n_rows], order, 10),
                ((0, N_FIELDS - n_rows), (0, 0)),
            )
        )
    binned = bin_splats(p, camera.width, camera.height, config, with_tiles=False)
    warn_if_dropped(binned, config)
    nty, ntx = tile_grid(camera.width, camera.height, config.tile_h, config.tile_w)
    bgd = pack_depth_tiles(bg_depth, nty, ntx) if config.depth_test else None
    # Fused rasterization tail: payload gather + compositing kernel, one
    # custom VJP whose backward sums the kernel's per-pair gradient rows
    # per splat.
    if config.depth_test:
        # payload row 10 = the view-depth row (field row 14)
        pay_rows = jnp.concatenate([p.fields[:10], p.fields[14:15]], axis=0)
    else:
        pay_rows = p.fields[:10]
    tiles = composite_splats(
        pay_rows,
        binned.pair_splat,
        binned.tile_start,
        binned.tile_count,
        jnp.zeros((2,), jnp.int32),
        bgd,
        ntx,
        config,
        interpret,
    )
    image = unpack_image(tiles, nty, ntx, camera.height, camera.width)
    if with_stats:
        return image, RenderStats(dropped_pairs=binned.dropped_pairs)
    return image


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _count_pairs_jit(splats, camera, width, height, config):
    p = sanitize_projected(
        project_splats(
            splats, camera, config.sh_order,
            tight_footprint=not config.soft_cutoff,
        )
    )
    return count_pairs(p, width, height, config)


def measure_pairs(
    splats: GaussianSplats, camera: Camera, config: RenderConfig = RenderConfig()
) -> int:
    """Exact (tile, splat) pair count this frame would bin (host int)."""
    return int(
        _count_pairs_jit(splats, camera, camera.width, camera.height, config)
    )


def tune_pair_budget(
    splats: GaussianSplats,
    cameras,
    config: RenderConfig = RenderConfig(),
    headroom: float = 1.2,
    bucket: int = 1 << 17,
) -> RenderConfig:
    """Measure the scene's real (tile, splat) pair count and return a config
    whose static pair budget fits it, instead of the worst-case
    ``pairs_per_splat·N`` default.

    Every pair-proportional array (pair ids, pair payload, per-pair
    gradient rows, transmittance checkpoints) and every pass over them is
    sized by the *static* budget, so fitting it cuts peak device memory and
    the pair passes' time proportionally.  One cheap counting pass
    per camera (projection + bbox arithmetic + a scalar reduce; no pair
    arrays), take the max, apply ``headroom``, round up to ``bucket`` so
    nearby cameras / training steps reuse the same jit cache entry.  The
    overflow contract is unchanged: if a later frame exceeds the tuned
    budget, the farthest pairs drop and the cull warning fires
    (``src/GSplatRenderer.C:366-376`` analogue) — raise ``headroom`` then.

    ``cameras``: one Camera or an iterable (e.g. the training set's extremes).
    """
    if isinstance(cameras, Camera):
        cameras = [cameras]
    worst = 0
    for cam in cameras:
        worst = max(worst, measure_pairs(splats, cam, config))
    budget = -(-int(round(worst * headroom)) // bucket) * bucket
    # The measured need wins in BOTH directions: heavy-tailed scenes
    # routinely exceed the pairs_per_splat default (a trained-statistics
    # 1M scene measures ~5.5 pairs/splat at 1080p — clamping to the
    # default's 3·N would silently truncate 2.5M pairs).
    return dataclasses.replace(
        config, pair_budget_override=max(budget, bucket)
    )


def composite_over(image: jnp.ndarray, background_rgba: jnp.ndarray) -> jnp.ndarray:
    """Under-composite a premultiplied splat layer over an opaque-or-not
    background: ``out = splat + (1 − splat_a)·bg`` — exactly what the
    reference's front-to-back GL under-blend produces once the scene is the
    final (farthest) layer (``src/GSplatRenderer.C:615-621``)."""
    a = image[..., 3:4]
    return image + (1.0 - a) * background_rgba


def render(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    backend: str = "auto",
    with_stats: bool = False,
    background_rgba: jnp.ndarray = None,
    background_depth: jnp.ndarray = None,
) -> jnp.ndarray:
    """Render a splat scene.  Returns (H, W, 4) premultiplied RGBA.

    ``with_stats=True`` returns ``(image, RenderStats)`` instead — the
    overflow counters ride out of the jitted render as ordinary outputs, so
    hosts can warn on budget truncation even where host callbacks are
    unsupported (multi-process runs); pass them to
    :func:`gsplat_tpu.ops.binning.report_stats`.

    Compositing into a host scene (the reference's beauty-pass contract —
    splats drawn after all opaque geometry, z-tested against the scene's
    depth buffer but not z-written, ``src/GSplatRenderer.C:595-610``):

    * ``background_depth``: (H, W) view-space scene depth — per pixel,
      splat contributions behind it are killed before blending (enables
      ``config.depth_test``);
    * ``background_rgba``: (H, W, 4) scene color the splat layer is
      under-composited over (works with or without the depth test).
    """
    if background_depth is not None and not config.depth_test:
        import dataclasses as _dc

        config = _dc.replace(config, depth_test=True)
    if config.depth_test and background_depth is None:
        raise ValueError("config.depth_test requires background_depth")
    backend = resolve_backend(backend)
    if backend == "pallas":
        out = render_pallas(
            splats, camera, config, with_stats=with_stats,
            bg_depth=background_depth,
        )
    elif backend == "pallas_interpret":
        out = render_pallas(
            splats, camera, config, interpret=True, with_stats=with_stats,
            bg_depth=background_depth,
        )
    elif backend == "tiles":
        out = render_tiles(
            splats, camera, config, with_stats=with_stats,
            bg_depth=background_depth,
        )
    elif backend == "reference":
        image = render_reference(
            splats, camera, config, bg_depth=background_depth
        )
        if with_stats:
            # the O(N·H·W) oracle composites every splat — nothing can drop
            out = (image, RenderStats(dropped_pairs=jnp.int32(0)))
        else:
            out = image
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if background_rgba is not None:
        if with_stats:
            out = (composite_over(out[0], background_rgba), out[1])
        else:
            out = composite_over(out, background_rgba)
    return out
