"""Tiled rasterizer (pure-XLA backend).

The algorithmic twin of the fused GPU kernels (``ops/pallas/composite.py``)
expressed in plain ``jnp``: project → global depth sort → tile binning →
per-tile front-to-back compositing, differentiable end-to-end via XLA
autodiff.  It is the CPU path (``backend="auto"`` on the CPU) and the
mid-level oracle between the O(N·H·W) reference rasterizer and the fused
kernels.  It scans all ``tile_capacity`` steps for every tile with no early
stop, and its reverse mode keeps every step's residuals, so forward +
backward at 1080p does not fit a GPU's memory.

Pipeline parity contract: identical math to ``rasterize_ref.composite_reference``
(same per-pixel alpha, same global compositing order) — images must match to
fp32 tolerance whenever no pairs were dropped by the binning budget.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.camera import Camera
from ..models.splats import GaussianSplats
from ..utils.config import RenderConfig
from .binning import BinnedPairs, bin_splats, tile_grid, warn_if_dropped
from .covariance import ALPHA_CUTOFF, QUAD_EXTENT
from .permute import permute_cols
from .projection import N_FIELDS, ROW_DEPTH, ProjectedSplats, project_splats
from .rasterize_ref import quantize_payload, sanitize_projected


def sort_by_depth(p: ProjectedSplats, n_rows: int = 14) -> ProjectedSplats:
    """Global ascending-distance sort (``src/GSplatRenderer.C:176-216``);
    invalid splats (depth=inf after sanitize) go last.  The permutation is
    applied via :func:`permute_cols` so the backward pass is an
    inverse-permutation gather, not a scatter-add.  Only the ``n_rows``
    live rows are permuted (14 by default; 15 keeps the view-z row for
    depth-tested compositing; the remainder are structural zeros,
    ``ops/projection.py``)."""
    order = jnp.argsort(p.fields[ROW_DEPTH])
    live = permute_cols(p.fields[:n_rows], order, 10)
    return ProjectedSplats(
        fields=jnp.pad(live, ((0, N_FIELDS - n_rows), (0, 0)))
    )


def depth_order(splats: GaussianSplats, camera: Camera) -> jnp.ndarray:
    """Ascending squared-camera-distance permutation over splats — the
    reference's sort key (``src/GSplatRenderer.C:176-216``).  Exposed so an
    interactive host (SceneRegistry) can cache the order and re-sort only
    when the camera has moved enough, exactly like the reference's amortized
    sort (``:165-174``)."""
    pos = splats.pos
    cam_pos = camera.position
    tx = pos[0] - cam_pos[0]
    ty = pos[1] - cam_pos[1]
    tz = pos[2] - cam_pos[2]
    key = tx * tx + ty * ty + tz * tz
    # behind-camera (clip_w ≤ 0) last, matching sanitize_projected's inf depth
    view = camera.view
    proj = camera.proj
    vx = view[0, 0] * pos[0] + view[0, 1] * pos[1] + view[0, 2] * pos[2] + view[0, 3]
    vy = view[1, 0] * pos[0] + view[1, 1] * pos[1] + view[1, 2] * pos[2] + view[1, 3]
    vz = view[2, 0] * pos[0] + view[2, 1] * pos[1] + view[2, 2] * pos[2] + view[2, 3]
    clip_w = proj[3, 0] * vx + proj[3, 1] * vy + proj[3, 2] * vz + proj[3, 3]
    key = jnp.where(clip_w > 0.0, key, jnp.inf)
    return jnp.argsort(key)


def build_tile_lists(binned: BinnedPairs, num_tiles: int, capacity: int, n: int) -> jnp.ndarray:
    """Dense per-tile splat lists [T, K] (entries = depth-rank index, ``n`` =
    padded benign column).  Entries beyond a tile's capacity are dropped
    (farthest splats, consistent with the binning overflow policy)."""
    pos_in_tile = (
        jnp.arange(binned.pair_budget, dtype=jnp.int32)
        - binned.tile_start[jnp.minimum(binned.pair_tile, num_tiles - 1)]
    )
    lists = jnp.full((num_tiles, capacity), n, dtype=jnp.int32)
    # Out-of-range scatter indices (sentinel tile, pos >= capacity) dropped.
    return lists.at[binned.pair_tile, pos_in_tile].set(
        binned.pair_splat, mode="drop"
    )


def composite_tile_lists(
    tile_lists: jnp.ndarray,
    payload: jnp.ndarray,
    width: int,
    height: int,
    config: RenderConfig,
    row_offset=0,
    col_offset=0,
    bg_depth_tiles: jnp.ndarray = None,
) -> jnp.ndarray:
    """Front-to-back composite of dense tile lists.

    ``bg_depth_tiles``: optional (T, TH, TW) view-space scene depth per
    tile — splat contributions behind it are killed per pixel before
    blending (the reference's z-tested beauty pass,
    ``src/GSplatRenderer.C:595-610``).

    Args:
      tile_lists: (T, K) int32 depth-rank indices, ``n`` sentinel for empty.
      payload: (16, N) field matrix (``ops/projection.py`` row layout; NOT
        padded — a benign zero column is appended here).
      width/height: screen size in pixels.

    Returns:
      (H, W, 4) premultiplied RGBA.
    """
    nty, ntx = tile_grid(width, height, config.tile_h, config.tile_w)
    num_tiles, capacity = tile_lists.shape
    assert num_tiles == nty * ntx
    th, tw = config.tile_h, config.tile_w

    # Benign padded column: opacity 0 → alpha 0 → no contribution.
    pad = jnp.zeros((payload.shape[0], 1), dtype=payload.dtype)
    payload_p = jnp.concatenate([payload, pad], axis=1)

    # Per-tile pixel-center coordinates.  row_offset shifts into global
    # screen rows by exact integer arithmetic (strip rendering stays
    # bit-identical to full-frame).
    tile_ids = jnp.arange(num_tiles, dtype=jnp.int32)
    origin_x = (
        ((tile_ids % ntx) * config.col_stride + jnp.asarray(col_offset, jnp.int32))
        * tw
    ).astype(jnp.float32)
    origin_y = (
        ((tile_ids // ntx) * config.row_stride + jnp.asarray(row_offset, jnp.int32))
        * th
    ).astype(
        jnp.float32
    )
    iota_y = (jnp.arange(th, dtype=jnp.float32) + 0.5)[None, :, None]
    iota_x = (jnp.arange(tw, dtype=jnp.float32) + 0.5)[None, None, :]
    px = origin_x[:, None, None] + iota_x  # (T, 1, TW)
    py = origin_y[:, None, None] + iota_y  # (T, TH, 1)

    def step(carry, ids):
        color, transmittance = carry
        f = payload_p[:, ids]  # (16, T)
        dx = px - f[0][:, None, None]
        dy = py - f[1][:, None, None]
        qx = dx * f[2][:, None, None] + dy * f[3][:, None, None]
        qy = dx * f[4][:, None, None] + dy * f[5][:, None, None]
        power = qx * qx + qy * qy
        alpha = jnp.clip(jnp.exp(-power) * f[9][:, None, None], 0.0, config.max_alpha)
        if not config.soft_cutoff:
            inside = (jnp.abs(qx) <= QUAD_EXTENT) & (jnp.abs(qy) <= QUAD_EXTENT)
            alpha = jnp.where(inside & (alpha >= ALPHA_CUTOFF), alpha, 0.0)
        if bg_depth_tiles is not None:
            alpha = jnp.where(f[14][:, None, None] <= bg_depth_tiles, alpha, 0.0)
        weight = alpha * transmittance  # (T, TH, TW)
        color = color + weight[:, None] * f[6:9, :].T[:, :, None, None]
        transmittance = transmittance * (1.0 - alpha)
        return (color, transmittance), None

    init = (
        jnp.zeros((num_tiles, 3, th, tw), dtype=jnp.float32),
        jnp.ones((num_tiles, th, tw), dtype=jnp.float32),
    )
    (color, transmittance), _ = jax.lax.scan(step, init, tile_lists.T)

    tiles = jnp.concatenate([color, (1.0 - transmittance)[:, None]], axis=1)  # (T,4,TH,TW)
    image = (
        tiles.reshape(nty, ntx, 4, th, tw)
        .transpose(2, 0, 3, 1, 4)
        .reshape(4, nty * th, ntx * tw)
    )
    return image[:, :height, :width].transpose(1, 2, 0)


def pack_depth_tiles(bg_depth, nty, ntx, th, tw):
    """(H, W) scene depth → (T, TH, TW) per-tile blocks, padded with +inf
    (pixels outside the image never kill anything)."""
    h, w = bg_depth.shape
    pad_y, pad_x = nty * th - h, ntx * tw - w
    d = jnp.pad(bg_depth, ((0, pad_y), (0, pad_x)), constant_values=jnp.inf)
    return (
        d.reshape(nty, th, ntx, tw).transpose(0, 2, 1, 3).reshape(-1, th, tw)
    )


def render_tiles(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    order: jnp.ndarray = None,
    with_stats: bool = False,
    bg_depth: jnp.ndarray = None,
) -> jnp.ndarray:
    """End-to-end tiled render.  Returns (H, W, 4) premultiplied RGBA — or
    ``(image, RenderStats)`` with ``with_stats=True``.

    ``bg_depth``: optional (H, W) view-space scene depth (depth-tested
    compositing into a host scene; pair with config.depth_test).

    ``order``: optional precomputed depth permutation (see
    :func:`depth_order`) — the amortized-sort path; recomputed when None.
    """
    from .binning import RenderStats  # local: binning imports config only

    projected = project_splats(
        splats, camera, config.sh_order,
        tight_footprint=not config.soft_cutoff, only_sh=config.only_sh,
    )
    p = quantize_payload(sanitize_projected(projected), config)
    n_rows = 15 if bg_depth is not None else 14
    if order is None:
        p = sort_by_depth(p, n_rows=n_rows)
    else:
        # Same row + pad shape as sort_by_depth.
        p = ProjectedSplats(
            fields=jnp.pad(
                permute_cols(p.fields[:n_rows], order, 10),
                ((0, N_FIELDS - n_rows), (0, 0)),
            )
        )
    binned = bin_splats(p, camera.width, camera.height, config)
    warn_if_dropped(binned, config)
    nty, ntx = tile_grid(camera.width, camera.height, config.tile_h, config.tile_w)
    lists = build_tile_lists(binned, nty * ntx, config.tile_capacity, p.count)
    bgd_t = None
    if bg_depth is not None:
        bgd_t = pack_depth_tiles(
            bg_depth, nty, ntx, config.tile_h, config.tile_w
        )
    image = composite_tile_lists(
        lists, p.fields, camera.width, camera.height, config,
        bg_depth_tiles=bgd_t,
    )
    if with_stats:
        return image, RenderStats(dropped_pairs=binned.dropped_pairs)
    return image
