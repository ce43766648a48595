"""Tile binning: (tile, splat) pair expansion with static shapes.

The reference draws every splat as a screen-space instanced quad and lets the
GL rasterizer find covered pixels (``gsplat_plugin/src/GSplatRenderer.C:647``).
Here coverage is computed explicitly: the screen is cut into tiles and each
splat is expanded into one (tile, splat) pair per overlapped tile — the standard tile-binning of 3DGS, built here entirely from
static-shape XLA primitives:

  1. per-splat tile-bbox from the precomputed quad footprint half-extents
     (``ops/projection.py`` rows 12-13; corners are center ± 2·(±v1 ± v2));
  2. pair offsets by exclusive cumsum; pair→splat lookup by a scatter-max
     and ``cummax`` over a fixed pair budget (ragged→static);
  3. one stable sort by tile id — splats are already in global depth order,
     so stability alone yields per-tile front-to-back order identical to the
     reference's single global sort (``src/GSplatRenderer.C:176-216``);
  4. **no re-layout**: the sorted pair order IS the final layout.  Each
     tile's segment is ``[tile_start, tile_start + tile_count)``; the
     compositing kernel reads it at any alignment, so no pair is moved
     after the sort.

Overflow policy mirrors the reference's budget cull (2^23 splats, excess
culled with a warning — ``src/GSplatRenderer.C:366-376``): pairs beyond the
budget and per-tile entries beyond ``tile_capacity`` drop the *farthest*
splats; the dropped count is reported so callers can warn.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils.config import RenderConfig
from ..utils.logging import format_count, get_logger
from .covariance import ALPHA_CUTOFF, QUAD_EXTENT
from .projection import (
    ROW_CX,
    ROW_CY,
    ROW_HX,
    ROW_HY,
    ROW_OP,
    ROW_VALID,
    ProjectedSplats,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BinnedPairs:
    """Static-shape binning result (pairs stay in tile-sorted order).

    ``pair_splat[k]``: payload-column index of the k-th pair — a *storage*
    index when ``bin_splats`` was given ``order``, a depth-rank index
    otherwise (fields pre-sorted); pairs are grouped by tile (ascending tile
    id) and front-to-back within each tile.  Invalid/padding pairs hold
    *spread* in-range dummy indices (their payload is never read unmasked; a
    shared sentinel column would serialize the payload gather — see
    ``bin_splats``).  Use ``pair_tile == num_tiles`` to identify them, not
    ``pair_splat``.

    Per-tile segment descriptors (both ``(T,) int32``):
      * ``tile_start`` — first pair of the tile's segment;
      * ``tile_count`` — segment length, capped at ``tile_capacity``.
    """

    pair_splat: jax.Array    # (P_pad,) int32 — tile-sorted order
    pair_tile: jax.Array     # (P_pad,) int32 (num_tiles = sentinel); None unless with_tiles
    tile_start: jax.Array    # (T,) int32 — segment starts
    tile_count: jax.Array    # (T,) int32 — capped per-tile count
    dropped_pairs: jax.Array  # () int32 — budget + capacity overflow

    @property
    def pair_budget(self) -> int:
        return self.pair_splat.shape[0]


_log = get_logger("binning")

# Test hook: the SAT cull claims image- AND gradient-exactness, so the test
# suite renders with it force-disabled and asserts bit-equality
# (tests/test_config_features.py).  Never disable it in production — it only
# removes exact-zero pairs.
_SAT_CULL_ENABLED = True

def _warn_dropped_cb(dropped) -> None:
    d = int(dropped)
    if d > 0:
        _log.warning_once(
            f"pair budget/tile capacity exceeded — dropped {format_count(d)} "
            "farthest (tile, splat) pairs; raise RenderConfig.pairs_per_splat "
            "or tile_capacity",
            key="dropped_pairs",
        )
    else:
        _log.reset_once("dropped_pairs")


def _host_callbacks_ok() -> bool:
    """Whether a jitted render may emit the async overflow-warning host
    callback: not in multi-process runs, where no process can address the
    whole counter."""
    return jax.process_count() == 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RenderStats:
    """Overflow counters carried OUT of a jitted render as ordinary array
    outputs — the transport that works where host callbacks don't
    (multi-process runs can't address the value) and that needs no device
    sync per frame.  Hosts with control flow (SceneRegistry, bench,
    training loops) read them back and warn via :func:`report_stats`; the
    async-callback path (:func:`warn_if_dropped`) covers bare ``render``
    calls.

    * ``dropped_pairs`` — (tile, splat) pairs truncated by the pair budget
      or a tile's capacity (farthest-first; the analogue of the reference's
      budget cull, ``src/GSplatRenderer.C:366-376``).
    * ``exchange_dropped`` — splat columns dropped by strip-exchange bucket
      overflow (storage-order, arbitrary depth — treat nonzero as
      misconfiguration and raise ``strip_exchange_factor``).
    """

    dropped_pairs: jax.Array                    # () int32
    exchange_dropped: jax.Array = None          # () int32 or None

    def any_dropped_host(self) -> bool:
        """Host-side: True if any counter is nonzero (blocks on the value)."""
        d = int(self.dropped_pairs)
        e = int(self.exchange_dropped) if self.exchange_dropped is not None else 0
        return d > 0 or e > 0


def report_stats(stats: "RenderStats", config: RenderConfig = None) -> None:
    """Host-side overflow reporting: warn once per condition while it holds,
    re-arm when it clears (the reference's one-time-logger contract,
    ``src/GSplatLogger.C:102-138``).  Call AFTER the jitted render returned;
    reads the counters to the host."""
    if config is not None and not config.warn_on_drop:
        return
    _warn_dropped_cb(stats.dropped_pairs)
    if stats.exchange_dropped is not None:
        from ..parallel.render_sharded import _warn_exchange_dropped_cb

        _warn_exchange_dropped_cb(stats.exchange_dropped)


def warn_if_dropped(binned: "BinnedPairs", config: RenderConfig) -> None:
    """Surface ``dropped_pairs`` from inside a jitted render via an async
    host callback — the analogue of the reference's budget-cull warning
    (``src/GSplatRenderer.C:366-376``), once-per-condition with re-arm when
    the overflow clears.  No-op when ``config.warn_on_drop`` is False or
    the value is not fully addressable (multi-process runs: each process
    only holds its shard)."""
    if not config.warn_on_drop or not _host_callbacks_ok():
        return
    jax.debug.callback(_warn_dropped_cb, binned.dropped_pairs)


def tile_grid(width: int, height: int, tile_h: int, tile_w: int) -> Tuple[int, int]:
    """Number of tiles (rows, cols) covering the screen."""
    return -(-height // tile_h), -(-width // tile_w)


def pair_pad_size(budget: int, chunk: int) -> int:
    """Static padded pair-array length: the compositing kernel walks whole
    chunks, so the last tile's final chunk may read past ``budget``
    (``start + ceil(count/chunk)·chunk < budget + chunk``)."""
    return -(-budget // chunk) * chunk + chunk


def _axis_tiles(p_lo, p_hi, tile_px, off, stride, nt):
    """Pixel range → local tile range on one axis under the strided mapping
    (global tile g = off + ℓ·stride).  Returns (ℓ0, ℓ1, empty): clipped
    local bounds plus the empty-range cull flag.  Exact integer arithmetic:
    ℓ0 = ⌈(g0−off)/stride⌉, ℓ1 = ⌊(g1−off)/stride⌋ via correctly-rounded f32
    division of small ints (same argument as the r // nx division below)."""
    g0 = jnp.floor(p_lo / tile_px).astype(jnp.int32) - off
    g1 = jnp.floor(p_hi / tile_px).astype(jnp.int32) - off
    if stride == 1:
        l0, l1 = g0, g1
    else:
        inv = 1.0 / float(stride)
        l0 = jnp.floor((g0 + (stride - 1)).astype(jnp.float32) * inv).astype(jnp.int32)
        l1 = jnp.floor(g1.astype(jnp.float32) * inv).astype(jnp.int32)
    empty = (l1 < l0) | (l1 < 0) | (l0 > nt - 1)
    return jnp.clip(l0, 0, nt - 1), jnp.clip(l1, 0, nt - 1), empty


def _tile_extents(f, width: int, height: int, config: RenderConfig, row_offset,
                  col_offset):
    """Per-splat tile-coverage counts + bbox operands (shared by binning and
    the budget-tuning count pass so both cull/extent rules stay identical).

    Local tile (ℓy, ℓx) covers GLOBAL tile
    (``row_offset + ℓy·row_stride``, ``col_offset + ℓx·col_stride``)
    (strides from the config; (1, 1) = contiguous strip / full frame, the
    cyclic sharded renderer interleaves on both axes).  An empty local range
    on either axis culls the splat on this device."""
    nty, ntx = tile_grid(width, height, config.tile_h, config.tile_w)

    x_lo = f[ROW_CX] - f[ROW_HX]
    x_hi = f[ROW_CX] + f[ROW_HX]
    y_lo = f[ROW_CY] - f[ROW_HY]
    y_hi = f[ROW_CY] + f[ROW_HY]

    # Cull: behind camera or opacity below the discard threshold (the
    # fragment shader would discard every covered pixel); off-device
    # coverage culls through the empty-range flags below.
    cull = (f[ROW_VALID] < 0.5) | (f[ROW_OP] < ALPHA_CUTOFF)

    tw = float(config.tile_w)
    th = float(config.tile_h)
    tx0, tx1, ex = _axis_tiles(x_lo, x_hi, tw, col_offset, config.col_stride, ntx)
    ty0, ty1, ey = _axis_tiles(y_lo, y_hi, th, row_offset, config.row_stride, nty)
    cull = cull | ex | ey
    nx = jnp.where(cull, 0, tx1 - tx0 + 1)
    ny = jnp.where(cull, 0, ty1 - ty0 + 1)
    counts = nx * ny
    return counts, nx, tx0, ty0


def count_pairs(
    sorted_projected: ProjectedSplats,
    width: int,
    height: int,
    config: RenderConfig,
    row_offset=0,
    col_offset=0,
) -> jax.Array:
    """Exact (tile, splat) pair count for one frame — the cheap counting pass
    behind ``tune_pair_budget`` (projection + bbox math + one reduction; no
    expansion, sort, or pair arrays)."""
    row_offset = jnp.asarray(row_offset, dtype=jnp.int32)
    col_offset = jnp.asarray(col_offset, dtype=jnp.int32)
    counts, _, _, _ = _tile_extents(
        sorted_projected.fields, width, height, config, row_offset, col_offset
    )
    return jnp.sum(counts)


def bin_splats(
    sorted_projected: ProjectedSplats,
    width: int,
    height: int,
    config: RenderConfig,
    row_offset=0,
    with_tiles: bool = True,
    order: jax.Array = None,
    budget: int = None,
    col_offset=0,
) -> BinnedPairs:
    """Bin sanitized projected splats into tiles.

    Depth ordering comes in one of two forms:
      * ``order=None`` — the splats MUST already be in ascending
        camera-distance order (the compositing order contract);
      * ``order`` = the depth permutation (``argsort(fields[ROW_DEPTH])``)
        — the fields stay in **storage order** and only the small per-splat
        binning operands are reordered through ``order`` (1-row gathers).
        This is the production path: it avoids permuting the whole (16, N)
        field matrix (and un-permuting its cotangent) every frame, and
        ``pair_splat`` then holds *storage* indices so the payload gather
        reads the unsorted fields directly.  The pair sequence (and thus
        every image bit) is identical either way.

    ``row_offset`` (int, may be traced): index of the first tile *row* of
    this screen region, in tiles — used by the sharded renderer to bin a
    horizontal strip [row_offset·tile_h, row_offset·tile_h + height) without
    shifting splat coordinates (tile indices are offset by exact integer
    arithmetic, so strip binning is bit-identical to the full-frame bin).

    ``budget`` (static int): overrides ``config.pair_budget(n)`` — the
    sharded renderer passes a per-strip budget that scales ~1/d so every
    pair-proportional array (and its gathers/sorts) shrinks with the device
    count.  Counts are strip-local (splats outside the strip are culled
    above), so truncation semantics are unchanged: farthest pairs drop
    first, reported in ``dropped_pairs``.
    """
    f = sorted_projected.fields
    n = sorted_projected.count
    nty, ntx = tile_grid(width, height, config.tile_h, config.tile_w)
    num_tiles = nty * ntx
    if budget is None:
        budget = config.pair_budget(n)
    row_offset = jnp.asarray(row_offset, dtype=jnp.int32)
    col_offset = jnp.asarray(col_offset, dtype=jnp.int32)
    counts, nx, tx0, ty0 = _tile_extents(
        f, width, height, config, row_offset, col_offset
    )

    # Depth (rank) order: with ``order`` the fields stay in storage order and
    # only the per-splat expansion operands are reordered through it — 1-row
    # gathers over N, instead of permuting the whole (16, N) field matrix
    # (and un-permuting its 10-row cotangent) every frame.
    if order is not None:
        counts_d = counts[order]
    else:
        counts_d = counts

    # Ragged → static: pair k belongs to the (depth-ranked) splat whose
    # inclusive-cumsum first exceeds k.  Ranks ascend with distance, so
    # truncation at the budget drops only the farthest splats' pairs.
    #
    # Computed via scatter-max of (rank+1) at each rank's offset followed
    # by a cummax — two linear passes instead of a binary search per pair.
    # Zero-count ranks share their offset with the next non-empty rank,
    # whose larger id wins the max, so the mapping lands on the owning
    # splat.
    cum = jnp.cumsum(counts_d)
    total = jnp.minimum(cum[-1] if n > 0 else jnp.int32(0), budget)
    offsets = cum - counts_d
    pair_idx = jnp.arange(budget, dtype=jnp.int32)
    splat_ids = jnp.arange(n, dtype=jnp.int32)
    marks = jnp.zeros((budget,), jnp.int32).at[offsets].max(
        splat_ids + 1, mode="drop"
    )
    s_safe = jnp.minimum(jax.lax.cummax(marks) - 1, n - 1)
    s_safe = jnp.maximum(s_safe, 0)
    # The per-splat expansion operands are fetched with ONE multi-row
    # gather, and the two small operands (first tile id, bbox width) are
    # bit-packed into one row when they fit int32 — 2 gathered rows instead
    # of 3.
    nx1 = jnp.maximum(nx, 1)
    tile0 = ty0 * ntx + tx0
    bits_nx = ntx.bit_length()
    packed_ok = (num_tiles << bits_nx) < 2**31
    # Exact-coverage pair cull (hard-cutoff beauty pass only): the AABB
    # expansion overcounts tiles at a *rotated* quad's corners.  A
    # separating-axis test of the tile's pixel-center rect against the
    # ±QUAD_EXTENT parallelogram (the kernel's ``inside`` mask support)
    # culls pairs that cannot contain a nonzero pixel — image- and
    # gradient-exact, so pallas/tiles/oracle parity is unaffected, and both
    # compositors walk proportionally shorter tile segments.  The pair's
    # quad-basis operands ride the SAME expansion gather (bitcast f32 rows).
    # Skipped in wireframe mode (the band extends past the quad) and soft
    # mode (no inside mask).
    sat_cull = (
        _SAT_CULL_ENABLED
        and (not config.soft_cutoff)
        and (not config.wireframe)
    )
    bits_tile = max(num_tiles.bit_length(), 1)
    # Opacity-aware SAT threshold: the kernel also discards α < 1/255, so a
    # splat's support is bounded by the quad AND the disc power ≤ ln(255·op)
    # — per-axis |q| ≤ min(QUAD_EXTENT, ρ), ρ = √ln(255·op).  ρ rides in the
    # spare high bits of the packed tnx row, CEIL-quantized to 8 bits so the
    # dequantized threshold can only be looser (the cull stays exact).
    rho_ok = packed_ok and ((num_tiles << (bits_nx + 8)) < 2**31) and sat_cull
    if sat_cull:
        fq = f[0:6]  # cx, cy, ax, ay, bx, by — same order as counts
        if order is not None:
            fq = fq[:, order]
        qrows = list(jax.lax.bitcast_convert_type(fq, jnp.int32))
    else:
        qrows = []
    if packed_ok:
        tnx = (tile0 << bits_nx) | nx1
        if rho_ok:
            # ρ in storage order (same space as tile0/nx1); the [order]
            # reorder below then carries all three operands in one row.
            # Low-op splats never expand (op < cutoff is culled), so the
            # max() guard only avoids log-of-0 on benign columns.
            rho = jnp.sqrt(
                jnp.log(jnp.maximum(f[ROW_OP], ALPHA_CUTOFF) / ALPHA_CUTOFF)
            )
            thr_q = jnp.minimum(
                jnp.ceil(
                    jnp.minimum(rho, QUAD_EXTENT) * (255.0 / QUAD_EXTENT)
                ).astype(jnp.int32),
                255,
            )
            tnx = tnx | (thr_q << (bits_nx + bits_tile))
        rows = [offsets, tnx[order] if order is not None else tnx] + qrows
        i_q = 2
    else:  # huge tile grids: fall back to the 3-row gather
        if order is not None:
            rows = [offsets, nx1[order], tile0[order]] + qrows
        else:
            rows = [offsets, nx1, tile0] + qrows
        i_q = 3
    exp_ops = jnp.stack(rows)
    g3 = exp_ops[:, s_safe]
    r = pair_idx - g3[0]
    if packed_ok:
        nx_s = g3[1] & ((1 << bits_nx) - 1)
        if rho_ok:
            tile0_s = (g3[1] >> bits_nx) & ((1 << bits_tile) - 1)
            thr_s = (g3[1] >> (bits_nx + bits_tile)).astype(jnp.float32) * (
                QUAD_EXTENT / 255.0
            )
        else:
            tile0_s = g3[1] >> bits_nx
    else:
        nx_s = g3[1]
        tile0_s = g3[2]
    # r // nx via correctly-rounded f32 division: r and nx are small
    # (< 2^24) so the f32 quotient is exact enough for floor (3/3 = 1.0
    # exactly — do NOT use reciprocal-multiply here, 3·(1/3) rounds below 1).
    dty = jnp.floor(r.astype(jnp.float32) / nx_s.astype(jnp.float32)).astype(jnp.int32)
    dtx = r - dty * nx_s
    tile = tile0_s + dty * ntx + dtx
    pair_valid = pair_idx < total
    live = pair_valid
    if sat_cull:
        cx_s = jax.lax.bitcast_convert_type(g3[i_q + 0], jnp.float32)
        cy_s = jax.lax.bitcast_convert_type(g3[i_q + 1], jnp.float32)
        ax_s = jax.lax.bitcast_convert_type(g3[i_q + 2], jnp.float32)
        ay_s = jax.lax.bitcast_convert_type(g3[i_q + 3], jnp.float32)
        bx_s = jax.lax.bitcast_convert_type(g3[i_q + 4], jnp.float32)
        by_s = jax.lax.bitcast_convert_type(g3[i_q + 5], jnp.float32)
        # Tile's pixel-center rect: center (pcx, pcy), half-extent
        # (tw−1)/2 px (pixel centers sit 0.5 px inside the tile edges).
        ty0f = jnp.floor(
            tile0_s.astype(jnp.float32) / jnp.float32(ntx)
        )
        tx_t = (
            (tile0_s - ty0f.astype(jnp.int32) * ntx + dtx).astype(jnp.float32)
            * float(config.col_stride)
            + col_offset.astype(jnp.float32)
        )
        ty_t = (ty0f + dty.astype(jnp.float32)) * float(config.row_stride) \
            + row_offset.astype(jnp.float32)
        tw = float(config.tile_w)
        th = float(config.tile_h)
        pcx = tx_t * tw + (tw * 0.5) - cx_s
        pcy = ty_t * th + (th * 0.5) - cy_s
        hx_r = (tw - 1.0) * 0.5
        hy_r = (th - 1.0) * 0.5
        # Quad-axis intervals of the rect: |q·c| ± h·(|a|+|b|); separated on
        # an axis ⇒ every pixel center fails the kernel's |q|∞ ≤ 2 mask.
        # A 1e-3 quad-unit margin absorbs association-order rounding vs the
        # kernel's own qx/qy evaluation.
        qxc = ax_s * pcx + ay_s * pcy
        qyc = bx_s * pcx + by_s * pcy
        e1 = hx_r * jnp.abs(ax_s) + hy_r * jnp.abs(ay_s)
        e2 = hx_r * jnp.abs(bx_s) + hy_r * jnp.abs(by_s)
        # Per-splat separation threshold: the quad extent, tightened to the
        # opacity discard radius ρ when it rode in (CEIL-quantized, so only
        # ever looser than the true ρ).  Separation at ρ on either quad axis
        # means power > ρ² = ln(op/cutoff) at every pixel center, i.e.
        # α < 1/255 — the kernel discards the pixel AND zeroes its gradient
        # rows (hard mode), so the tightened cull stays image- and
        # gradient-exact.
        thr1 = thr_s if rho_ok else QUAD_EXTENT
        # Margin: 1e-3 quad units absolute (association-order rounding vs
        # the kernel's own qx/qy evaluation) plus a magnitude-relative term:
        # qxc = ax·pcx + ay·pcy can cancel between large products for
        # needle splats, where fp32 absolute error scales with the term
        # magnitudes, not the result.
        err1 = 1e-3 + 1e-6 * (jnp.abs(ax_s * pcx) + jnp.abs(ay_s * pcy))
        err2 = 1e-3 + 1e-6 * (jnp.abs(bx_s * pcx) + jnp.abs(by_s * pcy))
        separated = (jnp.abs(qxc) > thr1 + err1 + e1) | (
            jnp.abs(qyc) > thr1 + err2 + e2
        )
        live = live & jnp.logical_not(separated)
    tile = jnp.where(live, tile, num_tiles)
    # Invalid pairs point at *spread* real ranks instead of one shared
    # sentinel column, so the payload gather has no duplicate-query
    # hotspot.  Safe because an invalid pair's payload is never read
    # unmasked — it sorts past every tile's segment (the compositing kernel
    # forces its opacity to 0) and ``build_tile_lists`` drops it by its
    # sentinel TILE id — so the payload only has to be finite, which every
    # sanitized splat column is.
    spread_mask = (1 << max(int(n).bit_length() - 1, 0)) - 1
    spread = jnp.minimum(pair_idx & spread_mask, n - 1)
    rank_of_pair = jnp.where(pair_valid, s_safe, spread)

    # One sort by tile groups pairs per tile while preserving the global
    # front-to-back order within each tile.  (tile, rank) is packed into a
    # single int32 key when the bit budget allows — one sorted array instead
    # of two, and the tile boundaries come straight from a searchsorted on
    # the shifted tile ids.  Keys of valid pairs are unique (a splat touches
    # a tile at most once), so stability is moot; ranks ascend with depth so
    # ascending key order IS front-to-back within each tile.
    tile_ids = jnp.arange(num_tiles + 1, dtype=jnp.int32)
    bits_r = max((n - 1).bit_length(), 1)
    key_ok = ((num_tiles + 1) << bits_r) <= 2**31 - 1
    if key_ok:
        key = (tile << bits_r) | rank_of_pair
        key_sorted = jax.lax.sort(key)
        tile_sorted = key_sorted >> bits_r
        rank_sorted = key_sorted & ((1 << bits_r) - 1)
        starts = jnp.searchsorted(
            key_sorted, tile_ids << bits_r, side="left"
        ).astype(jnp.int32)
    else:  # 2^23-scale scenes on huge tile grids: two-array sort
        tile_sorted, rank_sorted = jax.lax.sort(
            (tile, rank_of_pair), num_keys=1, is_stable=True
        )
        starts = jnp.searchsorted(tile_sorted, tile_ids, side="left").astype(
            jnp.int32
        )
    # pair → payload column: storage index (through ``order``) so the
    # payload gather reads the unsorted field matrix directly.
    splat_sorted = order[rank_sorted] if order is not None else rank_sorted
    sb = starts[:-1]
    raw_count = starts[1:] - sb
    tile_count = jnp.minimum(raw_count, config.tile_capacity)

    chunk = config.chunk
    p_pad = pair_pad_size(budget, chunk)
    tail = jnp.arange(p_pad - budget, dtype=jnp.int32) & spread_mask
    pair_splat = jnp.concatenate([splat_sorted, jnp.minimum(tail, n - 1)])
    pair_tile = None
    if with_tiles:
        pair_tile = jnp.concatenate(
            [tile_sorted, jnp.full((p_pad - budget,), num_tiles, jnp.int32)]
        )

    dropped = jnp.maximum((cum[-1] if n > 0 else 0) - budget, 0) + jnp.sum(
        raw_count - tile_count
    )
    return BinnedPairs(
        pair_splat=pair_splat,
        pair_tile=pair_tile,
        tile_start=sb,
        tile_count=tile_count,
        dropped_pairs=dropped.astype(jnp.int32),
    )
