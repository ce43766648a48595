"""Multi-device sharded rendering (SPMD over a named mesh).

The reference has no distribution layer (SURVEY.md §5 "Distributed
communication backend: absent").  Decomposition:

* **Splats sharded** over the ``sp`` axis: each device projects N/d splats
  (the heavy per-primitive math + its backward stay fully sharded).
* **all_gather** of the compact projected payload (~44 B/splat) — the
  rasterizer's analogue of a sequence-parallel ring exchange: every device
  needs every visible splat's screen footprint, but only the *projected*
  form, never the raw parameters.
* **Replicated global depth sort** of the gathered keys — every device
  computes the identical stable permutation, so per-tile compositing order
  is bit-identical to the single-device render (determinism across shardings
  by construction; SURVEY.md §7 hard part (d)).
* **Image tile rows sharded** over the same axis: each device bins + fuses
  only its horizontal strip of 32-px tile rows (the pixel/SP dimension).
* Backward: XLA transposes the all_gather into a psum_scatter, so per-splat
  gradients flow back to their owning shard automatically — overlapped with
  the rest of the backward by the XLA scheduler.

Works on any backend (tests run on an 8-device virtual CPU mesh with the
pure-XLA tile compositor; GPUs use the fused Pallas kernels).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.camera import Camera
from ..models.splats import GaussianSplats
from ..ops.binning import (
    _host_callbacks_ok,
    bin_splats,
    tile_grid,
    warn_if_dropped,
)
from ..ops.pallas.composite import composite_splats, unpack_image
from ..ops.projection import (
    ROW_CX,
    ROW_CY,
    ROW_HX,
    ROW_HY,
    ROW_VALID,
    ProjectedSplats,
    project_splats,
)
from ..ops.rasterize_ref import _BENIGN as _BENIGN_COL, quantize_payload, sanitize_projected
from ..ops.rasterize_tiles import (
    build_tile_lists,
    composite_tile_lists,
    sort_by_depth,
)
from ..utils.config import RenderConfig
from ..utils.platform import resolve_backend
from .mesh import SPLAT_AXIS, pad_to_multiple


def _factor_grid(d: int, nty: int, ntx: int):
    """Factor d devices into a (dy, dx) cyclic interleave grid: minimize the
    coarser of the two stride/extent ratios so both axes keep ≥ a few tiles
    of granularity per device (ties prefer more row-wise splitting)."""
    best, best_score = (d, 1), None
    for dy in range(1, d + 1):
        if d % dy:
            continue
        dx = d // dy
        score = max(dy / max(nty, 1), dx / max(ntx, 1))
        if best_score is None or score < best_score - 1e-12:
            best, best_score = (dy, dx), score
    return best


def pad_splats(splats: GaussianSplats, multiple: int) -> GaussianSplats:
    """Pad the splat cluster with fully transparent splats (culled at
    binning) so N divides the mesh axis."""
    n = splats.count
    n_pad = pad_to_multiple(n, multiple)
    if n_pad == n:
        return splats
    extra = n_pad - n

    def pad(x):
        widths = [(0, 0)] * (x.ndim - 1) + [(0, extra)]
        return jnp.pad(x, widths)

    return GaussianSplats(
        pos=pad(splats.pos),
        orient=pad(splats.orient),
        scale=pad(splats.scale),
        opacity=pad(splats.opacity),  # zero-padded → opacity 0 → culled
        color=pad(splats.color),
        sh=pad(splats.sh),
    )


def splat_sharding_spec(axis: str = SPLAT_AXIS) -> GaussianSplats:
    """Per-leaf PartitionSpecs: the splat axis is the LAST dim of every
    field (SoA layout: components × splats)."""
    return GaussianSplats(
        pos=P(None, axis),
        orient=P(None, axis),
        scale=P(None, axis),
        opacity=P(axis),
        color=P(None, axis),
        sh=P(None, axis),
    )


def shard_splats(splats: GaussianSplats, mesh: Mesh, axis: str = SPLAT_AXIS) -> GaussianSplats:
    """Pad + device_put with the splat (last) dim sharded over ``axis``."""
    padded = pad_splats(splats, mesh.shape[axis])
    specs = splat_sharding_spec(axis)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), padded, specs
    )


def _warn_exchange_dropped_cb(dropped) -> None:
    from ..utils.logging import format_count, get_logger

    log = get_logger("parallel")
    d = int(dropped)
    if d > 0:
        log.warning_once(
            f"strip-exchange bucket overflow — dropped {format_count(d)} "
            "splat columns; raise RenderConfig.strip_exchange_factor",
            key="strip_exchange_dropped",
        )
    else:
        log.reset_once("strip_exchange_dropped")


def _strip_overlap(fields, width: int, strip_h: int, d: int):
    """Shared compaction predicate: which strips can each projected splat's
    footprint overlap?  Returns ``(alive, s0, s1)`` — the exact test
    ``_strip_exchange`` compacts by AND ``measure_strip_counts`` counts by,
    so the tuner can never under-size the buckets it measures for."""
    y_lo = fields[ROW_CY] - fields[ROW_HY]
    y_hi = fields[ROW_CY] + fields[ROW_HY]
    x_lo = fields[ROW_CX] - fields[ROW_HX]
    x_hi = fields[ROW_CX] + fields[ROW_HX]
    alive = (
        (fields[ROW_VALID] > 0.5)
        & (x_hi >= 0.0)
        & (x_lo < width)
        & (y_hi >= 0.0)
        & (y_lo < d * strip_h)
    )
    sh_px = float(strip_h)
    s0 = jnp.clip(jnp.floor(y_lo / sh_px).astype(jnp.int32), 0, d - 1)
    s1 = jnp.clip(jnp.floor(y_hi / sh_px).astype(jnp.int32), 0, d - 1)
    return alive, s0, s1


def _strip_exchange(
    fields,
    width: int,
    strip_h: int,
    d: int,
    bucket: int,
    axis: str,
):
    """Strip-compacted payload exchange: all_to_all instead of all_gather.

    ``fields``: (16, n_local) sanitized projected fields of THIS device's
    splat shard.  For each destination strip s, the local splats whose
    footprint can overlap strip s (same y-extent/cull arithmetic the binning
    uses — a superset of the splats binning will keep, so extras are culled
    identically downstream) are compacted into a bucket of ``bucket``
    columns; one ``all_to_all`` ships bucket s to device s.  Returns
    (16, d·bucket) fields — every splat overlapping the local strip, in
    global storage order (source-device-major, then local storage order),
    padding columns benign/invalid — plus the global overflow count.

    Overflow semantics: when a bucket overflows, the splats compacted LAST
    in local storage order are dropped — arbitrary depth, unlike the
    pair-budget cull's farthest-first truncation — so treat a nonzero drop
    count as misconfiguration and raise ``strip_exchange_factor`` (or call
    ``tune_strip_exchange`` to measure the scene's real worst-strip share).

    Per-device payload memory is O(d·bucket) = O(strip_exchange_factor·N)
    instead of the all_gather path's O(N); the replicated global sort
    shrinks identically (the strip sorts only its own splats — per-tile
    compositing order, and therefore the image, is unchanged: a stable
    depth sort of a storage-ordered subset preserves the global relative
    order)."""
    n_local = fields.shape[1]
    alive, s0, s1 = _strip_overlap(fields, width, strip_h, d)

    ids = jnp.arange(n_local, dtype=jnp.int32)
    benign = jnp.asarray(_BENIGN_COL)[:, None]
    bufs = []
    dropped = jnp.int32(0)
    for s in range(d):  # static: d is the mesh axis size
        m = alive & (s0 <= s) & (s <= s1)
        pos = jnp.cumsum(m.astype(jnp.int32)) - 1
        count = pos[-1] + 1 if n_local > 0 else jnp.int32(0)
        idx = jnp.zeros((bucket,), jnp.int32).at[
            jnp.where(m & (pos < bucket), pos, bucket)
        ].set(ids, mode="drop")
        slot_ok = jnp.arange(bucket, dtype=jnp.int32) < jnp.minimum(count, bucket)
        cols = jnp.where(slot_ok[None, :], fields[:, idx], benign)
        bufs.append(cols)
        dropped = dropped + jnp.maximum(count - bucket, 0)
    x = jnp.stack(bufs)  # (d, 16, bucket): bucket s for device s
    x = jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0)
    # x[j] is now what source device j compacted for MY strip; device-major
    # concat = global storage order.
    full = jnp.swapaxes(x, 0, 1).reshape(16, d * bucket)
    return full, jax.lax.psum(dropped, axis)


def _render_strip(
    projected,
    width: int,
    strip_h: int,
    row_offset,
    config: RenderConfig,
    backend: str,
    order=None,
    n_strips: int = 1,
    interpret: bool = False,
    col_offset=0,
):
    """Bin + composite one horizontal strip of tile rows (local to a device).

    ``projected`` is the full sanitized projected-splat set — depth-sorted
    when ``order`` is None, in storage order with ``order`` holding the
    depth permutation otherwise; ``row_offset`` (traced int, in tiles)
    selects the strip.  Splat coordinates are never shifted — tile indices
    and pixel coordinates use exact integer offsets, so every strip is
    bit-identical to the matching rows of a full-frame render.

    Returns ``(image, dropped_pairs)`` — the strip-local truncation count.
    """
    p = projected
    binned = bin_splats(
        p, width, strip_h, config, row_offset=row_offset,
        with_tiles=(backend != "pallas"),
        order=order,
        budget=config.strip_pair_budget(p.count, n_strips),
        col_offset=col_offset,
    )
    warn_if_dropped(binned, config)
    nty, ntx = tile_grid(width, strip_h, config.tile_h, config.tile_w)
    if backend == "pallas":
        tiles = composite_splats(
            p.fields[:10],
            binned.pair_splat,
            binned.tile_start,
            binned.tile_count,
            jnp.stack([
                jnp.asarray(row_offset, jnp.int32),
                jnp.asarray(col_offset, jnp.int32),
            ]),
            None,
            ntx,
            config,
            interpret,
        )
        image = unpack_image(tiles, nty, ntx, strip_h, width)
        return image, binned.dropped_pairs
    lists = build_tile_lists(binned, nty * ntx, config.tile_capacity, p.count)
    image = composite_tile_lists(
        lists, p.fields, width, strip_h, config, row_offset=row_offset,
        col_offset=col_offset,
    )
    return image, binned.dropped_pairs


def exchange_projected(
    p: ProjectedSplats,
    width: int,
    strip_h: int,
    d: int,
    config: RenderConfig,
    axis: str,
) -> "tuple[ProjectedSplats, object]":
    """Collect every strip-relevant projected field column on this device.

    ``p`` is this device's sanitized+quantized projected shard; returns
    ``(fields, exchange_dropped)``: the (16, ·) fields of every splat
    overlapping the local strip, in global storage order, plus the bucket
    overflow counter.  Three policies, chosen by ``config`` (shared by the
    sharded renderer AND the sharded trainer so both speak the same
    collective / precision dialect):

    * ``strip_exchange_factor > 0`` — sub-O(N)-per-device ``all_to_all`` of
      per-strip compacted buckets (overflow drops columns, warned);
    * ``payload_dtype == "bfloat16"`` — ``all_gather`` with the 10 payload
      rows shipped as real bf16 (half the collective bytes;
      quantization happened per-shard already, so the upcast is exact);
    * default — fp32 ``all_gather`` of the full field matrix.

    Returns ``(fields, exchange_dropped)`` — the drop count is a traced
    scalar for the strip-exchange path, else a constant 0.
    """
    ex_dropped = jnp.int32(0)
    if config.strip_exchange_factor > 0.0:
        # Sub-O(N)-per-device path: ship, per strip, only the splats
        # that can overlap it (one all_to_all instead of all_gather).
        bucket = min(
            max(int(math.ceil(config.strip_exchange_factor * p.count)), 1),
            p.count,
        )
        full, ex_dropped = _strip_exchange(
            p.fields, width, strip_h, d, bucket, axis
        )
        if config.warn_on_drop and _host_callbacks_ok():
            jax.debug.callback(_warn_exchange_dropped_cb, ex_dropped)
    elif config.payload_dtype == "bfloat16":
        # The 10 payload rows are already bf16-representable — ship them
        # as real bf16 (half the collective bytes and half the
        # replicated-buffer HBM; upcast is exact).  Geometry rows (depth
        # key, validity, footprint) stay fp32.
        pay = jax.lax.all_gather(
            p.fields[:10].astype(jnp.bfloat16), axis, axis=1, tiled=True
        ).astype(jnp.float32)
        geo = jax.lax.all_gather(p.fields[10:], axis, axis=1, tiled=True)
        full = jnp.concatenate([pay, geo], axis=0)
    else:
        full = jax.lax.all_gather(p.fields, axis, axis=1, tiled=True)
    return ProjectedSplats(fields=full), ex_dropped


def local_strip_render(
    splats_local: GaussianSplats,
    camera: Camera,
    strip_h: int,
    d: int,
    config: RenderConfig,
    backend: str,
    axis: str,
    interpret: bool = False,
    with_stats: bool = False,
    strip_w: int = None,
):
    """Device-local body of the sharded render: project this device's splat
    shard, exchange the compact projected payload, sort, and composite the
    local strip of tile rows.  Runs inside ``shard_map`` (the sharded
    renderer's ``local_fn`` and each camera of the sharded trainer's loss).

    ``with_stats=True`` additionally returns the device-global overflow
    counters (pair-budget drops psum'd over strips + exchange drops) as a
    :class:`gsplat_tpu.ops.binning.RenderStats`.
    """
    from ..ops.binning import RenderStats  # local import: avoid cycle

    projected = project_splats(
        splats_local, camera, config.sh_order,
        tight_footprint=not config.soft_cutoff, only_sh=config.only_sh,
    )
    # Quantized BEFORE the collective: rounding per-shard is bit-identical
    # to rounding the gathered array, so sharded output still matches
    # single-device under payload_dtype=bfloat16.
    p = quantize_payload(sanitize_projected(projected), config)
    full, ex_dropped = exchange_projected(
        p, camera.width, strip_h, d, config, axis
    )
    p_sorted = sort_by_depth(full)
    di = jax.lax.axis_index(axis)
    col_offset = jnp.int32(0)
    if config.row_stride > 1 or config.col_stride > 1:
        # Cyclic interleave: devices form a (row_stride × col_stride) grid,
        # di = a·col_stride + b; device (a, b) owns global tile rows
        # ≡ a (mod row_stride) and cols ≡ b (mod col_stride).
        row_offset = di // config.col_stride
        col_offset = jax.lax.rem(di, config.col_stride)
    else:
        row_offset = di * (strip_h // config.tile_h)
    strip, dropped = _render_strip(
        p_sorted, strip_w if strip_w is not None else camera.width,
        strip_h, row_offset, config, backend,
        n_strips=d, interpret=interpret, col_offset=col_offset,
    )
    if not with_stats:
        return strip
    stats = RenderStats(
        dropped_pairs=jax.lax.psum(dropped, axis),
        exchange_dropped=ex_dropped,
    )
    return strip, stats


def render_sharded(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    mesh: Mesh = None,
    backend: str = "auto",
    axis: str = SPLAT_AXIS,
    with_stats: bool = False,
) -> jnp.ndarray:
    """Multi-device render.  ``splats`` leading dims must divide the mesh
    axis (use :func:`shard_splats`).  Returns (H, W, 4), rows sharded — or
    ``(image, RenderStats)`` with ``with_stats=True`` (replicated overflow
    counters as jit outputs, the transport that works on backends without
    host callbacks and in multi-process runs).
    """
    if mesh is None:
        raise ValueError("render_sharded requires a mesh")
    backend = resolve_backend(backend)
    # "pallas_interpret": the production pallas strip path executed through
    # the Pallas interpreter — runs on the CPU mesh, so the sharded-pallas
    # combination (nonzero row/col offsets, per-strip budgets) is testable
    # without a multi-GPU host.
    interpret = backend == "pallas_interpret"
    if interpret:
        backend = "pallas"
    d = mesh.shape[axis]
    # Each device owns 1/d of the 32-px tiles.  "cyclic" (default) factors
    # d into a (dy × dx) grid and interleaves tile rows AND columns —
    # device (a, b) owns global tiles (row ≡ a mod dy, col ≡ b mod dx) —
    # which balances center-heavy splat distributions to within a few
    # percent of the mean pair share at any device count (contiguous strips
    # measured 2.1× worst/mean at 32 devices; cyclic rows alone hit a
    # granularity floor at d ≳ tile rows; scripts/scaling_model.py).  The
    # strip-compacted exchange needs spatially coherent strips, so it
    # forces "contiguous".
    cyclic = (
        config.row_assignment == "cyclic"
        and config.strip_exchange_factor == 0.0
        and d > 1
    )
    if cyclic:
        nty_full, ntx_full = tile_grid(
            camera.width, camera.height, config.tile_h, config.tile_w
        )
        dy, dx = _factor_grid(d, nty_full, ntx_full)
        h_pad = pad_to_multiple(camera.height, dy * config.tile_h)
        w_pad = pad_to_multiple(camera.width, dx * config.tile_w)
        strip_h = h_pad // dy
        strip_w = w_pad // dx
        cfg_local = dataclasses.replace(config, row_stride=dy, col_stride=dx)
    else:
        h_pad = pad_to_multiple(camera.height, d * config.tile_h)
        strip_h = h_pad // d
        strip_w = camera.width
        w_pad = camera.width
        dy, dx = d, 1
        cfg_local = config

    def local_fn(splats_local):
        return local_strip_render(
            splats_local, camera, strip_h, d, cfg_local, backend, axis,
            interpret=interpret, with_stats=with_stats, strip_w=strip_w,
        )

    in_specs = (splat_sharding_spec(axis),)
    from ..ops.binning import RenderStats

    out_specs = (
        (P(axis), RenderStats(dropped_pairs=P(), exchange_dropped=P()))
        if with_stats
        else P(axis)
    )
    # check_vma=False: the compositing scan initializes its carry from
    # device-invariant constants, which the varying-axes checker rejects even
    # though the computation is correct under replication.
    fn = jax.shard_map(
        local_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )
    @jax.jit
    def assemble(image):
        # jitted: the de-interleave reshapes a GLOBAL array, which eager
        # mode cannot do across processes (non-addressable shards); under
        # jit it is one resharding collective.
        if cyclic:
            # Device-major stacked cells → true screen order: global tile
            # (jy·dy + a, jx·dx + b) comes from device a·dx + b's local
            # tile (jy, jx).
            nty_l = strip_h // config.tile_h
            ntx_l = strip_w // config.tile_w
            th, tw = config.tile_h, config.tile_w
            x = image.reshape(dy, dx, nty_l, th, ntx_l, tw, 4)
            x = x.transpose(2, 0, 3, 4, 1, 5, 6)
            image = x.reshape(h_pad, w_pad, 4)
        return image[: camera.height, : camera.width]

    if with_stats:
        image, stats = fn(splats)
        return assemble(image), stats
    image = fn(splats)
    return assemble(image)


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _strip_counts_jit(splats, camera, width, strip_h, d, config):
    p = quantize_payload(
        sanitize_projected(
            project_splats(
                splats, camera, config.sh_order,
                tight_footprint=not config.soft_cutoff,
            )
        ),
        config,
    )
    alive, s0, s1 = _strip_overlap(p.fields, width, strip_h, d)
    n_local = p.count // d
    counts = []
    for s in range(d):
        m = (alive & (s0 <= s) & (s <= s1)).astype(jnp.int32)
        counts.append(jnp.sum(m.reshape(d, n_local), axis=1))
    return jnp.stack(counts, axis=1)  # (source shard, dest strip)


def measure_strip_counts(
    splats: GaussianSplats,
    camera: Camera,
    d: int,
    config: RenderConfig = RenderConfig(),
):
    """(d, d) host matrix: how many of source shard i's splats the strip
    exchange would compact for dest strip j this frame — the exact
    ``_strip_overlap`` predicate on the exact contiguous shard blocks
    ``shard_splats`` creates.  One cheap counting pass (projection + bbox
    arithmetic; no pair arrays, no mesh needed)."""
    import numpy as np

    h_pad = pad_to_multiple(camera.height, d * config.tile_h)
    strip_h = h_pad // d
    padded = pad_splats(splats, d)
    return np.asarray(
        _strip_counts_jit(padded, camera, camera.width, strip_h, d, config)
    )


def tune_strip_exchange(
    splats: GaussianSplats,
    cameras,
    d: int,
    config: RenderConfig = RenderConfig(),
    headroom: float = 1.3,
) -> RenderConfig:
    """Measure the scene's real worst (shard, strip) overlap share and set
    ``strip_exchange_factor`` with ``headroom`` — the strip-exchange
    analogue of :func:`gsplat_tpu.tune_pair_budget`.

    Bucket overflow drops splat columns in storage order (arbitrary depth),
    so the factor must never be guessed low; measuring the worst strip and
    adding headroom makes the sub-O(N) exchange safe by construction for
    the measured cameras (and warned-on, via the drop counters, for any
    camera that exceeds them).  ``cameras``: one Camera or an iterable
    (e.g. a training set's extremes); the max across them is used.

    Returns a config whose factor yields per-device payload memory of
    ``factor·N/d`` columns instead of ``N`` (factor ≤ 1; a measured factor
    at or above 1 − 1/d means the exchange cannot beat the all_gather for
    this scene, and the returned config keeps factor = 0).
    """
    if isinstance(cameras, Camera):
        cameras = [cameras]
    n_local = pad_to_multiple(splats.count, d) // d
    worst = 0
    for cam in cameras:
        worst = max(worst, int(measure_strip_counts(splats, cam, d, config).max()))
    factor = min(headroom * worst / max(n_local, 1), 1.0)
    if factor >= 1.0 - 1.0 / d:
        # d·bucket ≥ (d−1)·n_local: the exchange would ship ~as many columns
        # as the all_gather while paying the compaction — not worth it.
        return dataclasses.replace(config, strip_exchange_factor=0.0)
    return dataclasses.replace(config, strip_exchange_factor=factor)
