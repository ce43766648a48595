"""Fused tile-compositing kernels for the GPU (Pallas, Triton route).

The reference's GL fragment stage + fixed-function blend
(``gsplat_plugin/shaders/GSplatShaderSource.h:293-315``,
``src/GSplatRenderer.C:605-647``) as one Pallas kernel per 32×32-pixel
screen tile: the program walks its depth-ordered (tile, splat) pair segment
front to back and accumulates premultiplied color with the "under" operator,
stopping once every pixel of the tile is saturated.

Design (the per-tile front-to-back shape of the 3DGS CUDA rasterizer):

* One program per tile; the tile's 1024 pixels are one flat vector
  (``pixel = row·32 + col``).  Each program loads its own segment bounds
  (``tile_start``, ``tile_count``) and reads its pairs at any alignment.
* The pair payload is a (rows, P) f32 matrix in tile-sorted order; per pair
  the kernel reads its 10 (11 with the depth test) fields as scalars, which
  every thread of the block shares, and does the alpha/blend math on the
  pixel vector.
* The pair walk runs in chunks of ``config.chunk`` pairs.  After each chunk
  the block checks whether any pixel's transmittance is still above
  ``transmittance_eps``; if none is, the tile stops.
* Forward-for-backward also writes the transmittance at the start of every
  chunk (a checkpoint) and the number of pairs the tile composited.  The
  backward walks the chunks in reverse: it replays each chunk front to back
  from its checkpoint, keeping every pair's transmittance in registers, then
  walks the chunk back to front with the division-free suffix identities
  (see ``_bwd_kernel``).  Pairs after the stop point get exact zero
  gradients.
* The backward reduces each pair's gradient over the tile's pixels inside
  the block and writes one row per pair at the pair's own index: every pair
  belongs to exactly one tile, so the stores never race.  The per-splat sum
  of those rows is an XLA ``segment_sum`` over ``pair_splat``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ...utils.config import RenderConfig
from ..covariance import ALPHA_CUTOFF, QUAD_EXTENT

TILE = 32              # a program composites one TILE×TILE pixel tile
NPIX = TILE * TILE     # pixels per program (a power of two, as Triton needs)
G_ROWS = 16            # per-pair gradient row width (10 used; power of two)
NUM_WARPS = 4          # 128 threads, 8 pixels each per vector: of 2/4/8/16
                       # warps × chunk 4/8/16/32, 4 warps at chunk 4-8 ran the
                       # 1M/1080p forward+backward fastest on an H100


def _pixel_coords(txg, tyg):
    """Pixel-center coordinates of global tile (tyg, txg): (NPIX,) f32."""
    lane = jnp.arange(NPIX, dtype=jnp.int32)
    px = (txg * TILE + (lane % TILE)).astype(jnp.float32) + 0.5
    py = (tyg * TILE + (lane // TILE)).astype(jnp.float32) + 0.5
    return px, py


def _tile_origin(t, ntx, off_ref, row_stride, col_stride):
    """Global (tile col, tile row) of program t: local · stride + offset."""
    ty = t // ntx
    tx = t - ty * ntx
    return tx * col_stride + off_ref[1], ty * row_stride + off_ref[0]


def _load_pair(pay_ref, pos, valid, depth_test):
    """One pair's payload scalars; a masked pair's opacity reads as 0."""
    f = [pay_ref[k, pos] for k in range(10)]
    f[9] = jnp.where(valid, f[9], 0.0)
    z = pay_ref[10, pos] if depth_test else None
    return f, z


def _alpha(f, z, px, py, bgd, cfg_alpha):
    """Per-pixel alpha of one pair plus the intermediates the backward
    needs.  ``cfg_alpha`` = (max_alpha, soft_cutoff, wireframe, line_px)."""
    max_alpha, soft_cutoff, wireframe, line_px = cfg_alpha
    cx, cy, ax, ay, bx, by = f[0], f[1], f[2], f[3], f[4], f[5]
    op = f[9]
    dx = px - cx
    dy = py - cy
    qx = dx * ax + dy * ay
    qy = dx * bx + dy * by
    if wireframe:
        # Opaque band on the ±QUAD_EXTENT quad edge (the reference's
        # line-quad pass, GSplatShaderSource.h:22-110): the band half-width
        # in quad units is line_px·|A| (resp. |B|) on the dominant axis.
        wq1 = line_px * jnp.sqrt(ax * ax + ay * ay)
        wq2 = line_px * jnp.sqrt(bx * bx + by * by)
        aqx = jnp.abs(qx)
        aqy = jnp.abs(qy)
        m = jnp.maximum(aqx, aqy)
        wq = jnp.where(aqx > aqy, wq1, wq2)
        on_edge = (jnp.abs(m - QUAD_EXTENT) <= wq) & (op > 0.0)
        return jnp.where(on_edge, 1.0, 0.0), dx, dy, qx, qy
    qx2 = qx * qx
    qy2 = qy * qy
    alpha = jnp.minimum(jnp.exp(-(qx2 + qy2)) * op, max_alpha)
    if not soft_cutoff:
        inside = jnp.maximum(qx2, qy2) <= QUAD_EXTENT * QUAD_EXTENT
        alpha = jnp.where(inside & (alpha >= ALPHA_CUTOFF), alpha, 0.0)
    if bgd is not None:
        # Depth-tested compositing into a host scene: a splat whose center
        # lies behind the scene depth is killed at that pixel (the
        # reference's z-tested, non-z-writing beauty pass,
        # src/GSplatRenderer.C:595-610).  α = 0 also zeroes its gradients.
        alpha = jnp.where(z <= bgd, alpha, 0.0)
    return alpha, dx, dy, qx, qy


def _fwd_kernel(
    start_ref, count_ref, off_ref, pay_ref, *rest,
    ntx, chunk, t_eps, checkpoint, depth_test, strides, cfg_alpha,
):
    if depth_test:
        bgd_ref, rest = rest[0], rest[1:]
    out_ref, stop_ref = rest[0], rest[1]
    tchk_ref = rest[2] if checkpoint else None
    t = pl.program_id(0)
    start = start_ref[t]
    count = count_ref[t]
    txg, tyg = _tile_origin(t, ntx, off_ref, *strides)
    px, py = _pixel_coords(txg, tyg)
    bgd = bgd_ref[t, :] if depth_test else None
    nchunks = pl.cdiv(count, chunk)
    slot0 = start // chunk + t  # this tile's first checkpoint slot

    def pair_step(k, carry, ci):
        acc_r, acc_g, acc_b, trans = carry
        i = ci * chunk + k
        f, z = _load_pair(pay_ref, start + i, i < count, depth_test)
        alpha = _alpha(f, z, px, py, bgd, cfg_alpha)[0]
        w = alpha * trans
        return (acc_r + w * f[6], acc_g + w * f[7], acc_b + w * f[8],
                trans * (1.0 - alpha))

    # A fori_loop over the chunks with the work under a cond, not a
    # while_loop: the GPU compiler crashes on a while_loop whose carried
    # vectors depend on a vector loaded from an input (the depth test's
    # scene depth).  Chunks after the stop cost one scalar branch each.
    def body(ci, state):
        def run(s):
            _, _, acc_r, acc_g, acc_b, trans = s
            if checkpoint:
                tchk_ref[slot0 + ci, :] = trans
            acc_r, acc_g, acc_b, trans = jax.lax.fori_loop(
                0, chunk, functools.partial(pair_step, ci=ci),
                (acc_r, acc_g, acc_b, trans),
            )
            return jnp.max(trans) > t_eps, ci + 1, acc_r, acc_g, acc_b, trans

        return jax.lax.cond(state[0], run, lambda s: s, state)

    zeros = jnp.zeros((NPIX,), jnp.float32)
    _, ci, acc_r, acc_g, acc_b, trans = jax.lax.fori_loop(
        0, nchunks, body,
        (jnp.bool_(True), jnp.int32(0), zeros, zeros, zeros, zeros + 1.0),
    )
    out_ref[t, 0, :] = acc_r
    out_ref[t, 1, :] = acc_g
    out_ref[t, 2, :] = acc_b
    out_ref[t, 3, :] = 1.0 - trans
    # Pairs actually composited (ci = chunks walked; chunk-granular early
    # stop): the backward walks exactly these.
    stop_ref[t] = jnp.minimum(count, ci * chunk)


def _bwd_kernel(
    start_ref, count_ref, stop_ref, off_ref, pay_ref, *rest,
    ntx, chunk, depth_test, strides, cfg_alpha,
):
    """Backward: division-free two-pass replay, one gradient row per pair.

    The textbook 3DGS backward recovers each pair's transmittance by
    dividing the final T by (1−α) back to front, which collapses once T
    underflows in saturated pixels.  Here every chunk is replayed forward
    from the forward pass's checkpoint (same ops, so T is exact), and the
    reverse walk uses the fused suffix accumulator
        u_last = −d_A,   d_α_i = T_i·(K_i − u_i),   u_{i−1} = u_i + α_i·(K_i − u_i)
    with K_i = dC·c_i — an exact rewrite of
    d_α_i = T_i·K_i − (Σ_{j>i} K_j·α_j·T_j − d_A·T_final)/(1−α_i)
    that never divides.
    """
    max_alpha, soft_cutoff = cfg_alpha[0], cfg_alpha[1]
    if depth_test:
        bgd_ref, rest = rest[0], rest[1:]
    dout_ref, tchk_ref, _zeros_ref, dpair_ref = rest
    t = pl.program_id(0)
    start = start_ref[t]
    count = count_ref[t]
    txg, tyg = _tile_origin(t, ntx, off_ref, *strides)
    px, py = _pixel_coords(txg, tyg)
    bgd = bgd_ref[t, :] if depth_test else None
    slot0 = start // chunk + t
    dc_r = dout_ref[t, 0, :]
    dc_g = dout_ref[t, 1, :]
    dc_b = dout_ref[t, 2, :]
    d_a = dout_ref[t, 3, :]
    row = jnp.arange(G_ROWS, dtype=jnp.int32)
    nused = pl.cdiv(stop_ref[t], chunk)

    def body(k, u):
        ci = nused - 1 - k
        # Pass 1: exact forward replay of the chunk from its checkpoint.
        trans = tchk_ref[slot0 + ci, :]
        pairs = []
        for j in range(chunk):
            i = ci * chunk + j
            f, z = _load_pair(pay_ref, start + i, i < count, depth_test)
            alpha = _alpha(f, z, px, py, bgd, cfg_alpha)[0]
            pairs.append((i, f, z, trans))
            trans = trans * (1.0 - alpha)
        # Pass 2: back to front, gradients reduced over the tile's pixels.
        for i, f, z, t_i in reversed(pairs):
            alpha, dx, dy, qx, qy = _alpha(f, z, px, py, bgd, cfg_alpha)
            kk = f[6] * dc_r + f[7] * dc_g + f[8] * dc_b
            ku = kk - u
            u = u + alpha * ku
            active = alpha < max_alpha
            if not soft_cutoff:
                active = active & (alpha > 0.0)
            ga = jnp.where(active, t_i * ku, 0.0)  # dL/dα, clamp-gated
            w = alpha * t_i
            dpow = -2.0 * ga * alpha               # 2·dL/dpower
            dqx = dpow * qx
            dqy = dpow * qy
            s_qx = jnp.sum(dqx)
            s_qy = jnp.sum(dqy)
            grads = (
                -(f[2] * s_qx + f[4] * s_qy),      # cx
                -(f[3] * s_qx + f[5] * s_qy),      # cy
                jnp.sum(dqx * dx),                 # ax
                jnp.sum(dqx * dy),                 # ay
                jnp.sum(dqy * dx),                 # bx
                jnp.sum(dqy * dy),                 # by
                jnp.sum(dc_r * w),                 # r
                jnp.sum(dc_g * w),                 # g
                jnp.sum(dc_b * w),                 # b
                # dα/dop = α/op where unclamped; masked pairs have α ≡ 0
                jnp.sum(ga * alpha) / jnp.maximum(f[9], 1e-20),  # opacity
            )
            vec = jnp.zeros((G_ROWS,), jnp.float32)
            for r, g in enumerate(grads):
                vec = jnp.where(row == r, g, vec)
            plt.store(dpair_ref.at[start + i, :], vec, mask=(row < 10) & (i < count))
        return u

    jax.lax.fori_loop(0, nused, body, -d_a)


def _params(cfg: RenderConfig):
    return dict(
        strides=(cfg.row_stride, cfg.col_stride),
        cfg_alpha=(cfg.max_alpha, cfg.soft_cutoff, cfg.wireframe, cfg.line_px),
    )


def checkpoint_slots(p_pad: int, num_tiles: int, chunk: int) -> int:
    """Rows of the transmittance-checkpoint buffer.  Tile t's chunk c uses
    slot ``start_t // chunk + t + c``: the slots of consecutive tiles never
    overlap (start_{t+1} ≥ start_t + count_t), and the buffer grows with
    the pair budget, not with ``tile_capacity`` × tiles."""
    return p_pad // chunk + num_tiles + 1


@functools.lru_cache(maxsize=32)
def _build_fwd(num_tiles, ntx, p_pad, cfg: RenderConfig, checkpoint, interpret):
    out_shape = [
        jax.ShapeDtypeStruct((num_tiles, 4, NPIX), jnp.float32),
        jax.ShapeDtypeStruct((num_tiles,), jnp.int32),
    ]
    if checkpoint:
        out_shape.append(jax.ShapeDtypeStruct(
            (checkpoint_slots(p_pad, num_tiles, cfg.chunk), NPIX), jnp.float32
        ))
    return pl.pallas_call(
        functools.partial(
            _fwd_kernel, ntx=ntx, chunk=cfg.chunk,
            t_eps=cfg.transmittance_eps, checkpoint=checkpoint,
            depth_test=cfg.depth_test, **_params(cfg),
        ),
        grid=(num_tiles,),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="gsplat_composite_fwd",
    )


@functools.lru_cache(maxsize=32)
def _build_bwd(num_tiles, ntx, p_pad, cfg: RenderConfig, interpret):
    n_in = 8 if cfg.depth_test else 7
    return pl.pallas_call(
        functools.partial(
            _bwd_kernel, ntx=ntx, chunk=cfg.chunk,
            depth_test=cfg.depth_test, **_params(cfg),
        ),
        grid=(num_tiles,),
        out_shape=jax.ShapeDtypeStruct((p_pad, G_ROWS), jnp.float32),
        # The pre-zeroed input aliases the output: pairs the kernel never
        # walks (early-stopped, over capacity, padding) keep zero rows.
        input_output_aliases={n_in: 0},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="gsplat_composite_bwd",
    )


def composite_pairs(
    payload, tile_start, tile_count, offsets, ntx, config, interpret=False,
    bg_depth=None,
):
    """Forward-only compositing of a prebuilt (rows, P_pad) pair payload.
    Returns (T, 4, NPIX) premultiplied RGBA tiles (see :func:`unpack_image`)."""
    fwd = _build_fwd(
        tile_start.shape[0], ntx, payload.shape[1], config, False, interpret
    )
    bg = (bg_depth,) if config.depth_test else ()
    out, _ = fwd(tile_start, tile_count, offsets, payload, *bg)
    return out


def pack_depth_tiles(bg_depth: jnp.ndarray, nty: int, ntx: int) -> jnp.ndarray:
    """(H, W) scene depth → (T, NPIX) per-tile pixel vectors, padded with
    +inf so off-image pixels never kill anything."""
    h, w = bg_depth.shape
    d = jnp.pad(
        bg_depth, ((0, nty * TILE - h), (0, ntx * TILE - w)),
        constant_values=jnp.inf,
    )
    return d.reshape(nty, TILE, ntx, TILE).transpose(0, 2, 1, 3).reshape(-1, NPIX)


def _int0(x):
    """Symbolic-zero cotangent for an integer-dtype primal."""
    return np.zeros(x.shape, jax.dtypes.float0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7, 8))
def composite_splats(
    fields: jnp.ndarray,       # (10|11, N) f32 payload rows (row 10 = view-z
                               # when config.depth_test)
    pair_splat: jnp.ndarray,   # (P_pad,) int32 — tile-sorted pair → column
    tile_start: jnp.ndarray,   # (T,) int32
    tile_count: jnp.ndarray,   # (T,) int32
    offsets: jnp.ndarray,      # (2,) int32 — global tile (row, col) offset
    bg_depth: jnp.ndarray,     # (T, NPIX) scene depth, or None
    ntx: int,
    config: RenderConfig,
    interpret: bool = False,
) -> jnp.ndarray:
    """Differentiable fused rasterization tail: payload gather + compositing.

    Returns (T, 4, NPIX) premultiplied RGBA tiles.  Gradients flow to
    ``fields`` only; the VJP sums the backward kernel's per-pair rows per
    splat column with ``segment_sum`` over ``pair_splat``, so ``fields`` may
    be in any column order (depth-sorted or storage order)."""
    return composite_pairs(
        fields[:, pair_splat], tile_start, tile_count, offsets, ntx, config,
        interpret, bg_depth,
    )


def _cs_fwd(fields, pair_splat, tile_start, tile_count, offsets, bg_depth,
            ntx, config, interpret):
    if config.wireframe:
        raise ValueError(
            "wireframe mode is forward-only (the band test has no useful "
            "gradient); render through render_wireframe"
        )
    payload = fields[:, pair_splat]  # (rows, P_pad), tile-sorted
    fwd = _build_fwd(
        tile_start.shape[0], ntx, payload.shape[1], config, True, interpret
    )
    bg = (bg_depth,) if config.depth_test else ()
    out, stop, tchk = fwd(tile_start, tile_count, offsets, payload, *bg)
    res = (fields, payload, pair_splat, tile_start, tile_count, offsets,
           bg_depth, stop, tchk)
    return out, res


def _cs_bwd(ntx, config, interpret, res, g):
    (fields, payload, pair_splat, tile_start, tile_count, offsets, bg_depth,
     stop, tchk) = res
    p_pad = payload.shape[1]
    bwd = _build_bwd(tile_start.shape[0], ntx, p_pad, config, interpret)
    bg = (bg_depth,) if config.depth_test else ()
    dpair = bwd(
        tile_start, tile_count, stop, offsets, payload, *bg, g, tchk,
        jnp.zeros((p_pad, G_ROWS), jnp.float32),
    )
    # Per-splat sums of the per-pair rows.  (In-kernel atomic adds instead
    # measured 35.04 vs 28.55 ms for the whole 1M/1080p forward+backward
    # on an H100 at 400 W.)
    d10 = jax.ops.segment_sum(
        dpair[:, :10], pair_splat, num_segments=fields.shape[1]
    ).T
    # The depth row (view-z) is a hard mask: no gradient, like the others.
    d_fields = jnp.pad(d10, ((0, fields.shape[0] - 10), (0, 0)))
    return (
        d_fields,
        _int0(pair_splat),
        _int0(tile_start),
        _int0(tile_count),
        _int0(offsets),
        None if bg_depth is None else jnp.zeros_like(bg_depth),
    )


composite_splats.defvjp(_cs_fwd, _cs_bwd)


def unpack_image(tiles: jnp.ndarray, nty: int, ntx: int, height: int,
                 width: int) -> jnp.ndarray:
    """(T, 4, NPIX) tiles → (H, W, 4) image."""
    x = tiles.reshape(nty, ntx, 4, TILE, TILE).transpose(0, 3, 1, 4, 2)
    return x.reshape(nty * TILE, ntx * TILE, 4)[:height, :width]
