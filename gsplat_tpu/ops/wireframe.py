"""Wireframe debug rendering: splat quad outlines.

The analogue of the reference's wireframe path — 8 verts per splat forming a
line quad at the ±2 footprint extent in the (v1, v2) eigen basis, drawn flat
in the splat's base color (``gsplat_plugin/src/GR_GSplat.C:376-421``,
``shaders/GSplatShaderSource.h:22-110``).  Here: a per-pixel band test on the
quad-basis coordinates — pixels within ~``line_px`` of the quad edge take the
splat's color; nearest splat wins (opaque lines, like GL depth-tested lines).

Backends:
  * ``"pallas"`` — the fused compositing kernel in wireframe mode (an opaque
    band test replaces the Gaussian falloff; front-to-back + early stop =
    nearest-splat-wins) riding the same binning/sort as the beauty pass —
    interactive at reference scale.  ``"auto"`` picks it on a GPU.
  * ``"reference"`` — O(N·H·W) per-pixel scan (the debug oracle); ``"auto"``
    picks it on the CPU, where the beauty pass would use ``tiles`` (the
    ``tiles`` compositor has no band test).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..models.camera import Camera
from ..models.splats import GaussianSplats
from ..ops.covariance import QUAD_EXTENT
from ..ops.projection import ROW_HX, ROW_HY, ROW_OP, ROW_VALID, project_splats
from ..ops.rasterize_ref import sanitize_projected
from ..ops.rasterize_tiles import sort_by_depth
from ..utils.config import RenderConfig
from ..utils.platform import resolve_backend


def render_wireframe(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    line_px: float = 1.0,
    background=None,
    backend: str = "auto",
    interpret: bool = False,
) -> jnp.ndarray:
    """Render quad outlines.  Returns (H, W, 4); alpha 1 where a line covers."""
    backend = resolve_backend(backend)
    if backend == "tiles":
        backend = "reference"
    if backend in ("pallas", "pallas_interpret"):
        return _wireframe_pallas(
            splats, camera, config, line_px, background,
            interpret or backend == "pallas_interpret",
        )
    if backend != "reference":
        raise ValueError(f"unknown wireframe backend {backend!r}")
    p = sort_by_depth(sanitize_projected(project_splats(splats, camera, 0)))
    rows = p.fields.T  # (N, 16)

    h, w = camera.height, camera.width
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5)[:, None]
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5)[None, :]
    px = jnp.broadcast_to(xs, (h, w))
    py = jnp.broadcast_to(ys, (h, w))

    def step(carry, row):
        color_acc, covered = carry
        # quad-basis coords from A = v1/|v1|², B = v2/|v2|²: q = d·A, d·B
        dx = px - row[0]
        dy = py - row[1]
        qx = dx * row[2] + dy * row[3]
        qy = dx * row[4] + dy * row[5]
        # |A| = 1/|v1| → band half-width in quad units for ~line_px on screen
        wq1 = line_px * jnp.sqrt(row[2] ** 2 + row[3] ** 2)
        wq2 = line_px * jnp.sqrt(row[4] ** 2 + row[5] ** 2)
        m = jnp.maximum(jnp.abs(qx), jnp.abs(qy))
        wq = jnp.where(jnp.abs(qx) > jnp.abs(qy), wq1, wq2)
        on_edge = (jnp.abs(m - QUAD_EXTENT) <= wq) & (m <= QUAD_EXTENT + wq)
        hit = on_edge & ~covered
        color_acc = jnp.where(hit[..., None], row[6:9], color_acc)
        return (color_acc, covered | on_edge), None

    init = (jnp.zeros((h, w, 3), dtype=jnp.float32), jnp.zeros((h, w), dtype=bool))
    (color, covered), _ = jax.lax.scan(step, init, rows)
    alpha = covered.astype(jnp.float32)
    if background is not None:
        bg = jnp.asarray(background, jnp.float32)
        color = jnp.where(covered[..., None], color, bg)
    return jnp.concatenate([color, alpha[..., None]], axis=-1)


def _wireframe_pallas(
    splats, camera, config, line_px, background, interpret
) -> jnp.ndarray:
    """Wireframe on the production tile pipeline (project → sort → bin →
    fused kernel in band-test mode).  Same nearest-wins image as the oracle:
    an opaque band hit saturates the pixel, so later (farther) splats
    contribute exactly zero."""
    from .binning import bin_splats, tile_grid
    from .pallas.composite import composite_pairs, unpack_image

    if config.tile_h != 32 or config.tile_w != 32:
        raise ValueError("pallas backend requires tile_h == tile_w == 32")
    # Wireframe skips quantize_payload (it rewrites opacity to the validity
    # flag): both wireframe backends run on the unquantized f32 payload.
    cfg = dataclasses.replace(
        config, wireframe=True, line_px=float(line_px),
        payload_dtype="float32", depth_test=False,
    )
    p = sanitize_projected(project_splats(splats, camera, 0))
    f = p.fields
    # The reference draws wireframes regardless of opacity and the band
    # extends ``line_px`` past the ±2 quad: neutralise the opacity cull and
    # grow the binning bbox by the line width.
    f = f.at[ROW_OP].set(f[ROW_VALID])
    f = f.at[ROW_HX].add(line_px)
    f = f.at[ROW_HY].add(line_px)
    p = sort_by_depth(type(p)(fields=f))
    binned = bin_splats(p, camera.width, camera.height, cfg, with_tiles=False)
    nty, ntx = tile_grid(camera.width, camera.height, cfg.tile_h, cfg.tile_w)
    tiles = composite_pairs(
        p.fields[:10, binned.pair_splat],
        binned.tile_start,
        binned.tile_count,
        jnp.zeros((2,), jnp.int32),
        ntx,
        cfg,
        interpret,
    )
    img = unpack_image(tiles, nty, ntx, camera.height, camera.width)
    if background is not None:
        bg = jnp.asarray(background, jnp.float32)
        covered = img[..., 3:4] > 0.5
        img = jnp.concatenate(
            [jnp.where(covered, img[..., :3], bg), img[..., 3:4]], axis=-1
        )
    return img


def render_wire_over(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    line_px: float = 1.0,
    backend: str = "auto",
    interpret: bool = False,
) -> jnp.ndarray:
    """Wire-over-shaded: quad outlines drawn ON TOP of the beauty pass.

    The reference draws the line quads during the native geometry pass and
    the global splat composite then runs with the fixed-function under
    operator ``(ONE_MINUS_DST_ALPHA, ONE)`` — a line pixel enters the blend
    with destination alpha already saturated, so splat contributions are
    scaled by ``1 − wire.a`` there and the lines stay fully visible
    (``gsplat_plugin/src/GR_GSplat.C:474-483`` draws the lines;
    ``src/GSplatRenderer.C:605-647`` composites the splats after).  Exactly
    that algebra: ``out = wire + beauty · (1 − wire.a)``.

    Returns (H, W, 4) premultiplied RGBA.
    """
    backend = resolve_backend(backend)
    wire_backend = "pallas" if backend in ("pallas", "pallas_interpret") else "reference"
    from ..render import render  # local import: render imports wireframe's siblings

    wire = render_wireframe(
        splats, camera, config, line_px=line_px, backend=wire_backend,
        interpret=interpret or backend == "pallas_interpret",
    )
    beauty = render(splats, camera, config, backend=backend)
    return wire + beauty * (1.0 - wire[..., 3:4])
