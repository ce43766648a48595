"""Reference (oracle) rasterizer: unfused, per-pixel, runs anywhere.

A direct, *independent* transcription of the reference's GPU pipeline
(SURVEY.md §3.5) as a single differentiable ``lax.scan`` over splats in
global depth order:

  * sort: ascending squared world distance to camera — the reference's CPU
    argsort (``gsplat_plugin/src/GSplatRenderer.C:176-216``);
  * fragment: quad-basis coordinates (qx, qy) with footprint |q|≤2, falloff
    ``α = exp(−(qx²+qy²))·opacity`` clamped then cut at 1/255
    (``shaders/GSplatShaderSource.h:304-311`` + quad extent ±2 from
    ``:168-188``);
  * blend: front-to-back "under" operator — GL blendfunc
    (ONE_MINUS_DST_ALPHA, ONE) — ``C += rgb·α·(1−A); A += α·(1−A)``
    (``src/GSplatRenderer.C:615-621``), premultiplied output.

O(N·H·W) — this is the ground truth for image and gradient tests
(BASELINE.json config 1), not a production path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.camera import Camera
from ..models.splats import GaussianSplats
from ..utils.config import RenderConfig
from .covariance import ALPHA_CUTOFF, QUAD_EXTENT
from .projection import (
    N_FIELDS,
    ROW_DEPTH,
    ROW_VALID,
    ProjectedSplats,
    project_splats,
)

# Benign per-field replacement values for invalid (behind-camera) splats:
# far-offscreen center, unit quad basis, zero color/opacity, +inf depth.
# NumPy, not jnp: importing the module must not touch a device.
import numpy as _np

_BENIGN = _np.array(
    [-1e7, -1e7, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, _np.inf, 0.0, 0.0, 0.0, 0.0, 0.0],
    dtype=_np.float32,
)


def sanitize_projected(p: ProjectedSplats) -> ProjectedSplats:
    """Replace invalid (behind-camera) splats' payload with benign values so
    masked-out lanes can't contribute NaN/Inf to primals or gradients."""
    valid = p.fields[ROW_VALID : ROW_VALID + 1] > 0.5
    fields = jnp.where(valid, p.fields, _BENIGN[:, None])
    return ProjectedSplats(fields=fields)


@jax.custom_vjp
def round_bf16(x: jnp.ndarray) -> jnp.ndarray:
    """f32 → bf16-rounded f32 by integer round-to-nearest-even on the bit
    pattern, with a straight-through gradient (the one
    ``astype(bf16).astype(f32)`` has).  Integer ops cannot be dropped by an
    optimizer allowed excess precision, which may remove a convert pair; the
    same helper quantizes every backend, so cross-backend parity holds bit
    for bit.  Exact for finite inputs below 2^127 (the sanitize contract)."""
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    lsb = jax.lax.shift_right_logical(bits, 16) & 1
    rounded = (bits + 0x7FFF + lsb) & jnp.int32(-65536)
    return jax.lax.bitcast_convert_type(rounded, jnp.float32)


round_bf16.defvjp(lambda x: (round_bf16(x), None), lambda _, g: (g,))


def quantize_payload(p: ProjectedSplats, config) -> ProjectedSplats:
    """Apply the configured payload precision policy (the reference's fp16
    storage analogue, ``include/GR_GSplat.h:120-127``): round the 10
    compositor payload rows to ``config.payload_dtype``, keeping the
    geometry rows (depth key, validity, footprint) fp32.  Applied uniformly
    in every backend so cross-backend parity is preserved under quantization.

    ``"packed"`` rounds only the color+opacity rows (6..9) to bf16, keeping
    the geometric rows (center, quad basis) f32 — the reference's own
    storage split (see RenderConfig docs)."""
    if config.payload_dtype == "float32":
        return p
    dt = jnp.bfloat16
    if config.payload_dtype == "packed":
        q = round_bf16(p.fields[6:10])
        return ProjectedSplats(
            fields=jnp.concatenate([p.fields[:6], q, p.fields[10:]], axis=0)
        )
    q = p.fields[:10].astype(dt).astype(jnp.float32)
    return ProjectedSplats(fields=jnp.concatenate([q, p.fields[10:]], axis=0))


def splat_alpha_image(
    cx, cy, ax, ay, bx, by, opacity, px, py, max_alpha, soft_cutoff=False
):
    """Per-pixel alpha of one splat over a pixel grid.

    (ax, ay) = v1/|v1|², (bx, by) = v2/|v2|² — the quad-basis rows, so
    ``qx = d·A, qy = d·B``.  With ``soft_cutoff=False`` applies the
    reference's quad-extent mask and 1/255 discard.
    """
    dx = px - cx
    dy = py - cy
    qx = dx * ax + dy * ay
    qy = dx * bx + dy * by
    power = qx * qx + qy * qy
    alpha = jnp.clip(jnp.exp(-power) * opacity, 0.0, max_alpha)
    if soft_cutoff:
        return alpha
    inside = (jnp.abs(qx) <= QUAD_EXTENT) & (jnp.abs(qy) <= QUAD_EXTENT)
    keep = inside & (alpha >= ALPHA_CUTOFF)
    return jnp.where(keep, alpha, 0.0)


def composite_reference(
    projected: ProjectedSplats,
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
    bg_depth: jnp.ndarray = None,
) -> jnp.ndarray:
    """Depth-sort + front-to-back composite.  Returns (H, W, 4) premultiplied
    RGBA (alpha channel = 1 − final transmittance).

    ``bg_depth``: optional (H, W) view-space scene depth — splat
    contributions behind it are killed per pixel (the reference's z-tested
    beauty pass, ``src/GSplatRenderer.C:595-610``)."""
    p = sanitize_projected(projected)
    order = jnp.argsort(p.fields[ROW_DEPTH])
    rows = p.fields[:, order].T  # (N, 16) — scan carries per-splat rows

    ys = (jnp.arange(height, dtype=jnp.float32) + 0.5)[:, None]
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5)[None, :]
    px = jnp.broadcast_to(xs, (height, width))
    py = jnp.broadcast_to(ys, (height, width))

    def step(carry, row):
        color_acc, transmittance = carry
        alpha = splat_alpha_image(
            row[0], row[1], row[2], row[3], row[4], row[5], row[9],
            px, py, config.max_alpha, config.soft_cutoff,
        )
        if bg_depth is not None:
            alpha = jnp.where(row[14] <= bg_depth, alpha, 0.0)
        weight = alpha * transmittance
        color_acc = color_acc + weight[..., None] * row[6:9]
        transmittance = transmittance * (1.0 - alpha)
        return (color_acc, transmittance), None

    init = (
        jnp.zeros((height, width, 3), dtype=jnp.float32),
        jnp.ones((height, width), dtype=jnp.float32),
    )
    (color, transmittance), _ = jax.lax.scan(step, init, rows)
    return jnp.concatenate([color, (1.0 - transmittance)[..., None]], axis=-1)


def render_reference(
    splats: GaussianSplats,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    bg_depth: jnp.ndarray = None,
) -> jnp.ndarray:
    """End-to-end oracle render: project → sort → composite.  (H, W, 4)."""
    projected = project_splats(splats, camera, config.sh_order, only_sh=config.only_sh)
    projected = quantize_payload(projected, config)
    return composite_reference(
        projected, camera.width, camera.height, config, bg_depth=bg_depth
    )
