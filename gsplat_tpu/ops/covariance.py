"""EWA covariance projection and 2×2 eigen-decomposition.

Re-implementation of the reference GLSL core lib:

* ``CalcCovariance2D`` — EWA Splatting (Zwicker et al. 2002) eq. 31 with the
  reference's exact constants: ±1.3·tanFov view-space clamp, focal =
  screenW·P00/2, and a +0.3 px low-pass dilation on the 2D covariance
  diagonal (``gsplat_plugin/shaders/GSplatShaderCoreLib.h:38-76``).
* ``DecomposeCovariance`` — closed-form 2×2 eigen decomposition producing the
  pixel-space splat axes: λ₂ ≥ 0.1, axis length √(2λ) capped at 4096 px, with
  the built-in y-flip into image (y-down) coordinates
  (``GSplatShaderCoreLib.h:79-93``).

Everything is vectorised over a leading splat dimension and differentiable;
the clamps are non-differentiable kinks where JAX's subgradient semantics
apply (matching "stop-gradient at clamp").
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# Reference constants (file:line cited above).
FOV_CLAMP = 1.3          # view-space frustum clamp multiplier
COV2D_DILATION = 0.3     # low-pass filter: min ~1px splat size
LAMBDA2_MIN = 0.1        # min minor eigenvalue
AXIS_MAX_PX = 4096.0     # max axis length in pixels
QUAD_EXTENT = 2.0        # quad spans ±2 units in the (v1, v2) eigen basis
ALPHA_CUTOFF = 1.0 / 255.0  # fragment discard threshold


def ewa_project(
    world_pos: jnp.ndarray,
    cov3d: jnp.ndarray,
    view: jnp.ndarray,
    proj: jnp.ndarray,
    screen_w: float,
) -> jnp.ndarray:
    """Project 3D covariances to 2D screen-space covariances (EWA eq. 31).

    Args:
      world_pos: ``(N, 3)`` splat centers in world space.
      cov3d: ``(N, 3, 3)`` symmetric 3D covariances.
      view: ``(4, 4)`` world→view matrix (OpenGL convention, camera looks
        down −z).
      proj: ``(4, 4)`` OpenGL perspective projection matrix.
      screen_w: screen width in pixels (the reference derives focal from the
        *width* only: ``focal = screenSize.x * matrixP[0][0] / 2``).

    Returns:
      ``(N, 3)`` packed 2D covariance ``(cov_xx, cov_xy, cov_yy)`` including
      the +0.3 dilation, in *view-aligned* screen coordinates (y-up; the
      y-flip into image space happens in :func:`decompose_covariance`).
    """
    p00 = proj[0, 0]
    p11 = proj[1, 1]
    # Faithful transcription of GSplatShaderCoreLib.h:44-49 — note that the
    # reference's tanFovY algebraically equals tanFovX (tanFovY =
    # 1/(P11·(P00/P11)) = 1/P00); we reproduce that behaviour exactly.
    aspect = p00 / p11
    tan_fov_x = 1.0 / p00
    tan_fov_y = 1.0 / (p11 * aspect)
    lim_x = FOV_CLAMP * tan_fov_x
    lim_y = FOV_CLAMP * tan_fov_y

    # Explicit broadcast arithmetic (not matmul) for shard-shape-independent
    # codegen — multi-device bit-parity (see ops/projection.py).
    view_pos = (
        world_pos[..., 0:1] * view[:3, 0]
        + world_pos[..., 1:2] * view[:3, 1]
        + world_pos[..., 2:3] * view[:3, 2]
        + view[:3, 3]
    )
    # Visible points have vz < 0 (GL looks down −z).  Clamp vz away from 0 so
    # behind-camera splats (masked out downstream, like the reference's w≤0
    # transparent branch at GSplatShaderSource.h:209-214) produce finite
    # values instead of Inf/NaN that would poison gradients through `where`.
    vz = jnp.minimum(view_pos[..., 2], -1e-6)
    vx = jnp.clip(view_pos[..., 0] / vz, -lim_x, lim_x) * vz
    vy = jnp.clip(view_pos[..., 1] / vz, -lim_y, lim_y) * vz

    focal = screen_w * p00 / 2.0

    # cov2d = J · (Rᵥ Σ Rᵥᵀ) · Jᵀ with the standard EWA Jacobian
    # J = [[f/z, 0, −f·x/z²], [0, f/z, −f·y/z²]].  Expanded elementwise (no
    # einsum/matmul) so XLA emits identical per-splat float ops regardless of
    # shard shape — multi-device bit-parity (see ops/projection.py).
    rv = view[:3, :3]
    # tmp[k][j] = Σ_l rv[j,l]·Σ[k,l]  →  C[i][j] = Σ_k rv[i,k]·tmp[k][j]
    tmp = [[None] * 3 for _ in range(3)]
    for k in range(3):
        for j in range(3):
            acc = rv[j, 0] * cov3d[..., k, 0]
            acc = acc + rv[j, 1] * cov3d[..., k, 1]
            acc = acc + rv[j, 2] * cov3d[..., k, 2]
            tmp[k][j] = acc
    c = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            c[i][j] = (
                rv[i, 0] * tmp[0][j] + rv[i, 1] * tmp[1][j] + rv[i, 2] * tmp[2][j]
            )

    inv_z = 1.0 / vz
    a = focal * inv_z
    gx = -focal * vx * inv_z * inv_z
    gy = -focal * vy * inv_z * inv_z
    # u0 = (a, 0, gx), u1 = (0, a, gy):  cov2d_mn = u_m · C · u_n
    cu0 = [a * c[i][0] + gx * c[i][2] for i in range(3)]
    cu1 = [a * c[i][1] + gy * c[i][2] for i in range(3)]
    cxx = a * cu0[0] + gx * cu0[2] + COV2D_DILATION
    cxy = a * cu1[0] + gx * cu1[2]
    cyy = a * cu1[1] + gy * cu1[2] + COV2D_DILATION
    return jnp.stack([cxx, cxy, cyy], axis=-1)


def decompose_covariance(cov2d: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """2×2 eigen decomposition → pixel-space axes (``GSplatShaderCoreLib.h:79-93``).

    Args:
      cov2d: ``(N, 3)`` packed ``(a, b, c)`` = (cov_xx, cov_xy, cov_yy).

    Returns:
      ``(v1, v2)``: each ``(N, 2)`` axis vectors in image space (x right,
      y **down** — the reference bakes the y-flip into the eigenvector), with
      lengths ``min(√(2λᵢ), 4096)`` and λ₂ clamped to ≥ 0.1.  The rendered
      quad spans ``±QUAD_EXTENT`` in this (v1, v2) basis.
    """
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    mid = 0.5 * (a + c)
    # sqrt has an infinite derivative at 0 (exactly-isotropic covariance);
    # clamp the radicand so degenerate splats get a ~0 subgradient instead of
    # NaN (the eigen direction is genuinely undefined there).
    radius_sq = jnp.square((a - c) / 2.0) + jnp.square(b)
    radius = jnp.sqrt(jnp.maximum(radius_sq, 1e-18))
    lambda1 = mid + radius
    lambda2 = jnp.maximum(mid - radius, LAMBDA2_MIN)
    # normalize(vec2(b, λ1 − a)) with a grad-safe divide (GLSL normalize
    # yields garbage on the zero vector; we pick (1, 0) — the isotropic case
    # where any orthonormal basis is equivalent).
    ex = b
    ey = lambda1 - a
    norm_sq = ex * ex + ey * ey
    safe = norm_sq > 1e-24
    inv_norm = jnp.where(safe, jax.lax.rsqrt(jnp.where(safe, norm_sq, 1.0)), 0.0)
    dx = jnp.where(safe, ex * inv_norm, 1.0)
    dy = jnp.where(safe, ey * inv_norm, 0.0)
    dy = -dy  # image-space y-flip (GSplatShaderCoreLib.h:89)
    len1 = jnp.minimum(jnp.sqrt(2.0 * lambda1), AXIS_MAX_PX)
    len2 = jnp.minimum(jnp.sqrt(2.0 * lambda2), AXIS_MAX_PX)
    v1 = jnp.stack([len1 * dx, len1 * dy], axis=-1)
    v2 = jnp.stack([len2 * dy, -len2 * dx], axis=-1)
    return v1, v2
