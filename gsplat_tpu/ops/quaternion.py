"""Quaternion → rotation/scale matrix ops.

Re-implementation of the reference GLSL
``CalcMatrixFromRotationScale`` (``gsplat_plugin/shaders/GSplatShaderCoreLib.h:10-27``).

Conventions (faithful to the reference, which stores quaternions in the
Houdini ``orient`` point attribute as (x, y, z, w) and passes ``orient.wxyz``
into the shader):

* Public API takes quaternions in **xyzw** component order (the ``orient``
  attribute convention).
* The produced matrix is ``M = S · R`` where ``S = diag(scale)`` and ``R`` is
  the reference's rotation matrix.  Note the reference's ``R`` is the
  *transpose* of the textbook rotation matrix for quat (w,x,y,z); since the
  3D covariance is ``Σ = MᵀM = Rᵀ S² R`` this still yields the standard 3DGS
  covariance, and we transcribe the exact element layout so axes match
  bit-for-bit.

All functions are vectorised over a leading batch dimension and jit/vmap/grad
friendly.
"""

from __future__ import annotations

import jax.numpy as jnp


def quat_to_rotmat_wxyz(qw, qx, qy, qz):
    """Rotation matrix used by the reference shader, from scalar-first parts.

    Mirrors the column-major GLSL constructor at
    ``GSplatShaderCoreLib.h:21-25`` (there ``rot = (w,x,y,z)``).  Returns an
    array of shape ``(..., 3, 3)`` laid out so that ``M[..., i, j]`` is row
    ``i``, column ``j`` of the matrix the GLSL code builds.
    """
    one = jnp.ones_like(qw)
    # GLSL mat3(c0, c1, c2) is column-major; transcribe columns then stack as
    # rows of the transposed layout: row_i[j] = col_j[i].
    r00 = one - 2.0 * (qy * qy + qz * qz)
    r10 = 2.0 * (qx * qy - qw * qz)
    r20 = 2.0 * (qx * qz + qw * qy)
    r01 = 2.0 * (qx * qy + qw * qz)
    r11 = one - 2.0 * (qx * qx + qz * qz)
    r21 = 2.0 * (qy * qz - qw * qx)
    r02 = 2.0 * (qx * qz - qw * qy)
    r12 = 2.0 * (qy * qz + qw * qx)
    r22 = one - 2.0 * (qx * qx + qy * qy)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rotation_scale_matrix(orient_xyzw: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    """``M = S · R`` per the reference (``GSplatShaderCoreLib.h:10-27``).

    Args:
      orient_xyzw: ``(..., 4)`` quaternion in xyzw order (Houdini ``orient``).
      scale: ``(..., 3)`` per-axis scales.

    Returns:
      ``(..., 3, 3)`` matrix such that ``Σ = MᵀM`` is the splat's 3D
      covariance.
    """
    qx, qy, qz, qw = (orient_xyzw[..., i] for i in range(4))
    r = quat_to_rotmat_wxyz(qw, qx, qy, qz)
    # S·R with S diagonal = scale rows of R.
    return r * scale[..., :, None]


def covariance_3d(orient_xyzw: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    """3D covariance ``Σ = MᵀM`` (``GSplatShaderCoreLib.h:29-35``).

    Expanded elementwise (not einsum) so XLA emits identical per-splat float
    ops for any array shape — required for multi-device bit-parity with
    single-device renders (see ``ops/projection.py``).
    """
    m = rotation_scale_matrix(orient_xyzw, scale)
    rows = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            acc = m[..., 0, i] * m[..., 0, j]
            for k in (1, 2):
                acc = acc + m[..., k, i] * m[..., k, j]
            rows[i][j] = acc
            rows[j][i] = acc
    return jnp.stack(
        [jnp.stack(r, axis=-1) for r in rows],
        axis=-2,
    )
