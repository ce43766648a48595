"""Camera model.

The reference receives its camera implicitly through Houdini's GL uniforms
(``glH_ViewMatrix``, ``glH_ProjectMatrix``, ``glH_ScreenSize`` —
``gsplat_plugin/shaders/GSplatShaderSource.h:153-159``) and derives the
world-space camera position by inverting the view matrix unless the
``gsplat__explicit_camera_pos`` detail attribute overrides it
(``src/GSplatRenderer.C:551-563``).  Here the camera is an explicit pytree.

Conventions (OpenGL, matching the reference's uniforms):
  * ``view``: (4,4) world→view; camera looks down −z in view space.
  * ``proj``: (4,4) perspective projection; ``proj[0,0] = 1/tan(fovx/2)``.
  * Image coordinates: x right, y **down**, pixel centers at (i+0.5, j+0.5).
    NDC→pixel: ``px = (ndc.x+1)/2·W``, ``py = (1−ndc.y)/2·H`` — identical to
    the net effect of the reference's flip-y dance
    (``GSplatShaderSource.h:204,281``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera pytree.

    Matrix leaves are **host (numpy) arrays by default**: a jitted function
    that *closes over* a device array forces a device→host constant fetch.
    Numpy leaves bake into the executable as literals when closed over, and
    are device_put like any argument when passed as jit args — both fast
    paths.  Traced/device cameras (e.g. built inside a
    training step) work identically.
    """

    view: jax.Array                    # (4, 4) world → view
    proj: jax.Array                    # (4, 4) view → clip
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    # Optional world-space camera-position override for sorting + SH
    # (the reference's gsplat__explicit_camera_pos detail attribute,
    # src/GR_GSplat.C:277-282).  NaNs mean "derive from view matrix".
    explicit_camera_pos: jax.Array = dataclasses.field(
        default_factory=lambda: np.full((3,), np.nan, dtype=np.float32)
    )

    @property
    def position(self) -> jax.Array:
        """World-space camera position: explicit override if set, else
        ``−Rᵀ·t`` from the view matrix (``src/GSplatRenderer.C:551-563``)."""
        derived = -self.view[:3, :3].T @ self.view[:3, 3]
        use_explicit = jnp.all(~jnp.isnan(self.explicit_camera_pos))
        explicit = jnp.nan_to_num(self.explicit_camera_pos)
        return jnp.where(use_explicit, explicit, derived)


def perspective(fov_y_deg: float, width: int, height: int, near: float = 0.01, far: float = 100.0) -> np.ndarray:
    """Standard OpenGL perspective projection matrix."""
    aspect = width / height
    f = 1.0 / np.tan(np.radians(fov_y_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World→view matrix, camera at ``eye`` looking at ``target`` (GL style)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = right
    m[1, :3] = true_up
    m[2, :3] = -fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def make_camera(
    eye,
    target,
    width: int,
    height: int,
    fov_y_deg: float = 45.0,
    up=(0.0, 1.0, 0.0),
    near: float = 0.01,
    far: float = 100.0,
) -> Camera:
    return Camera(
        view=look_at(eye, target, up),
        proj=perspective(fov_y_deg, width, height, near, far),
        width=int(width),
        height=int(height),
    )
