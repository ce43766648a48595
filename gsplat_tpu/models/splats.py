"""Gaussian-splat scene data model.

The replacement for the reference's geometry layers: the custom
``GEO_PrimGsplat`` GA primitive (``gsplat_plugin/src/GEO_GSplat.C:413-431``)
and the ``GSplatSource`` SOP that wraps points into it
(``gsplat_plugin/src/SOP_GSplat.C:93-117``).  Instead of a GA attribute
table, a splat cluster is a JAX pytree of plain arrays — shardable with
``jax.sharding``, differentiable, and directly consumable by jitted render
functions.

**Layout: transposed structure-of-arrays.**  Components on the leading
axis and splats on the last (contiguous) axis, so every per-component
elementwise chain over all splats reads contiguous memory and fuses:

* ``pos``      (3, N)  float32 — world positions (``P``).
* ``orient``   (4, N)  — quaternion in **xyzw** component order (``orient``).
* ``scale``    (3, N)  — per-axis standard deviations (``scale``).
* ``opacity``  (N,)    — post-sigmoid opacity (``opacity`` | ``Alpha``).
* ``color``    (3, N)  — DC base color, ``sh0·SH_C0 + 0.5`` pre-baked (``Cd``).
* ``sh``       (45, N) — band 1-3 SH coefficients; row ``3·j + c`` is
  coefficient ``sh{j+1}`` channel ``c`` (``sh1.r, sh1.g, sh1.b, sh2.r, …``).

Constructors accept the user-facing per-splat conventions ((N, 3) arrays,
(N, 15, 3) SH — the reference's attribute shapes) and transpose host-side.

Missing-attribute defaults mirror the reference's degrade-don't-crash policy
(``src/GR_GSplat.C:309-312``): color (0,0,0), opacity 1, unit scale, identity
orientation, zero SH.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

SH_REST_COEFFS = 15  # bands 1..3 (3DGS degree-3)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GaussianSplats:
    """A cluster of N Gaussian splats (the pytree analogue of one GSplat prim)."""

    pos: jax.Array       # (3, N)
    orient: jax.Array    # (4, N) xyzw
    scale: jax.Array     # (3, N)
    opacity: jax.Array   # (N,)
    color: jax.Array     # (3, N)
    sh: jax.Array        # (45, N)

    @property
    def count(self) -> int:
        return self.pos.shape[-1]

    def astype(self, dtype) -> "GaussianSplats":
        """Cast all fields except positions (kept fp32, mirroring the
        reference's precision policy: pos fp32, rest fp16 —
        ``include/GR_GSplat.h:120-127``)."""
        return GaussianSplats(
            pos=self.pos,
            orient=self.orient.astype(dtype),
            scale=self.scale.astype(dtype),
            opacity=self.opacity.astype(dtype),
            color=self.color.astype(dtype),
            sh=self.sh.astype(dtype),
        )

    def validate(self) -> "GaussianSplats":
        """Shape validation (the checking the reference SOP skips — "Assume
        all points are good", ``src/GEO_GSplat.C:417-418``)."""
        n = self.pos.shape[-1]
        expect = {
            "pos": (3, n),
            "orient": (4, n),
            "scale": (3, n),
            "opacity": (n,),
            "color": (3, n),
            "sh": (3 * SH_REST_COEFFS, n),
        }
        for name, shape in expect.items():
            got = getattr(self, name).shape
            if got != shape:
                raise ValueError(f"GaussianSplats.{name}: expected shape {shape}, got {got}")
        return self

    def concat(self, other: "GaussianSplats") -> "GaussianSplats":
        """Concatenate two clusters (the reference's multi-detail aggregation,
        ``src/GSplatRenderer.C:420-447``)."""
        return jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=-1), self, other
        )

    def head(self, n: int) -> "GaussianSplats":
        """First ``n`` splats (the reference's partial-cluster budget clamp:
        the cluster crossing GSplatCountMax still contributes its leading
        splats, ``src/GSplatRenderer.C:364-366``)."""
        return jax.tree.map(lambda a: a[..., :n], self)

    def barycenter(self) -> jax.Array:
        """Mean position, (3,) (``GEO_PrimGsplat::baryCenter``,
        ``src/GEO_GSplat.C:339-351``)."""
        return jnp.mean(self.pos, axis=-1)

    def bbox(self):
        """(min, max) corners, each (3,) (``getBBox``, ``src/GEO_GSplat.C:327-336``)."""
        return jnp.min(self.pos, axis=-1), jnp.max(self.pos, axis=-1)

    # -------- user-facing per-splat views (row layouts; test/IO convenience)
    @property
    def pos_n3(self) -> jax.Array:
        return self.pos.T

    @property
    def orient_n4(self) -> jax.Array:
        return self.orient.T

    @property
    def scale_n3(self) -> jax.Array:
        return self.scale.T

    @property
    def color_n3(self) -> jax.Array:
        return self.color.T

    @property
    def sh_n153(self) -> jax.Array:
        n = self.count
        return self.sh.T.reshape(n, SH_REST_COEFFS, 3)


def _to_soa(a, width, name, dtype) -> np.ndarray:
    """(N, width) or (width, N) → (width, N), host-side."""
    arr = np.asarray(a, dtype=dtype)
    if arr.ndim != 2:
        raise ValueError(f"{name}: expected 2-D, got {arr.shape}")
    if arr.shape[0] == width and arr.shape[1] != width:
        return arr
    if arr.shape[1] == width:
        return np.ascontiguousarray(arr.T)
    if arr.shape[0] == width:  # ambiguous square-ish; assume already SoA
        return arr
    raise ValueError(f"{name}: expected (N, {width}) or ({width}, N), got {arr.shape}")


def make_splats(
    pos: Any,
    orient: Optional[Any] = None,
    scale: Optional[Any] = None,
    opacity: Optional[Any] = None,
    color: Optional[Any] = None,
    sh: Optional[Any] = None,
    dtype=jnp.float32,
) -> GaussianSplats:
    """Build a validated :class:`GaussianSplats` from per-splat (N, ·) arrays
    (or pre-transposed SoA), filling reference defaults for missing
    attributes (``src/GR_GSplat.C:309-312``)."""
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    pos = _to_soa(pos, 3, "pos", np.float32)
    n = pos.shape[-1]
    if orient is None:
        orient = np.zeros((4, n), np_dtype)
        orient[3] = 1.0
    else:
        orient = _to_soa(orient, 4, "orient", np_dtype)
    scale = np.ones((3, n), np_dtype) if scale is None else _to_soa(scale, 3, "scale", np_dtype)
    if opacity is None:
        opacity = np.ones((n,), np_dtype)
    else:
        opacity = np.asarray(opacity, dtype=np_dtype).reshape(n)
    color = np.zeros((3, n), np_dtype) if color is None else _to_soa(color, 3, "color", np_dtype)
    if sh is None:
        sh = np.zeros((3 * SH_REST_COEFFS, n), np_dtype)
    else:
        sh_arr = np.asarray(sh, dtype=np_dtype)
        if sh_arr.shape == (n, SH_REST_COEFFS, 3):
            sh = np.ascontiguousarray(sh_arr.reshape(n, 3 * SH_REST_COEFFS).T)
        elif sh_arr.shape == (3 * SH_REST_COEFFS, n):
            sh = sh_arr
        else:
            raise ValueError(
                f"sh: expected (N, 15, 3) or (45, N), got {sh_arr.shape}"
            )
    return GaussianSplats(
        pos=jnp.asarray(pos),
        orient=jnp.asarray(orient),
        scale=jnp.asarray(scale),
        opacity=jnp.asarray(opacity),
        color=jnp.asarray(color),
        sh=jnp.asarray(sh),
    ).validate()


def random_splats(
    key: jax.Array,
    n: int,
    extent: float = 1.0,
    scale_range=(0.01, 0.08),
    sh_scale: float = 0.0,
    dtype=jnp.float32,
) -> GaussianSplats:
    """Synthetic-scene generator for tests and benchmarks."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    pos = jax.random.uniform(k1, (3, n), minval=-extent, maxval=extent)
    quat = jax.random.normal(k2, (4, n))
    quat = quat / jnp.linalg.norm(quat, axis=0, keepdims=True)
    scale = jax.random.uniform(k3, (3, n), minval=scale_range[0], maxval=scale_range[1])
    opacity = jax.random.uniform(k4, (n,), minval=0.3, maxval=1.0)
    color = jax.random.uniform(k5, (3, n), minval=0.0, maxval=1.0)
    sh = sh_scale * jax.random.normal(k6, (3 * SH_REST_COEFFS, n))
    return GaussianSplats(
        pos=pos.astype(jnp.float32),
        orient=quat.astype(dtype),
        scale=scale.astype(dtype),
        opacity=opacity.astype(dtype),
        color=color.astype(dtype),
        sh=sh.astype(dtype),
    ).validate()


def trained_like_splats(
    key: jax.Array,
    n: int,
    extent: float = 1.2,
    sh_scale: float = 0.1,
    dtype=jnp.float32,
) -> GaussianSplats:
    """Synthetic scene matched to TRAINED 3DGS statistics — the heavy-tailed
    distributions ``random_splats``' uniform draws lack (BASELINE config 3:
    "captured scene"):

    * log-normal anisotropic scales: most splats tiny, a rare large tail,
      per-axis anisotropy up to ~10× (needle/disc splats) — exercises the
      SAT cull and the tile-capacity tail;
    * sigmoid-of-normal opacities: a large near-transparent population
      (trained scenes keep thousands of barely-visible splats the 1/255
      discard then kills) plus a solid opaque mode;
    * Gaussian-mixture positions: splats cluster on surfaces, not uniform
      in the volume — center-heavy tile loads and depth clustering, the
      distributions the budget/capacity autotuners must survive.

    Activation-space outputs (same convention as :func:`load_ply`'s result).
    """
    k1, k2, k3, k4, k5, k6, k7, k8 = jax.random.split(key, 8)
    # positions: 12 anisotropic Gaussian clusters within the extent
    n_clusters = 12
    centers = jax.random.uniform(
        k1, (3, n_clusters), minval=-0.7 * extent, maxval=0.7 * extent
    )
    widths = jnp.exp(jax.random.uniform(
        k2, (3, n_clusters),
        minval=jnp.log(0.05 * extent), maxval=jnp.log(0.45 * extent),
    ))
    cid = jax.random.randint(k3, (n,), 0, n_clusters)
    pos = centers[:, cid] + widths[:, cid] * jax.random.normal(k4, (3, n))
    quat = jax.random.normal(k5, (4, n))
    quat = quat / jnp.linalg.norm(quat, axis=0, keepdims=True)
    # log-normal scales, median ~0.004·extent, heavy upper tail, per-axis
    # anisotropy via independent per-axis log-noise
    base = jnp.exp(jnp.log(0.004 * extent) + 0.9 * jax.random.normal(k6, (1, n)))
    aniso = jnp.exp(0.8 * jax.random.normal(k7, (3, n)))
    scale = jnp.clip(base * aniso, 1e-5, 0.3 * extent)
    ko1, ko2, kc, ks = jax.random.split(k8, 4)
    opacity = jax.nn.sigmoid(1.2 * jax.random.normal(ko1, (n,)) - 0.3)
    color = jnp.clip(
        0.5 + 0.25 * jax.random.normal(kc, (3, n)), 0.0, 1.0
    )
    sh = sh_scale * jax.random.normal(ks, (3 * SH_REST_COEFFS, n))
    return GaussianSplats(
        pos=pos.astype(jnp.float32),
        orient=quat.astype(dtype),
        scale=scale.astype(dtype),
        opacity=opacity.astype(dtype),
        color=color.astype(dtype),
        sh=sh.astype(dtype),
    ).validate()


def to_numpy_dict(splats: GaussianSplats) -> Dict[str, np.ndarray]:
    """Per-splat (N, ·) numpy dict (user-facing row conventions)."""
    return {
        "pos": np.asarray(splats.pos_n3),
        "orient": np.asarray(splats.orient_n4),
        "scale": np.asarray(splats.scale_n3),
        "opacity": np.asarray(splats.opacity),
        "color": np.asarray(splats.color_n3),
        "sh": np.asarray(splats.sh_n153),
    }
