"""Geometric queries on splat clusters.

Equivalents of the reference primitive's geometry methods:

* ``GEO_PrimGsplat::getBBox``      (``gsplat_plugin/src/GEO_GSplat.C:327-336``)
  → :meth:`gsplat_tpu.models.splats.GaussianSplats.bbox`
* ``GEO_PrimGsplat::baryCenter``   (``:339-351``)
  → :meth:`GaussianSplats.barycenter`
* ``GEO_PrimGsplat::intersectRay`` (``:546-562``) — slab-test of the ray
  against the cluster's axis-aligned point bounding box, returning the hit
  distance/position like ``UT_BoundingBox::intersectRay``
  → :func:`intersect_ray_bbox` (and the batched :func:`intersect_rays_bbox`
  for picking many rays at once, which the serial HDK API cannot do).

Like the reference, the bbox covers splat *centers* only (the reference
ignores each splat's own radius too, ``getBBox`` iterates ``getPos3``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.splats import GaussianSplats


class RayHit(NamedTuple):
    """Result of a ray/bbox query (all entries traced arrays)."""

    hit: jax.Array       # () or (R,) bool
    distance: jax.Array  # () or (R,) f32 — entry distance along the ray (≥0)
    pos: jax.Array       # (3,) or (R, 3) f32 — org + distance·dir


def _slab_test(bb_lo, bb_hi, org, dir_, tmax):
    """Vectorized slab test.  org/dir (…, 3); returns (hit, t_entry)."""
    parallel = jnp.abs(dir_) <= 1e-30
    inv = 1.0 / jnp.where(parallel, 1.0, dir_)
    t0 = (bb_lo - org) * inv
    t1 = (bb_hi - org) * inv
    lo_t = jnp.minimum(t0, t1)
    hi_t = jnp.maximum(t0, t1)
    # A parallel axis passes iff the origin lies inside its slab: the slab
    # then constrains t not at all (−inf, +inf); otherwise it can never be
    # entered (+inf, −inf).
    inside = (org >= bb_lo) & (org <= bb_hi)
    lo_t = jnp.where(parallel, jnp.where(inside, -jnp.inf, jnp.inf), lo_t)
    hi_t = jnp.where(parallel, jnp.where(inside, jnp.inf, -jnp.inf), hi_t)
    t_near = jnp.max(lo_t, axis=-1)
    t_far = jnp.min(hi_t, axis=-1)
    t_entry = jnp.maximum(t_near, 0.0)  # ray origin inside the box → 0
    hit = (t_far >= t_near) & (t_far >= 0.0) & (t_entry <= tmax)
    return hit, t_entry


def intersect_ray_bbox(
    splats: GaussianSplats,
    org,
    dir,
    tmax: float = jnp.inf,
) -> RayHit:
    """Intersect one ray with the cluster's point bounding box.

    Mirrors ``GEO_PrimGsplat::intersectRay``: the primitive-level hit proxy
    used by the host application for selection/handles, not a per-splat
    render-precision intersection.
    """
    lo, hi = splats.bbox()
    org = jnp.asarray(org, jnp.float32)
    dir_ = jnp.asarray(dir, jnp.float32)
    hit, t = _slab_test(lo, hi, org, dir_, tmax)
    return RayHit(hit=hit, distance=t, pos=org + t[..., None] * dir_)


def intersect_rays_bbox(
    splats: GaussianSplats,
    orgs,
    dirs,
    tmax: float = jnp.inf,
) -> RayHit:
    """Batched ray/bbox picking: ``orgs``/``dirs`` are (R, 3)."""
    lo, hi = splats.bbox()
    orgs = jnp.asarray(orgs, jnp.float32)
    dirs = jnp.asarray(dirs, jnp.float32)
    hit, t = _slab_test(lo, hi, orgs, dirs, tmax)
    return RayHit(hit=hit, distance=t, pos=orgs + t[..., None] * dirs)
