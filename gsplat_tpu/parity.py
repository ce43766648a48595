"""Parity checks of the fused compositing kernels against the plain
references, run on whatever device JAX uses (the GPU in ``chip_smoke.py``,
``bench.py`` and the ``gpu``-marked tests; the Pallas interpreter with
``backend="pallas_interpret"``).

Tolerances and why:

* image vs the O(N·H·W) oracle at ``transmittance_eps=0``: ≤ 1e-5 — the same
  per-pixel math in the same order, up to float rounding;
* gradients vs XLA autodiff of the ``tiles`` backend: ≤ 2e-4·max(1, |g|max)
  per field — the kernel sums each pair's gradient over pixels in another
  order than autodiff does;
* wireframe vs its oracle: ≤ 1e-4 of the pixels may differ.  The band of a
  quad's corner can reach past the line-grown binning bbox, so a binned
  render can miss a few corner pixels the per-pixel oracle draws (seen at
  4096 splats, 256×256: 1 pixel, identically in interpret mode and on the
  GPU).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .models.camera import make_camera
from .models.splats import random_splats
from .ops.wireframe import render_wireframe
from .render import render
from .utils.config import RenderConfig

FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")
IMG_TOL = 1e-5
GRAD_REL_TOL = 2e-4
WIRE_PIXEL_FRACTION = 1e-4


def small_scene(n: int = 4096, size: int = 256, seed: int = 1):
    splats = random_splats(jax.random.PRNGKey(seed), n, extent=0.8, sh_scale=0.2)
    cam = make_camera(
        eye=[0.2, 0.4, 3.0], target=[0, 0, 0], width=size, height=size
    )
    return splats, cam


def kernel_parity(
    backend: str = "pallas", n: int = 4096, size: int = 256, seed: int = 1
) -> dict:
    """Kernel vs oracle (image), vs ``tiles`` autodiff (gradients of all six
    fields) and vs the wireframe oracle, on a reduced-width scene at
    ``transmittance_eps=0``.  Returns the measured errors and ``ok``."""
    splats, cam = small_scene(n, size, seed)
    cfg = RenderConfig(transmittance_eps=0.0, pairs_per_splat=16.0)

    def img(b):
        return np.asarray(jax.jit(lambda s: render(s, cam, cfg, backend=b))(splats))

    with jax.default_matmul_precision("highest"):
        ref = img("reference")
    out = {"img_max_abs_diff": float(np.abs(img(backend) - ref).max())}

    w = jax.random.normal(jax.random.PRNGKey(5), (size, size, 4))

    def grads(b):
        loss = lambda s: jnp.sum(render(s, cam, cfg, backend=b) * w)  # noqa: E731
        return jax.jit(jax.grad(loss))(splats)

    g_ref, g_k = grads("tiles"), grads(backend)
    rel = 0.0
    for f in FIELDS:
        a = np.asarray(getattr(g_ref, f))
        b = np.asarray(getattr(g_k, f))
        rel = max(rel, float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max())))
    out["grad_max_rel_diff"] = rel

    wk = np.asarray(render_wireframe(splats, cam, cfg, backend=backend))
    wr = np.asarray(render_wireframe(splats, cam, cfg, backend="reference"))
    bad = int((np.abs(wk - wr).max(axis=-1) > IMG_TOL).sum())
    out["wire_bad_pixels"] = bad
    out["ok"] = (
        out["img_max_abs_diff"] <= IMG_TOL
        and rel <= GRAD_REL_TOL
        and bad <= WIRE_PIXEL_FRACTION * size * size
    )
    return out


def forward_parity(splats, camera, config: RenderConfig, backend: str = "pallas") -> dict:
    """Kernel vs ``tiles`` forward at the given (production) config, at
    ``transmittance_eps=0`` (bound 1e-5) and at the config's own eps (bound
    eps: early termination drops at most eps of each pixel's remaining
    light).  Also reports the kernel render's ``dropped_pairs``."""
    out = {}
    ok = True
    for tag, c in (
        ("eps0", dataclasses.replace(config, transmittance_eps=0.0)),
        ("eps", config),
    ):
        k_img, stats = jax.jit(
            lambda s: render(s, camera, c, backend=backend, with_stats=True)
        )(splats)
        t_img = jax.jit(lambda s: render(s, camera, c, backend="tiles"))(splats)
        d = float(jnp.abs(k_img - t_img).max())
        out[f"max_abs_diff_{tag}"] = d
        out["dropped_pairs"] = int(stats.dropped_pairs)
        ok &= d <= max(IMG_TOL, c.transmittance_eps)
    out["ok"] = ok and out["dropped_pairs"] == 0
    return out
