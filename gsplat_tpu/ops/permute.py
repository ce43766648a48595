"""Column permutation with a gather-only custom VJP.

``x[:, perm]`` under plain autodiff transposes to a multi-row scatter-add.
For a *permutation* the adjoint is itself a permutation: ``dx = g[:, inv]``
— the inverse index is built by sorting the permutation back against iota,
followed by one multi-row gather.  Used for the global depth sort
(``ops/rasterize_tiles.sort_by_depth``).

``diff_rows`` (static) declares that only rows ``< diff_rows`` of the output
ever receive non-zero cotangents (for the splat pipeline: rows 0..9 feed the
differentiable compositor; rows 10..15 — depth key, validity, bbox — feed
only the non-differentiable sort/binning), so the backward gather touches
only those rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _int0(x):
    return np.zeros(x.shape, jax.dtypes.float0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def permute_cols(x: jnp.ndarray, perm: jnp.ndarray, diff_rows: int = None) -> jnp.ndarray:
    """``x[:, perm]`` where ``perm`` is a permutation of ``arange(x.shape[1])``."""
    return x[:, perm]


def _fwd(x, perm, diff_rows):
    return x[:, perm], perm


def _bwd(diff_rows, perm, g):
    n = perm.shape[0]
    _, inv = jax.lax.sort(
        (perm, jnp.arange(n, dtype=perm.dtype)), num_keys=1
    )
    if diff_rows is not None and diff_rows < g.shape[0]:
        d = jnp.pad(g[:diff_rows][:, inv], ((0, g.shape[0] - diff_rows), (0, 0)))
    else:
        d = g[:, inv]
    return d, _int0(perm)


permute_cols.defvjp(_fwd, _bwd)
