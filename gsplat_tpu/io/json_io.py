"""JSON save/load of a splat cluster.

The reference primitive persists itself into Houdini's .hip/.geo files via a
JSON schema (``geo_PrimGsplatJSON``, ``gsplat_plugin/src/GEO_GSplat.C:162-258``
— a single ``vertex`` array field; splat attributes ride Houdini's own
attribute serialization).  This framework's scene IS its attribute set, so
the JSON document stores every field of :class:`GaussianSplats` directly:
base64-encoded little-endian arrays (bit-exact round trip) plus shape/dtype
metadata and a format version.

For large scenes prefer :mod:`gsplat_tpu.io.ply` (interchange) or
:mod:`gsplat_tpu.io.checkpoint` (orbax, sharded); JSON is the
human-inspectable / VCS-friendly option for small scenes and fixtures.
"""

from __future__ import annotations

import base64
import json
from typing import Union

import numpy as np

from ..models.splats import GaussianSplats
from ..version import __version__

_FIELDS = ("pos", "orient", "scale", "opacity", "color", "sh")


def _encode(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return {
        "dtype": a.dtype.str,
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def _decode(d: dict) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"])


def save_json(path: str, splats: GaussianSplats) -> None:
    """Write the cluster to ``path`` (bit-exact round trip)."""
    doc = {
        "format": "gsplat_tpu.splats",
        "version": __version__,
        "count": int(splats.count),
        "fields": {
            name: _encode(np.asarray(getattr(splats, name))) for name in _FIELDS
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def load_json(path: str) -> GaussianSplats:
    """Load a cluster written by :func:`save_json`."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != "gsplat_tpu.splats":
        raise ValueError(f"{path}: not a gsplat_tpu.splats JSON document")
    import jax.numpy as jnp

    fields = {name: jnp.asarray(_decode(doc["fields"][name])) for name in _FIELDS}
    return GaussianSplats(**fields).validate()
