"""Package version.

The analogue of the reference's version header
(``gsplat_plugin/include/GSplatPluginVersion.h:4`` — "1.4.1"); surfaced in
logs once per process like the reference does in
``gsplat_plugin/src/GSplatRenderer.C:234``.
"""

__version__ = "0.2.0"
REFERENCE_VERSION = "1.4.1"
