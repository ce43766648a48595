"""Render configuration.

The reference's "config system" is three scattered channels (compile-time
constants, detail attributes, SOP parms — SURVEY.md §5).  Here it is one
explicit dataclass threaded through the jitted pipeline as a static argument.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable: used as a jit static arg)."""

    # SH evaluation order 0..3 (the reference's gsplat__sh_order detail attr,
    # clamped with an error in src/GR_GSplat.C:444-457).
    sh_order: int = 3

    # Debug mode matching the reference shader's ``onlySH`` flag
    # (gsplat_plugin/shaders/GSplatShaderCoreLib.h:117-179): replace the DC
    # base color with 0.5 grey so only the directional SH bands show.
    only_sh: bool = False

    # Warn (once, via the scene logger) when the static pair budget or a
    # tile's capacity truncates pairs — the analogue of the reference's cull
    # warning (src/GSplatRenderer.C:366-376).  Wired through an async host
    # callback; set False to keep jitted renders callback-free.
    warn_on_drop: bool = True

    # Tile size for the tiled/Pallas rasterizer.  The Pallas kernel requires
    # 32×32: one program composites one tile's 1024 pixels (a power of two,
    # as Triton blocks need), and a square tile wastes less masked work on
    # typical splat footprints than a strip of the same size.
    tile_h: int = 32
    tile_w: int = 32

    # Average (tile, splat) pairs budgeted per splat: the static pair-array
    # size is pairs_per_splat·N, and every binning/gather/sort pass scales
    # with it.  Overflow drops the *farthest* splats' pairs with a reported
    # count (analogue of the reference's 2^23 global budget cull,
    # src/GSplatRenderer.C:366-376).  3.0 leaves >30% headroom over a
    # full-frame 1080p scene under the opacity-aware tight footprint
    # (measured ~2.3 pairs/splat); raise it for scenes of huge splats or for
    # soft_cutoff rendering (untight footprints).
    pairs_per_splat: float = 3.0

    # Per-tile cap on composited splats (front-to-back; overflow beyond the
    # cap drops the *farthest* splats, which the early-stop would likely have
    # skipped anyway).  Must be a multiple of the compositing chunk size.
    tile_capacity: int = 4096

    # Compositing-kernel pair chunk (a power of two that divides
    # tile_capacity): a tile checks for early termination and the forward
    # checkpoints its transmittance once per chunk, and the backward
    # replays one chunk at a time with every pair's transmittance held in
    # registers — so the chunk trades checkpoint memory (4 KB per chunk of
    # pairs) against registers.  On an H100 chunk 16 runs the 1M/1080p
    # forward+backward 2.4× slower than chunk 8 (the held vectors outgrow
    # the registers); chunk 4 is 9% faster than 8 but doubles the
    # checkpoints, which matters at the 2^23 envelope.
    chunk: int = 8

    # Upper clamp on per-fragment alpha.  The reference clamps to 1.0
    # (GSplatShaderSource.h:308); values < 1 keep the backward pass's
    # 1/(1−α) transmittance rewind finite (3DGS uses 0.99).
    max_alpha: float = 0.99

    # Stop compositing a pixel once transmittance falls below this (perf
    # optimisation absent in the reference's fixed-function blend; set to 0.0
    # for exact-parity tests).
    transmittance_eps: float = 1e-4

    # Global splat budget (reference: GSPLAT_COUNT_MAX = 2^23,
    # include/GSplatRenderer.h:26).
    max_splats: int = 1 << 23

    # The reference semantics are discontinuous: fragments are discarded below
    # α = 1/255 (GSplatShaderSource.h:309) and truncated at the ±2 quad extent
    # (:185-187).  With soft_cutoff=True both hard masks are dropped, making
    # the render fully differentiable (no jump discontinuities) — used for
    # gradient verification and available for training.  Default False =
    # exact reference parity.
    soft_cutoff: bool = False

    # Rasterization payload precision — a quantization policy, the analogue
    # of the reference's storage policy (pos fp32, color/scale/orient/SH
    # fp16: gsplat_plugin/include/GR_GSplat.h:120-127,
    # src/GSplatRenderer.C:91-101), applied by ``quantize_payload`` in EVERY
    # backend, so pallas↔tiles↔oracle parity tests remain bit-exact among
    # themselves and quality deltas vs fp32 are tolerance-tested.  The
    # compositing kernel always reads the (rounded) payload as f32 rows.
    #
    # "bfloat16" rounds the 10 compositor payload rows (center, quad basis,
    # rgb, opacity) to bf16; geometry rows (depth key, validity, footprint)
    # stay fp32.
    #
    # "packed" keeps the geometric rows (center, quad basis) f32 and rounds
    # only color+opacity to bf16 — strictly higher precision than
    # "bfloat16", and the closest analogue of the reference's storage split
    # (pos fp32, color/alpha fp16).  The production benchmark uses it.
    payload_dtype: str = "float32"

    # Wireframe debug mode (the reference's line-quad pass,
    # gsplat_plugin/src/GR_GSplat.C:376-421 + GSplatShaderSource.h:22-110):
    # the compositing kernel replaces the Gaussian falloff with an opaque
    # band test on the quad edge (|max(|qx|,|qy|)| ≈ QUAD_EXTENT), so
    # "nearest splat wins" falls out of front-to-back compositing + early
    # stop.  Set via render_wireframe(backend="pallas"); forward-only
    # (gradients are undefined for the band test).
    wireframe: bool = False

    # Wireframe line half-width in pixels.
    line_px: float = 1.0

    # Per-strip pair-budget headroom for the sharded renderer: a device
    # rendering 1/d of the tile rows gets budget
    # ceil(pairs_per_splat·N·strip_budget_factor/d) (clamped to the full
    # budget), so pair-proportional memory and compute scale ~1/d.  2.0
    # tolerates a 2× hotter-than-average strip; raise it for scenes with
    # extreme vertical concentration (overflow drops farthest pairs with the
    # cull warning, as always).
    strip_budget_factor: float = 2.0

    # Strip-compacted payload exchange for the sharded renderer (0 =
    # disabled → all_gather of the full projected payload, replicated sort).
    # When > 0, each device compacts, per destination strip, only its local
    # splats whose footprint overlaps that strip into a bucket of
    # ceil(strip_exchange_factor · N/d) columns and ships buckets with ONE
    # all_to_all: per-device payload memory and sort size drop from
    # O(N) to O(strip_exchange_factor · N) — sub-O(N) per device, the
    # scaling wall of the replicated design.  Bucket overflow drops the
    # excess columns (warned once, like the pair-budget cull); with a
    # factor covering the worst strip the image is bit-identical to the
    # all_gather path AND the single-device render.  Typical scenes need
    # factor ≈ max-strip-share + footprint overlap (≈ 2-3/d for d strips).
    strip_exchange_factor: float = 0.0

    # Sharded-render tile-row assignment.  "cyclic" (default): device i of
    # d owns global tile rows {i, i+d, i+2d, ...} — interleaving averages
    # center-heavy splat distributions over devices, keeping every device's
    # pair share within a few percent of the mean (the contiguous-strip
    # decomposition measured 0.455 pair-parallel efficiency at 32 devices
    # on centered scenes — scripts/scaling_model.py).  "contiguous": device
    # i owns one horizontal strip — required by (and automatically forced
    # for) the strip-compacted exchange (strip_exchange_factor > 0) and the
    # sharded trainer's SSIM halo, both of which need spatially coherent
    # strips.  Single-device renders ignore it.
    row_assignment: str = "cyclic"

    # INTERNAL (set by the sharded renderer, not by users): global tile row
    # of local tile row ℓ is ``row_offset + ℓ·row_stride`` (and likewise
    # columns with ``col_offset + ℓ·col_stride``).  1 = contiguous strip /
    # full frame; the cyclic renderer factors d devices into a
    # (row_stride × col_stride) interleave grid.  Rides in the config so
    # binning, both compositing backends, and the Pallas kernels see one
    # consistent mapping (it keys their jit/kernel caches).
    row_stride: int = 1
    col_stride: int = 1

    # Depth-test compositing INTO a host scene (the reference's beauty-pass
    # contract: splats drawn after all opaque geometry, z-TESTED against the
    # scene's depth buffer but not z-written —
    # gsplat_plugin/src/GSplatRenderer.C:595-610).  Enabled internally by
    # ``render(..., background_depth=...)``: per pixel, splat contributions
    # whose center's view-space depth exceeds the scene depth are killed
    # before blending, and the result composes over the scene color with
    # the under operator.  Carries the per-splat view-z as an extra payload
    # row; not combined with payload_dtype "packed" (validated below).
    depth_test: bool = False

    # Exact pair budget override (0 = derive from pairs_per_splat·N).  Set
    # by ``tune_pair_budget`` after measuring the scene's real (tile, splat)
    # pair count: every binning/gather/sort/VJP pass scales with the static
    # budget, so trimming the default's headroom to a measured ~20% cuts the
    # whole glue layer proportionally (~6% frame time at 1M/1080p, and the
    # difference between fitting and OOM at the 2^23 envelope).  Bucketed so
    # camera motion doesn't re-jit every frame.
    pair_budget_override: int = 0

    # Hard cap on splats whose (tile,splat) pairs we materialise. Derived
    # pair budget = round(pairs_per_splat * N) at trace time.
    def pair_budget(self, n: int) -> int:
        if self.pair_budget_override > 0:
            return max(self.pair_budget_override, 8)
        return max(int(round(self.pairs_per_splat * n)), 8)

    def strip_pair_budget(self, n: int, n_strips: int) -> int:
        """Static per-strip budget for 1/``n_strips`` of the tile rows."""
        full = self.pair_budget(n)
        scaled = int(round(full * self.strip_budget_factor / max(n_strips, 1)))
        return max(min(full, scaled), 4 * self.chunk)

    def __post_init__(self):
        if not 0 <= self.sh_order <= 3:
            raise ValueError(f"sh_order must be in [0,3], got {self.sh_order}")
        if self.chunk < 1 or self.chunk & (self.chunk - 1):
            raise ValueError("chunk must be a power of two")
        if self.row_assignment not in ("cyclic", "contiguous"):
            raise ValueError(
                f"row_assignment must be 'cyclic' or 'contiguous', got "
                f"{self.row_assignment!r}"
            )
        if self.row_stride < 1 or self.col_stride < 1:
            raise ValueError("row/col_stride must be >= 1")
        if self.depth_test and self.payload_dtype == "packed":
            # Not wired together: the packed policy is the production
            # beauty pass only (ROADMAP, Reach 3).
            raise ValueError(
                "depth_test is not supported with payload_dtype='packed' — "
                "use payload_dtype='float32' or 'bfloat16'"
            )
        if self.tile_capacity % self.chunk != 0:
            raise ValueError("tile_capacity must be a multiple of chunk")
        if self.payload_dtype not in ("float32", "bfloat16", "packed"):
            raise ValueError(
                f"payload_dtype must be 'float32', 'bfloat16' or 'packed', "
                f"got {self.payload_dtype!r}"
            )
