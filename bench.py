"""Headline benchmark: 1M-splat 1080p forward+backward frames/sec on one GPU.

Prints the device (JAX's ``device_kind`` and device count, and the card's
name and power limit from ``nvidia-smi``), then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...}.  The reference publishes
no numbers (BASELINE.md), so vs_baseline is null.  A run on another
platform than a GPU fails unless ``--backend`` names a backend explicitly;
a failed stats render or parity gate fails the run.

Usage: python bench.py [--splats N] [--width W] [--height H] [--fwd-only]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        )
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--splats", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--wireframe", action="store_true",
                    help="bench the fused band-test wireframe pass (forward-only)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="override tile_capacity (the per-tile composited-pair "
                         "cap).  The 2^23 envelope needs ~16384: the default "
                         "4096 truncates ~60%% of its pairs (reported in "
                         "dropped_pairs — the reference's GL pipeline has no "
                         "such cap, so an honest envelope number needs 0 drops)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="compositing-kernel pair chunk: a power of two that "
                         "divides tile_capacity.  A tile checks for early "
                         "termination and checkpoints its transmittance once "
                         "per chunk; the backward holds one chunk's "
                         "transmittances in registers")
    ap.add_argument("--eps", type=float, default=1e-3,
                    help="transmittance_eps (early-stop threshold; bounds "
                         "the max per-pixel premultiplied-color error by "
                         "eps — the 1e-3 default is < 1/4 of an 8-bit "
                         "display LSB, i.e. invisible on any 8-bit target; "
                         "pass 0 for the bitwise-exact no-early-stop path)")
    ap.add_argument("--payload", default="packed",
                    choices=["packed", "float32", "bfloat16"],
                    help="payload precision policy.  'packed' is the "
                         "production default: geometry f32, color+opacity "
                         "rounded to bf16 (the reference's own "
                         "pos-f32/color-fp16 storage split, "
                         "include/GR_GSplat.h:120-127)")
    ap.add_argument("--backend", default="auto",
                    help="'auto' (the fused kernel; needs a GPU), or an "
                         "explicit backend: pallas, tiles, reference")
    ap.add_argument("--ply", default=None,
                    help="bench a real 3DGS point_cloud.ply instead of the synthetic scene")
    ap.add_argument("--scene", default="uniform", choices=["uniform", "trained"],
                    help="synthetic scene distribution: 'uniform' (the "
                         "historical random_splats bench scene) or 'trained' "
                         "(heavy-tailed log-normal scales, near-transparent "
                         "tail, clustered positions — matched to trained-3DGS "
                         "statistics, BASELINE config 3's 'captured scene')")
    ap.add_argument("--skip-parity", action="store_true",
                    help="skip the on-card kernel parity gate")
    ap.add_argument("--no-tune", action="store_true",
                    help="skip fitting the static pair budget to the scene "
                         "(tune_pair_budget).  Every pair-proportional "
                         "array and pass scales with the static budget, so "
                         "it is on by default — one cheap counting pass")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    import gsplat_tpu as gt
    from gsplat_tpu.utils.platform import resolve_backend, setup_compile_cache

    setup_compile_cache(ROOT)
    dev = jax.devices()[0]
    if args.backend == "auto" and dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX found {dev.platform}); pass --backend "
              "explicitly to run elsewhere", file=sys.stderr)
        sys.exit(1)
    print(f"device_kind: {dev.device_kind}  devices: {len(jax.devices())}",
          flush=True)
    print(f"card: {card_line()}", flush=True)

    key = jax.random.PRNGKey(0)
    if args.ply:
        splats = gt.load_ply(args.ply)
        args.splats = splats.count
    elif args.scene == "trained":
        splats = gt.trained_like_splats(key, args.splats, extent=1.2, sh_scale=0.1)
    else:
        # a scene that covers the frame with realistic footprints + full SH
        splats = gt.random_splats(
            key, args.splats, extent=1.2, scale_range=(0.002, 0.01), sh_scale=0.1
        )
    cam = gt.make_camera(
        eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=args.width, height=args.height
    )
    if args.wireframe:
        args.fwd_only = True
    overrides = {
        "chunk": args.chunk, "tile_capacity": args.capacity,
        "transmittance_eps": args.eps,
    }
    cfg = gt.RenderConfig(
        # the wireframe pass runs on the unquantized f32 payload
        payload_dtype="float32" if args.wireframe else args.payload,
        **{k: v for k, v in overrides.items() if v is not None},
    )

    backend = resolve_backend(args.backend)

    if args.wireframe:
        # the wireframe pass bins with the untight, line-grown footprint —
        # the beauty counting pass would under-size its budget
        args.no_tune = True
        args.skip_parity = True
    if not args.no_tune:
        # Fit the static pair budget to the scene's measured pair count (one
        # cheap counting pass; overflow still warns + culls farthest).  The
        # counting pass is EXACT for the benched camera, so 2% headroom +
        # the bucket round-up suffice.  The dropped-pair counter below
        # proves nothing was culled.
        cfg = gt.tune_pair_budget(splats, cam, cfg, headroom=1.02)

    if args.wireframe:
        def fwd(s, c):
            return gt.render_wireframe(s, c, cfg, backend=backend)
    else:
        def fwd(s, c):
            return gt.render(s, c, cfg, backend=backend)

    def fwd_bwd(s, c):
        def loss(s_):
            return jnp.sum(fwd(s_, c)[..., :3])

        return jax.grad(loss)(s)

    fn = jax.jit(fwd if args.fwd_only else fwd_bwd)
    kind = "wireframe fwd" if args.wireframe else ("fwd" if args.fwd_only else "fwd+bwd")
    metric = f"{args.splats//1000}k-splat {args.width}x{args.height} {kind} frames/sec"

    try:
        jax.block_until_ready(fn(splats, cam))  # compile
        for _ in range(args.warmup):
            jax.block_until_ready(fn(splats, cam))
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(splats, cam))
            times.append(time.perf_counter() - t0)
        dt = statistics.median(times)
        fps = 1.0 / dt
    except Exception as e:  # report failure as a parseable result
        print(json.dumps({
            "metric": metric,
            "value": 0.0,
            "unit": "frames/s",
            "vs_baseline": None,
            "error": f"{type(e).__name__}: {e}"[:300],
        }))
        sys.exit(1)

    result = {
        "metric": metric,
        "scene": ("ply" if args.ply else args.scene),
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": None,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "backend": backend,
        "median_ms": round(dt * 1000, 3),
        "payload_dtype": cfg.payload_dtype,
        "transmittance_eps": cfg.transmittance_eps,
    }
    ok = True
    if not args.wireframe:
        # Overflow counters as jit outputs: one untimed stats render proves
        # the tuned budget dropped nothing — the fps number is only honest
        # at zero drops.
        _, stats = gt.render(splats, cam, cfg, backend=backend, with_stats=True)
        result["dropped_pairs"] = int(stats.dropped_pairs)
        ok &= result["dropped_pairs"] == 0
    if backend == "pallas" and not args.skip_parity:
        # The fps number is only meaningful if the compiled kernels match
        # the references ON THIS DEVICE (interpret-mode tests cannot catch
        # a miscompile).
        from gsplat_tpu.parity import kernel_parity

        p = kernel_parity(backend)
        result["parity_ok"] = p["ok"]
        result["parity_img_maxdiff"] = p["img_max_abs_diff"]
        result["parity_grad_reldiff"] = p["grad_max_rel_diff"]
        ok &= p["ok"]
    print(json.dumps(result))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
