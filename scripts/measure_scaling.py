"""Scaling-efficiency measurement over a virtual device mesh.

Measures sharded-render throughput at 1/2/4/8 devices and writes
``chiprun_out/scaling.json``.  It takes no device time: the mesh is virtual
CPU devices (``--xla_force_host_platform_device_count``):
all N devices timeshare the same host cores, which makes wall-clock
*speedup* pessimistic (compute does not scale), but faithfully charges the
real distribution overheads — the all_gather exchange, the replicated sort,
and per-strip binning — so the reported efficiency is a LOWER bound on what
disjoint chips would achieve for the non-replicated fraction.

Also reports the per-device work decomposition (replicated vs sharded
bytes/ops) that determines the interconnect ceiling.

Usage: python scripts/measure_scaling.py [--splats N] [--out FILE]
"""

import argparse
import json
import os
import statistics
import sys
import time

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--splats", type=int, default=65536)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "scaling.json"))
    args = ap.parse_args()

    import gsplat_tpu as gt
    from gsplat_tpu.parallel.mesh import splat_mesh
    from gsplat_tpu.parallel.render_sharded import render_sharded, shard_splats

    cfg = gt.RenderConfig(tile_capacity=1024)
    cam = gt.make_camera(
        eye=[0.0, 0.4, 3.0], target=[0, 0, 0],
        width=args.width, height=args.height,
    )
    splats = gt.random_splats(
        jax.random.PRNGKey(0), args.splats, extent=1.0,
        scale_range=(0.004, 0.02), sh_scale=0.1,
    )

    results = []
    t1 = None
    for n_dev in (1, 2, 4, 8):
        mesh = splat_mesh(n_dev)
        sharded = shard_splats(splats, mesh)
        fn = jax.jit(
            lambda s: render_sharded(s, cam, cfg, mesh, backend="tiles")
        )
        img = jax.block_until_ready(fn(sharded))  # compile
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(sharded))
            times.append(time.perf_counter() - t0)
        t = statistics.median(times)
        if n_dev == 1:
            t1 = t
        eff = t1 / (n_dev * t) if t1 else None
        results.append({
            "devices": n_dev,
            "median_s": round(t, 4),
            "speedup": round(t1 / t, 3),
            "efficiency": round(eff, 3),
        })
        print(f"devices={n_dev} median={t*1000:.1f} ms speedup={t1/t:.2f} eff={eff:.2f}")

    # Work decomposition: what fraction of per-device work shrinks with d.
    n = args.splats
    decomp = {
        "sharded_per_device": {
            "projection_splats": f"N/d = {n}/d",
            "binning_pairs": "~pairs/d (per-strip)",
            "compositing_tiles": "tile_rows/d",
        },
        "replicated_per_device": {
            "all_gather_bytes": 16 * 4 * n,
            "global_sort_keys": n,
        },
        "note": (
            "virtual CPU mesh: devices timeshare one host, so compute does "
            "not scale and wall-clock efficiency is a lower bound; the "
            "replicated fraction (gather+sort) is the true scaling ceiling "
            "on real chips"
        ),
    }
    out = {
        "metric": "sharded render scaling (virtual 8-device CPU mesh)",
        "scene": {"splats": args.splats, "width": args.width, "height": args.height},
        "results": results,
        "decomposition": decomp,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
