#!/usr/bin/env python3
"""On-card smoke test: the renderer's main paths on one NVIDIA GPU.

    python chip_smoke.py          # one card: phases 1-8 below
    python chip_smoke.py --four   # four cards: the sharded phase only

Phases (any failure ends the run with a non-zero exit; nothing is skipped):

1. device: the first JAX device must be a GPU; prints its kind and the
   card's name and power limit (``nvidia-smi``);
2. the ``gpu``-marked tests (``pytest -m gpu``), run as a child process
   before this process touches JAX, so only one process holds the card;
3. kernel parity at reduced width (4096 splats, 256×256, eps 0): image vs
   the oracle, gradients of all six fields vs ``tiles``, wireframe vs its
   oracle (bounds in ``gsplat_tpu/parity.py``);
4. kernel parity at full width (1M splats, 1920×1080, production config):
   vs ``tiles`` at eps 0 and at eps 1e-3, and zero dropped pairs;
5. the main path at full width: forward and forward+backward, compiled and
   run 3 times each, with compile seconds, run milliseconds,
   ``memory_analysis()`` and peak device memory;
6. training: ``make_train_step`` (L1+SSIM, Adam) at full width, fitted to a
   target rendered from a second seeded scene — 3 finite losses, and the
   parameters change;
7. interactive entry points: ``render_wireframe(backend="auto")`` at full
   width, and ``SceneRegistry.render`` for 3 frames along a seeded orbit
   (one frame reuses the cached depth order, one re-sorts);
8. the 2^23-splat envelope: forward+backward at ``tile_capacity=21760``,
   ``memory_analysis()``, one run, zero dropped pairs.

``--four`` (four cards): ``render_sharded`` over a 4-GPU splat mesh at full
width against the single-device render on device 0 (bit-identical images),
and one ``make_sharded_train_step`` over a (dp=2, sp=2) mesh against the
single-device loss.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Times printed here are for this card at its power limit, not claims.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N, WIDTH, HEIGHT = 1_000_000, 1920, 1080
ENVELOPE_N, ENVELOPE_CAPACITY = 1 << 23, 21760
SMALL_N, SMALL_SIZE = 4096, 256
TRAIN4_HEIGHT = 1024  # --four training rows: a multiple of dp·sp·32
BACKEND = "pallas"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def child_platform() -> str:
    """The JAX platform, asked of a child so this process stays off JAX."""
    r = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True,
    )
    return r.stdout.strip().splitlines()[-1] if r.returncode == 0 and r.stdout.strip() else ""


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def timed(fn, *args, runs=3):
    """Compile ``jax.jit(fn)`` for ``args``, then run it ``runs`` times.
    Returns (compiled, compile seconds, run milliseconds, last output)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        ms.append((time.perf_counter() - t0) * 1e3)
    return compiled, compile_s, ms, out


def peak_bytes():
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def scene(n, seed=0):
    import jax

    import gsplat_tpu as gt

    return gt.random_splats(
        jax.random.PRNGKey(seed), n, extent=1.2, scale_range=(0.002, 0.01),
        sh_scale=0.1,
    )


def camera(height=None, eye=(0.0, 0.4, 3.0)):
    import gsplat_tpu as gt

    return gt.make_camera(
        eye=list(eye), target=[0, 0, 0], width=WIDTH, height=height or HEIGHT
    )


def production_config(splats, cams, headroom=1.2, **kw):
    import gsplat_tpu as gt

    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3, **kw)
    return gt.tune_pair_budget(splats, cams, cfg, headroom=headroom)


def phase_small_parity():
    from gsplat_tpu.parity import kernel_parity

    r = kernel_parity(BACKEND, n=SMALL_N, size=SMALL_SIZE)
    log("  ", r)
    check(r["ok"], f"reduced-width kernel parity failed: {r}")


def phase_full_parity(splats, cam, cfg):
    from gsplat_tpu.parity import forward_parity

    r = forward_parity(splats, cam, cfg, BACKEND)
    log("  ", r)
    check(r["ok"], f"full-width kernel parity failed: {r}")


def phase_main_path(splats, cam, cfg, card):
    import jax
    import jax.numpy as jnp

    import gsplat_tpu as gt

    def fwd(s):
        return gt.render(s, cam, cfg, backend="auto")

    def fwd_bwd(s):
        return jax.grad(lambda s_: jnp.sum(fwd(s_)[..., :3]))(s)

    for name, fn in (("forward", fwd), ("forward+backward", fwd_bwd)):
        compiled, cs, ms, out = timed(fn, splats)
        leaves = jax.tree.leaves(out)
        check(all(bool(jnp.isfinite(x).all()) for x in leaves), f"{name}: non-finite")
        log(f"   {name}: compile {cs:.1f} s; runs (ms, {card}) "
            + ", ".join(f"{m:.2f}" for m in ms))
        log(f"   {name}: {compiled.memory_analysis()}")
    log(f"   peak_bytes_in_use {peak_bytes()}")


def phase_training(splats, cam, cfg, card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gsplat_tpu as gt
    from gsplat_tpu.train.params import params_from_splats
    from gsplat_tpu.train.trainer import default_optimizer, make_train_step

    target_img = gt.render(scene(N, seed=2), cam, cfg, backend="auto")
    target = target_img[..., :3] + (1.0 - target_img[..., 3:4])
    params = params_from_splats(splats)
    opt = default_optimizer()
    state = opt.init(params)
    step = make_train_step(opt, cam, cfg)
    p0 = jax.tree.map(np.asarray, params)
    losses = []
    for i in range(3):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, target)
        losses.append(float(loss))
        log(f"   step {i}: loss {losses[-1]:.6f} "
            f"({(time.perf_counter() - t0) * 1e3:.1f} ms incl. compile on step 0, {card})")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    changed = any(
        not np.array_equal(a, np.asarray(b))
        for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(params))
    )
    check(changed, "parameters did not change")
    check(bool(jnp.isfinite(jnp.stack([jnp.sum(x) for x in jax.tree.leaves(params)])).all()),
          "non-finite parameters")


def phase_interactive(splats, cam, card):
    import jax.numpy as jnp
    import numpy as np

    import gsplat_tpu as gt

    t0 = time.perf_counter()
    wire = gt.render_wireframe(splats, cam, gt.RenderConfig(), backend="auto")
    wire = np.asarray(wire)
    log(f"   wireframe: {(time.perf_counter() - t0):.1f} s incl. compile; "
        f"covered px {int((wire[..., 3] > 0).sum())}")
    check(wire.shape == (HEIGHT, WIDTH, 4) and np.isfinite(wire).all(), "wireframe output")
    check((wire[..., 3] > 0).any(), "wireframe drew nothing")

    # A short seeded orbit: frame 2 moves a little (cached order reused),
    # frame 3 moves past the threshold (re-sort).
    rng = np.random.default_rng(7)
    angles = np.cumsum([0.0, 0.01, 0.3]) + rng.uniform(0, 2 * np.pi)
    eyes = [(3.0 * np.sin(a), 0.4, 3.0 * np.cos(a)) for a in angles]
    cams = [camera(eye=e) for e in eyes]
    d1 = float(np.sum((np.subtract(eyes[1], eyes[0])) ** 2))
    d2 = float(np.sum((np.subtract(eyes[2], eyes[1])) ** 2))
    reg = gt.SceneRegistry(production_config(splats, cams))
    reg.sort_movement_threshold = d1 + 0.5 * d2
    rid = reg.register_update("scene", splats)
    orders = []
    for i, c in enumerate(cams):
        reg.include_in_render_pass(rid)
        t0 = time.perf_counter()
        img = np.asarray(reg.render(c))
        dropped = int(reg._last_stats.dropped_pairs)
        orders.append(reg._order)
        reg.post_render()
        log(f"   registry frame {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms "
            f"(incl. compile on frame 0, {card}), dropped {dropped}")
        check(np.isfinite(img).all() and img.shape == (HEIGHT, WIDTH, 4), "frame output")
        check(dropped == 0, f"frame {i} dropped {dropped} pairs")
    check(orders[1] is orders[0], "frame 1 should reuse the cached depth order")
    check(orders[2] is not orders[1], "frame 2 should re-sort")
    check(bool(jnp.all(orders[2] >= 0)), "bad order")


def phase_envelope(card):
    import jax
    import jax.numpy as jnp

    import gsplat_tpu as gt

    splats = scene(ENVELOPE_N)
    cam = camera()
    cfg = production_config(splats, cam, headroom=1.02, tile_capacity=ENVELOPE_CAPACITY)
    _, stats = jax.jit(lambda s: gt.render(s, cam, cfg, backend="auto", with_stats=True))(splats)
    check(int(stats.dropped_pairs) == 0, f"envelope dropped {int(stats.dropped_pairs)} pairs")

    def fwd_bwd(s):
        return jax.grad(lambda s_: jnp.sum(gt.render(s_, cam, cfg, backend="auto")[..., :3]))(s)

    t0 = time.perf_counter()
    compiled = jax.jit(fwd_bwd).lower(splats).compile()
    log(f"   compile {time.perf_counter() - t0:.1f} s; {compiled.memory_analysis()}")
    t0 = time.perf_counter()
    g = jax.block_until_ready(compiled(splats))
    log(f"   one forward+backward: {(time.perf_counter() - t0) * 1e3:.1f} ms ({card}); "
        f"budget {cfg.pair_budget(ENVELOPE_N)}; peak_bytes_in_use {peak_bytes()}")
    check(all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(g)), "non-finite grads")


def phase_four(card):
    import jax
    import numpy as np
    import optax

    import gsplat_tpu as gt
    from gsplat_tpu.parallel.mesh import make_mesh, splat_mesh
    from gsplat_tpu.parallel.render_sharded import pad_splats, render_sharded, shard_splats
    from gsplat_tpu.train.params import params_from_splats
    from gsplat_tpu.train.trainer import make_sharded_train_step, make_train_step, shard_params

    check(len(jax.devices()) >= 4, f"needs 4 devices, found {len(jax.devices())}")
    splats = scene(N)
    cam = camera()
    cfg = production_config(splats, cam)
    mesh = splat_mesh(4)
    t0 = time.perf_counter()
    multi, stats = render_sharded(
        shard_splats(splats, mesh), cam, cfg, mesh, backend=BACKEND, with_stats=True
    )
    multi = np.asarray(multi)
    log(f"   render_sharded: {(time.perf_counter() - t0):.1f} s incl. compile "
        f"({card}); dropped {int(stats.dropped_pairs)}")
    # Op by op on device 0, as the sharded program's pieces run: a jitted
    # single-device program may fuse the projection differently and round
    # its last bits differently.
    single = np.asarray(gt.render(pad_splats(splats, 4), cam, cfg, backend=BACKEND))
    diff = float(np.abs(multi - single).max())
    log(f"   sharded vs single-device image: max |diff| {diff} "
        f"(bit-identical: {diff == 0.0})")
    # 1e-4: far below an 8-bit display step (3.9e-3), far above f32
    # rounding of the projection.
    check(diff <= 1e-4, f"sharded render differs from single-device: {diff}")

    # Training: rows must divide dp·sp·tile_h so no padded rows enter the loss.
    tcam = camera(height=TRAIN4_HEIGHT)
    tcfg = production_config(splats, tcam)
    target_img = gt.render(scene(N, seed=2), tcam, tcfg, backend=BACKEND)
    target = np.asarray(target_img[..., :3] + (1.0 - target_img[..., 3:4]))
    params = params_from_splats(splats)
    opt = optax.adam(1e-3)
    _, _, loss1 = make_train_step(opt, tcam, tcfg, backend=BACKEND)(
        params, opt.init(params), target
    )
    mesh2 = make_mesh(batch=2, splat=2, devices=jax.devices()[:4])
    sparams = shard_params(params, mesh2)
    step = make_sharded_train_step(opt, tcam, mesh2, tcfg, backend=BACKEND)
    views = np.stack([np.asarray(tcam.view)] * 2)
    projs = np.stack([np.asarray(tcam.proj)] * 2)
    _, _, loss4 = step(sparams, opt.init(sparams), views, projs, np.stack([target] * 2))
    loss1, loss4 = float(loss1), float(loss4)
    rel = abs(loss4 - loss1) / max(abs(loss1), 1e-12)
    log(f"   loss single {loss1:.7f}  sharded (dp=2, sp=2) {loss4:.7f}  rel diff {rel:.2e}")
    check(np.isfinite(loss4), "non-finite sharded loss")
    # float rounding: per-strip partial means summed in another order
    check(rel <= 1e-5, f"sharded loss differs from single-device by {rel:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    platform = child_platform()
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform or 'no device'}",
              file=sys.stderr)
        return 1
    if not args.four:
        log("phase 2: gpu-marked tests")
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:cacheprovider",
             os.path.join(ROOT, "tests")],
            cwd=ROOT, capture_output=True, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cuda,cpu"},
        )
        log(r.stdout[-3000:])
        summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        if r.returncode != 0 or "skipped" in summary or "passed" not in summary:
            print(f"chip_smoke: gpu tests failed or skipped (rc {r.returncode}): "
                  f"{summary}\n{r.stderr[-2000:]}", file=sys.stderr)
            return 1

    sys.path.insert(0, ROOT)
    import jax

    from gsplat_tpu.utils.platform import setup_compile_cache

    log("compile cache:", setup_compile_cache(ROOT))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}", file=sys.stderr)
        return 1
    card = card_line()
    log(f"phase 1: device {dev.device_kind}, count {len(jax.devices())}")
    log(f"card: {card}")

    def run(name, fn, *a):
        log(f"phase {name}")
        t0 = time.perf_counter()
        fn(*a)
        log(f"phase {name} ok ({time.perf_counter() - t0:.1f} s)")

    if args.four:
        run("9: four cards", phase_four, card)
        count = 4
    else:
        splats = scene(N)
        cam = camera()
        cfg = production_config(splats, cam, headroom=1.02)
        run("3: kernel parity, reduced width", phase_small_parity)
        run("4: kernel parity, full width", phase_full_parity, splats, cam, cfg)
        run("5: main path", phase_main_path, splats, cam, cfg, card)
        run("6: training", phase_training, splats, cam, cfg, card)
        run("7: interactive entry points", phase_interactive, splats, cam, card)
        del splats
        run("8: 2^23 envelope", phase_envelope, card)
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
