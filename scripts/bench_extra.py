"""Battery of the off-headline operating points, one JSON file.

Runs bench.py (same harness, same parity/drop accounting), one child
process per row — this parent never imports JAX, so only one process holds
the card, and the children share bench.py's persistent compile cache:
  * 1M uniform fwd+bwd / fwd-only / wireframe (headline scene);
  * 1M TRAINED-statistics scene fwd+bwd (BASELINE config 3 "captured
    scene": log-normal scales, near-transparent tail, clustered positions
    — at a 64k tile capacity);
  * the full 2^23 = 8,388,608-splat envelope (the reference's hard budget,
    include/GSplatRenderer.h:26): fwd+bwd, fwd-only, wireframe.

Every beauty-pass row reports ``dropped_pairs``.

Usage: python scripts/bench_extra.py [--out chiprun_out/bench_extra.json]
Exits non-zero if any row failed.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNS = [
    ("uniform_1m_fwd_bwd", ["--skip-parity"]),
    ("uniform_1m_fwd", ["--fwd-only", "--skip-parity"]),
    ("uniform_1m_wireframe", ["--wireframe", "--iters", "5"]),
    ("trained_1m_fwd_bwd",
     ["--scene", "trained", "--capacity", "65536", "--iters", "5",
      "--skip-parity"]),
    ("envelope_2pow23_fwd_bwd",
     ["--splats", "8388608", "--capacity", "21760", "--iters", "5",
      "--skip-parity"]),
    ("envelope_2pow23_fwd",
     ["--splats", "8388608", "--capacity", "21760", "--iters", "5",
      "--fwd-only", "--skip-parity"]),
    ("envelope_2pow23_wireframe",
     ["--splats", "8388608", "--wireframe", "--iters", "3"]),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("chiprun_out", "bench_extra.json"))
    args = ap.parse_args()
    out = {
        "note": "all beauty-pass rows use the production config "
                "(payload packed, eps 1e-3 < 1/4 8-bit LSB, tuned budget) "
                "and report dropped_pairs so every number is zero-drop "
                "honest",
    }
    failed = False
    for name, extra in RUNS:
        cmd = [sys.executable, os.path.join(ROOT, "bench.py")] + extra
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                           timeout=900)
        line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        try:
            out[name] = json.loads(line)
        except ValueError:
            out[name] = {"error": (r.stderr or line)[-400:]}
        failed |= r.returncode != 0
        print(name, "->", line[:160], flush=True)
    path = os.path.join(ROOT, args.out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"written": args.out, "ok": not failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
