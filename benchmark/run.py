"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. With ``--trace 0`` the last line of standard
output is the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (the window under the profiler); both carry
``correct``, which the plain reference decides after the window, and
the numbers compared with their limits (``checks``), which also end
standard error. The run exits non-zero, printing no result, without a
CUDA card, without the port's package, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    args = parse(argv)
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(spec, args.workload)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: this cell needs {chips} CUDA card(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import stil_tta_torch  # noqa: F401  (the system under test)
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda:0")
    run.phase("interpreter, imports")
    torch.zeros(1, device="cuda:0")
    run.phase("CUDA context")
    cell.driver.run(run)
    found = harness.forbidden_modules()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    result = run.result(info)
    print(f"card: {power_limit()}", file=sys.stderr)
    print(f"setup phases (s): {json.dumps(run.phases)}", file=sys.stderr)
    spans = {k: [len(v), sum(v)] for k, v in run.spans.items()}
    print(f"setup_s {run.setup_s!r} window_s {run.window_s!r} counts "
          f"{json.dumps(run.counts)} spans {json.dumps(spans)}",
          file=sys.stderr)
    print(harness.checks_text(run.checks), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
