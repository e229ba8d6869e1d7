"""CLI entry point of the port (the counterpart of the repo's ``run.py``).

    python -m stil_tta_torch.run --config-name config_dvm_STiL \
        dataset=synthetic_dvm test=True tta=True tta_strategy=bn_adapt

``test=True`` runs the test entry point (BN-adapt TTA, then scoring) on the
card; ``--device cpu`` runs it on the CPU. ``checkpoint=`` takes a
reference-layout torch ``.ckpt``. Training (``evaluate=True``) and resume
are still to port.
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config-name", required=True)
    parser.add_argument("--config-dir", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    args = parser.parse_args(argv)

    from stil_tta_torch.config import load_config
    cfg = load_config(args.config_name, overrides=args.overrides,
                      config_dir=args.config_dir)
    if cfg.resume_training and cfg.checkpoint:
        raise NotImplementedError("resume_training is not ported to "
                                  "stil_tta_torch yet (ROADMAP.md)")
    if not cfg.test:
        if cfg.evaluate:
            raise NotImplementedError(
                "evaluate=True (training) is not ported to stil_tta_torch "
                "yet: it is the next slice of ROADMAP.md")
        raise SystemExit("Set test=True")
    np.random.seed(int(cfg.seed or 0))

    from stil_tta_torch.train.test import test
    seeds = [int(cfg.seed or 0)]
    if cfg.run_all_seeds and cfg.seeds:
        seeds = [int(s) for s in cfg.seeds]
    all_results = []
    base_logdir = cfg.logdir
    for seed in seeds:
        run_cfg = cfg.copy()
        run_cfg.seed = seed
        run_name = f"{cfg.algorithm_name}_{cfg.dataset_name}_{seed}"
        run_cfg.logdir = (f"{base_logdir}_{seed}" if base_logdir
                          and len(seeds) > 1
                          else base_logdir or str(Path("runs") / run_name))
        results = test(run_cfg, device=args.device)
        print({"seed": seed, **results})
        all_results.append(results)

    if len(all_results) > 1:
        keys = sorted({k for r in all_results for k in r})
        base = Path(base_logdir or "runs")
        summary = base.with_name(base.name + "_seed_summary.csv")
        with open(summary, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["metric", "mean", "std"]
                       + [f"seed_{s}" for s in seeds])
            for k in keys:
                vals = [float(r[k]) for r in all_results if k in r]
                w.writerow([k, np.mean(vals), np.std(vals)] + vals)
        print(f"seed summary -> {summary}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
