"""Readings of the check for many seeds in one process, for setting a
cell's limits: for each seed the cell's set-up, what its check reads
(without a timed window), and the numbers the check compares for the
program and for the control (the reference in float8 in the program's
place). One JSON line a seed.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--fault <name>] [--no-control] [--dtype float32]

``--dtype float32`` runs the program on its float32 path with TF32 off
(a witness to what bfloat16's rounding alone does). Runs on a CUDA card;
the CPU tests call :func:`readings` with a tiny configuration.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402


def readings(cell, seed: int, device: str, control: bool = True) -> dict:
    import torch
    run = harness.Run(cell, seed, 0.0, False, device=device)
    ctx = cell.driver.prepare(run)
    cell.driver.probe(run, ctx)
    out = cell.driver.check(run, ctx, control=control)
    del ctx
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def patched(owner, name: str, value):
    """``owner.name`` set to ``value`` inside, restored on exit."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def altered_answers():
    """an answer altered where it is made: STiL's eval step returns its
    multimodal probabilities rolled by one class"""
    from stil_tta_torch.algorithms.stil import STiL
    make = STiL.make_eval_step

    def make_altered(self):
        step = make(self)

        def altered(cache, idx, w=None):
            out = step(cache, idx, w)
            out["prob_m"] = out["prob_m"].roll(1, dims=1)
            return out
        return altered
    return patched(STiL, "make_eval_step", make_altered)


def half_batch():
    """half of each batch left out: STiL's train step runs on the first
    half of its labelled and unlabelled rows, its mean over them"""
    from stil_tta_torch.algorithms.stil import STiL
    make = STiL.make_train_step

    def make_half(self):
        step = make(self)

        def half(state, cache_l, cache_u, idx_l, idx_u, epoch, **kw):
            return step(state, cache_l, cache_u,
                        idx_l[:max(1, idx_l.shape[0] // 2)],
                        idx_u[:idx_u.shape[0] // 2], epoch, **kw)
        return half
    return patched(STiL, "make_train_step", make_half)


def half_tta_batch():
    """half of each batch left out in TTA: every statistics and entropy
    batch keeps its first half of rows"""
    from stil_tta_torch.tta import tent
    batches = tent.tta_batches

    def half(cache, batch_size, seed=0):
        for images, tab, missing in batches(cache, batch_size, seed):
            h = max(1, images.shape[0] // 2)
            yield (images[:h], tab[:h],
                   None if missing is None else missing[:h])
    return patched(tent, "tta_batches", half)


def frozen_tent():
    """a Tent step that returns its state unchanged: the optimizer zeroes
    the gradients before each Adam step, which then moves nothing"""
    from stil_tta_torch.tta import tent
    build = getattr(tent.build_optimizer, "build", tent.build_optimizer)

    def frozen(params, *args, **kwargs):
        params = list(params)
        opt = build(params, *args, **kwargs)
        step = opt.step

        def still(*a, **k):
            for q in params:
                if q.grad is not None:
                    q.grad.zero_()
            return step(*a, **k)
        opt.step = still
        return opt
    return patched(tent, "build_optimizer", frozen)


FAULTS = {"answer": altered_answers, "half": half_batch,
          "tta_half": half_tta_batch, "tta_frozen": frozen_tent}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS),
                    help="plant a fault under the timed path: "
                    + "; ".join(f"{k}: {f.__doc__.split(':')[0]}"
                                for k, f in sorted(FAULTS.items())))
    ap.add_argument("--no-control", action="store_true",
                    help="read the program alone")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="the program's compute type (float32: TF32 off)")
    args = ap.parse_args(argv)
    spec = harness.load_json(BENCH.parent / "BENCHMARK.json")
    cell = harness.Cell(spec, args.workload)
    if args.dtype == "float32":
        import torch
        import system
        system.COMPUTE_DTYPE["dtype"] = torch.float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
        for seed in (int(s) for s in args.seeds.split(",")):
            out = readings(cell, seed, "cuda:0", not args.no_control)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
