"""Bitwise-repeat check of the two BN reduction kernels on the card.

Calls ``bn_stats`` and ``bn_bwd_reduce`` ``--repeats`` times on the same
inputs at every (M, C) that their card tests use (ResNet-50's BN shapes
at batch 512, 256, 64 and 32, the tail and odd shapes, M below, at and
just past one ring stage), in bfloat16 and float32, on aligned inputs
and on views one element off 16-byte alignment (the direct-load
variant), and asserts that every call gives the first call's sums bit
for bit. Both kernels add their partial rows in a fixed order, so any
difference is a fault (a race in the ring or the combine). A mismatch is
printed with its shape, dtype and plan. Card only:

    python -m stil_tta_torch.tools.bn_repeat [--repeats 20]

Prints one JSON line: the calls made, the shapes, the mismatches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from stil_tta_torch.ops.batch_norm import (bn_bwd_reduce, bn_bwd_reduce_plan,
                                           bn_stats, bn_stats_plan, bwd_plan,
                                           stats_plan)

RESNET50_SHAPES = [
    (2_097_152, 64), (524_288, 64), (524_288, 256), (524_288, 128),
    (131_072, 128), (131_072, 512), (131_072, 256), (32_768, 256),
    (32_768, 1024), (32_768, 512), (8_192, 512), (8_192, 2048),
]
ODD_SHAPES = [(300 * 4096, 64), (300 * 16, 2048), (7, 3), (1000, 24)]
SMALL_BATCH_SHAPES = sorted({(m * b // 512, c) for m, c in RESNET50_SHAPES
                             for b in (256, 64, 32)} - set(RESNET50_SHAPES),
                            reverse=True)


def shapes(itemsize: int):
    out = RESNET50_SHAPES + ODD_SHAPES + SMALL_BATCH_SHAPES
    for plan in (stats_plan, bwd_plan):
        for c in (64, 2048):
            rows = plan(1, c, itemsize, True, 1, 1).stage_rows
            out += [(1, c), (rows - 1, c), (rows, c), (rows + 1, c)]
    return sorted(set(out), reverse=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bn_repeat: no CUDA card", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = 0
    checked = []
    bad = []
    for dtype in (torch.bfloat16, torch.float32):
        itemsize = torch.empty((), dtype=dtype).element_size()
        for m, c in shapes(itemsize):
            for offset in (0, 1):
                def rand(shift):
                    t = torch.randn(m * c + offset, generator=gen,
                                    device="cuda") + shift
                    return t.to(dtype)[offset:].view(m, c)
                x, dy = rand(0.5), rand(0.0)
                mean = torch.rand(c, generator=gen, device="cuda")
                inv = torch.rand(c, generator=gen, device="cuda") + 0.5
                runs = {
                    "bn_stats": (lambda: bn_stats(x),
                                 lambda: bn_stats_plan(x)),
                    "bn_bwd_reduce": (
                        lambda: bn_bwd_reduce(x, dy, mean, inv),
                        lambda: bn_bwd_reduce_plan(x, dy)),
                }
                for name, (call, plan) in runs.items():
                    first = torch.cat(call(), 0).clone()
                    outs = [torch.cat(call(), 0).clone()
                            for _ in range(args.repeats - 1)]
                    torch.cuda.synchronize()
                    calls += args.repeats
                    for i, o in enumerate(outs, 1):
                        if not torch.equal(o, first):
                            bad.append({
                                "kernel": name, "m": m, "c": c,
                                "dtype": str(dtype), "offset": offset,
                                "call": i,
                                "max_abs_diff": float(
                                    (o - first).abs().max()),
                                "plan": dataclasses.asdict(plan())})
                checked.append([str(dtype).split(".")[-1], m, c, offset])
                del x, dy
    print(json.dumps({"bn_repeat": {"repeats": args.repeats, "calls": calls,
                                    "cases": len(checked) * 2,
                                    "mismatches": bad},
                      "device": torch.cuda.get_device_name(0)}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
