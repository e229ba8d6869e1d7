"""Data-parallel dry run: each case's step on N ranks against the
single-process step at the same global batch (the port of
``__graft_entry__.py:dryrun_multichip``).

    python -m stil_tta_torch.tools.dryrun_multichip --ranks 2 \\
        [--hybrid DxI] [--device cpu|cuda] [--cases STiL SimMatch ...] \\
        [--scale tiny|full] [--out DIR]

It starts ``--ranks`` processes in one ``torch.distributed`` group over
``tcp://localhost`` (``parallel/mesh.py:backend_for``: gloo on the CPU
and where ranks share a card, NCCL where each has its own), on a
``create_mesh`` or, with
``--hybrid DxI``, a ``create_hybrid_mesh(I, D)`` layout, in float64 on
the CPU and float32 on the card. For each case every rank builds the
same seeded state and runs its train steps under the mesh (:data:`STEPS`);
then the same steps run in one process without a mesh. The first step's
gradients, summed over the ranks, must match the single process's within
:data:`GRAD_LIMIT` (the worst parameter's relative L2 gap), and every
leaf of the two states is compared (``train/checkpoint.py:state_tree``):
integers, generator states and counters exactly, floats within the
dtype's tolerance (:data:`TOLERANCE`). The ranks' states must
be bitwise equal to each other, and the case's watched buffers must have
moved. Serving cases compare a data-parallel ``Predictor`` with the
single one on a batch with a padded tail, in float64 on the CPU and
bfloat16 on the card (the serving dtype); ``indivisible`` must raise
``ValueError``. One ``PASS`` or ``FAIL`` line per case; the exit code is
1 if any case failed. ``--out`` gets ``dryrun_<ranks>.json`` with each
case's numbers: the process group's backend, the largest differences
and the gradient gap, the per-rank ``bn_stats`` /
``bn_bwd_reduce`` launches of each step, the host time of each step
(both layouts) and, with ``--profile``, the share of the last
data-parallel step's host time that rank 0 spent in collectives.

``--scale tiny`` (the default) runs the JAX dry run's shapes: ResNet-18
at 32x32, widths 32, global batch 8 per rank (a quarter labelled).
``--scale full`` runs ``config_dvm_STiL``'s own widths (ResNet-50 at
128x128, 4 x 512 tabular layers, 286 classes) at global batch 512 (64 +
448), and serving at 512.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# (label, kind, config, overrides, watched state leaves that must move)
CASES = {c[0]: c for c in (
    # the JAX dry run's families (``DRYRUN_ALGORITHMS``)
    ("STiL", "train", "config_dvm_STiL", (),
     ("prototypes_sum", "prototypes_count")),
    ("STiL_SAINT", "train", "config_dvm_STiL_SAINT", (),
     ("prototypes_sum", "prototypes_count")),
    ("SimMatch", "train", "config_dvm_MultiSimMatch", (),
     ("extra.bank", "extra.bank_labels")),
    ("CoMatch", "train", "config_dvm_MultiCoMatch", (),
     ("extra.queue_s", "extra.queue_w", "extra.hist_prob")),
    ("FreeMatch", "train", "config_dvm_FreeMatch", (),
     ("extra.time_p", "extra.p_model", "extra.label_hist")),
    ("MMatch", "train", "config_dvm_MMatch", (),
     ("extra.embed_queue", "extra.probs_queue", "da.queue")),
    ("CoTrain_Pseudo", "train", "config_dvm_CoTrain", (), ()),
    ("STiL[micro_batches=2]", "train", "config_dvm_STiL",
     ("micro_batches=2",), ("prototypes_sum", "prototypes_count")),
    ("SimMatch[micro_batches=2]", "train", "config_dvm_MultiSimMatch",
     ("micro_batches=2",), ("extra.bank", "extra.bank_labels")),
    ("CoMatch[micro_batches=2]", "train", "config_dvm_MultiCoMatch",
     ("micro_batches=2",), ("extra.queue_s", "extra.queue_w",
                            "extra.hist_prob")),
    # the rest of the registry, int8 and serving
    ("CoTrain_Pseudo_SAINT", "train", "config_dvm_CoTrain_SAINT", (), ()),
    ("Supervised", "train", "config_dvm_STiL",
     ("algorithm_name=Supervised",), ("prototypes_count",)),
    ("TabularEval", "train", "config_dvm_STiL",
     ("algorithm_name=TabularEval", "eval_datatype=tabular"), ()),
    ("STiL[teacher_int8=true]", "train", "config_dvm_STiL",
     ("teacher_int8=true",), ("prototypes_sum",)),
    ("serve", "serve", "config_dvm_STiL", (), ()),
    ("serve[int8]", "serve", "config_dvm_STiL", (), ()),
    ("indivisible", "indivisible", "config_dvm_STiL", (), ()),
)}
# the JAX dry run's list, the default here
DRYRUN_ALGORITHMS = ("STiL", "STiL_SAINT", "SimMatch", "CoMatch", "FreeMatch",
                     "MMatch", "CoTrain_Pseudo", "STiL[micro_batches=2]",
                     "SimMatch[micro_batches=2]", "CoMatch[micro_batches=2]")

TINY = ["dataset=synthetic_dvm", "models=resnet18", "img_size=32",
        "synthetic_image_size=40", "synthetic_labelled=32",
        "synthetic_unlabelled=48", "synthetic_val=8", "synthetic_test=16",
        "num_classes=4", "tabular_embedding_dim=32",
        "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
        "projection_dim=8", "start_epoch=0", "strict_prototypes=false",
        "K=32", "field_lengths=[5,4,2,1,1,1]"]
FULL = ["dataset=synthetic_dvm", "num_classes=286",
        "synthetic_labelled=128", "synthetic_unlabelled=896",
        "synthetic_val=8", "synthetic_test=700", "start_epoch=0",
        "strict_prototypes=false"]
FULL_BATCH = 512            # 64 labelled + 448 unlabelled
# train steps a case: one at the tiny shapes, as the JAX dry run takes;
# two at full width, the second timed warm
STEPS = {"tiny": 1, "full": 2}
SEED = 0
# floats, (rtol, atol). The layouts differ by summation order alone: the
# ranks' BatchNorm and gradient sums add per-rank parts where the single
# process adds all rows at once. BatchNorm's one-pass variance E[x^2] -
# mean^2 (the JAX package's) cancels where a channel's mean is large
# against its spread, and amplifies that last-bit difference: one process
# adding its BatchNorm sums in the two ranks' halves moves Supervised's
# parameters (2 labelled rows a rank) by up to 1.5e-8 relative after two
# float64 steps, hence 1e-7; a per-rank statistic or a gradient summed
# twice is off by order 1. In float32 and bfloat16 (the card: its kernels
# take no float64) the same amplification starts from a far larger
# rounding, and the leaves are held as the JAX dry run holds them
# (``__graft_entry__.py:_assert_tree_equal``): 5e-3 in general, Adam's
# moments by relative L2 below 0.5 (the second moment's square root),
# banks and queues 3e-2, loss sums 5e-2, accuracy counts within 2.
TOLERANCE = {"float64": (1e-7, 1e-10), "float32": (5e-3, 5e-3),
             "bfloat16": (5e-3, 5e-3)}
# the first step's gradients: the largest, over the parameters, of
# |g_ranks - g_single|_2 / |g_single|_2. The gradients come before Adam,
# whose first step moves every parameter by about lr whatever the
# gradient's size, so a fault that the ranks share (a BatchNorm backward
# whose sums stay per rank: the gradient all-reduce keeps the ranks equal)
# shows here in float32 where the parameters cannot show it. Readings of
# the sound layouts / of that fault, 2 ranks: float64 on the CPU at most
# 1.5e-13 / at least 0.75; float32 on an H100 at most 6.1e-3 at the tiny
# shapes and 2.0e-2 at full width (BN biases, whose gradients cancel) /
# at least 0.76 and 5.7.
GRAD_LIMIT = {"float64": 1e-6, "float32": 0.1}
DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config(case, scale: str):
    from stil_tta_torch.config import load_config
    _, _, name, overrides, _ = case
    base = TINY if scale == "tiny" else FULL
    return load_config(name, base + list(overrides))


def leaves(tree, path: str = "") -> Dict[str, np.ndarray]:
    """The leaves of a state tree as numpy arrays, by dotted path."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            out.update(leaves(tree[k], f"{path}.{k}" if path else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{path}.{i}"))
    elif isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()   # numpy copies: the steps work in place
        out[path] = np.array((t.float() if t.dtype == torch.bfloat16
                              else t).numpy())
    elif tree is not None:
        out[path] = np.asarray(tree)
    return out


def digest(tree: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k, v in tree.items():
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def compare(single: Dict[str, np.ndarray], sharded: Dict[str, np.ndarray],
            dtype: str) -> dict:
    """Leaf by leaf: integers and booleans exactly, floats within
    ``TOLERANCE[dtype]`` (below float64 with the JAX dry run's rules for
    moments, buffers, loss sums and counts); the largest differences, by
    kind of leaf."""
    rtol, atol = TOLERANCE[dtype]
    if single.keys() != sharded.keys():
        return {"ok": False, "mismatches": ["leaf names differ: "
                f"{sorted(single.keys() ^ sharded.keys())[:5]}"]}
    bad, worst = [], {}
    for k, a in single.items():
        b = sharded[k]
        if a.shape != b.shape:
            bad.append(f"{k}: shape {a.shape} vs {b.shape}")
            continue
        if not np.issubdtype(a.dtype, np.floating):
            if not np.array_equal(a, b):
                bad.append(f"{k}: integers differ")
            continue
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        diff = np.abs(a64 - b64)
        kind = _kind(k)
        worst[kind] = max(worst.get(kind, 0.0), float(diff.max(initial=0)))
        r, t = rtol, atol
        if dtype != "float64":
            if kind == "optimizer" and k.endswith(("exp_avg", "exp_avg_sq")):
                if k.endswith("exp_avg_sq"):
                    a64, b64 = np.sqrt(np.abs(a64)), np.sqrt(np.abs(b64))
                rel = float(np.linalg.norm(a64 - b64)
                            / max(float(np.linalg.norm(a64)), 1e-6))
                if rel >= 0.5:
                    bad.append(f"{k}: relative L2 {rel:.3g} >= 0.5")
                continue
            if k.startswith("extra."):
                r = t = 3e-2
            elif k.startswith("log_sums."):
                r = t = 5e-2
            elif k.startswith("acc_") and k.endswith(".correct"):
                r, t = 0.0, 2.0
        if not np.all(diff <= t + r * np.abs(a64)):
            i = int(np.argmax(diff - r * np.abs(a64)))
            bad.append(f"{k}: |{a64.flat[i]!r} - {b64.flat[i]!r}| > "
                       f"{t} + {r} x |a|")
    return {"ok": not bad, "mismatches": bad[:10], "leaves": len(single),
            "max_abs_diff": worst, "rtol": rtol, "atol": atol}


def _kind(path: str) -> str:
    if path.startswith(("net.", "ema.")):
        if path.endswith(("running_mean", "running_var")):
            return "running"
        return "params"
    if path.startswith("prototypes_sum"):
        return "prototypes_sum"
    if path.startswith("optimizer."):
        return "optimizer"
    return "other"


def _capture_grads(opt, net, into: dict) -> None:
    """Copy every parameter's gradient into ``into``, by name, when
    ``opt.step`` next runs (``train/optim.py:step`` has summed them over
    the ranks by then), and step on."""
    names = {id(p): n for n, p in net.named_parameters()}

    def step(*args, **kwargs):
        del opt.step   # the class's step again
        for gi, group in enumerate(opt.param_groups):
            for j, p in enumerate(group["params"]):
                if p.grad is not None:
                    into[names.get(id(p), f"group{gi}.{j}")] = leaves(
                        p.grad, "g")["g"]
        return opt.step(*args, **kwargs)

    opt.step = step


def grad_gap(single: Dict[str, np.ndarray],
             sharded: Dict[str, np.ndarray]) -> dict:
    """The worst parameter's relative L2 gap between two sets of
    gradients, and the five worst, by name."""
    if single.keys() != sharded.keys():
        return {"grad_gap": float("inf"), "grad_worst": [["names differ", 0]]}
    gaps = []
    for k, a in single.items():
        a, b = a.astype(np.float64), sharded[k].astype(np.float64)
        na, d = float(np.linalg.norm(a)), float(np.linalg.norm(a - b))
        gaps.append((d / na if na else (float("inf") if d else 0.0), k))
    gaps.sort(reverse=True)
    return {"grad_gap": gaps[0][0] if gaps else 0.0,
            "grad_worst": [[k, g] for g, k in gaps[:5]]}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> Tuple[int, int]:
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    return bn_stats.launches, bn_bwd_reduce.launches


def run_train(case, scale: str, device: torch.device, dtype: torch.dtype,
              mesh=None, profile: bool = False, rows: Optional[Tuple] = None
              ) -> dict:
    """The train steps of ``case`` from the seeded state, under ``mesh``
    if given; the state's leaves before and after, the first step's
    gradients, each step's launches and host time."""
    from stil_tta_torch.algorithms.registry import get_algorithm
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.parallel import replicate
    from stil_tta_torch.train.checkpoint import state_tree
    cfg = _config(case, scale)
    src = load_sources(cfg)
    src_l, src_u = src["train_labelled"], src["train_unlabelled"]
    if cfg.algorithm_name == "SimMatch":
        cfg.K = len(src_l)   # the bank holds the labelled set, as evaluate
    algo = get_algorithm(cfg.algorithm_name)(cfg, src_l.field_lengths,
                                             dtype=dtype, device=device)
    cache_l = DeviceCache(src_l, device=device).as_dict()
    cache_u = DeviceCache(src_u, device=device).as_dict()
    state = algo.init_state(SEED)
    if mesh is not None:
        replicate(mesh, state.net)
    out = {"launches": [], "host_ms": [], "grads": {},
           "init": leaves(state_tree(state))}
    _capture_grads(state.optimizer, state.net, out["grads"])
    step = algo.make_train_step()
    b_l, b_u = rows
    torch.manual_seed(SEED)   # the dropout masks' generator
    rs = np.random.RandomState(0)
    steps = STEPS[scale]
    for i in range(steps):
        idx_l = torch.as_tensor(rs.randint(0, len(src_l), b_l),
                                device=device)
        idx_u = torch.as_tensor(rs.randint(0, len(src_u), b_u),
                                device=device)
        prof = None
        if profile and i == steps - 1:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU])
            prof.__enter__()
        _sync(device)
        l0, t0 = _launches(), time.perf_counter()
        if mesh is None:
            step(state, cache_l, cache_u, idx_l, idx_u, 1)
        else:
            with mesh:
                step(state, cache_l, cache_u, idx_l, idx_u, 1)
        _sync(device)
        dt = time.perf_counter() - t0
        l1 = _launches()
        out["host_ms"].append(dt * 1e3)
        out["launches"].append([l1[0] - l0[0], l1[1] - l0[1]])
        if prof is not None:
            prof.__exit__(None, None, None)
            out["collectives"] = _collective_share(prof, dt)
    out["tree"] = leaves(state_tree(state))
    out["config"] = {"saint_ff_dropout": cfg.saint_ff_dropout,
                     "micro_batches": cfg.micro_batches,
                     "teacher_int8": cfg.teacher_int8}
    return out


def _collective_share(prof, step_s: float) -> dict:
    """The host time of the profiled step spent in collectives: the CPU
    time of the ``dp.all_reduce`` and ``dp.all_gather`` ranges
    (``parallel/collectives.py``; each collective, its wait included)
    over the step's wall time."""
    events = [e for e in prof.key_averages() if e.key.startswith("dp.")]
    ms = sum(e.cpu_time_total for e in events) / 1e3
    return {"ms": ms, "share": ms / (step_s * 1e3),
            "calls": {e.key: e.count for e in events}}


def run_serve(case, scale: str, device: torch.device, dtype: torch.dtype,
              mesh=None) -> np.ndarray:
    """The probabilities of a seeded STiL net's ``Predictor`` (int8 for
    ``serve[int8]``) over the test split, whose last batch is padded;
    under ``mesh`` data-parallel."""
    from stil_tta_torch.algorithms.registry import get_algorithm
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.serve import Predictor
    cfg = _config(case, scale)
    src = load_sources(cfg)["test"]
    algo = get_algorithm(cfg.algorithm_name)(cfg, src.field_lengths,
                                             dtype=dtype, device=device)
    algo.init_state(SEED)
    batch = 5 if scale == "tiny" else FULL_BATCH
    if mesh is None:
        batch = -(-batch // _ranks()) * _ranks()
    pred = Predictor(algo, batch, int8=case[0].endswith("[int8]"),
                     mesh=mesh)
    assert len(src) % pred.batch_size, "the test split must leave a tail"
    return pred(np.asarray(src.images), src.tabular)


def _ranks() -> int:
    return torch.distributed.get_world_size()


def _rows(scale: str, world: int) -> Tuple[int, int]:
    if scale == "full":
        return FULL_BATCH // 8, FULL_BATCH - FULL_BATCH // 8
    return 2 * world, 6 * world


def worker(rank: int, args) -> None:
    """One rank: every case under the mesh, then the single-process runs
    it is given (on the CPU rank r takes every r-th case, so the ranks run
    them side by side; on the card rank 0 takes them all, so no other
    rank's work shares the card while a reference is timed). Rank 0
    writes the results."""
    from stil_tta_torch.parallel import (create_hybrid_mesh, create_mesh,
                                         init_process_group)
    dev = init_process_group(args.device, rank, args.ranks, args.address)
    if dev.type == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(1)
    else:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.hybrid:
        dcn, ici = (int(v) for v in args.hybrid.split("x"))
        mesh = create_hybrid_mesh(ici, dcn)
    else:
        mesh = create_mesh()
    dtype = DTYPES[args.dtype]
    rows = _rows(args.scale, args.ranks)
    results, sharded = [], {}
    for label in args.cases:
        case = CASES[label]
        kind = case[1]
        res = {"case": label, "kind": kind, "ranks": args.ranks,
               "mesh": list(mesh.shape), "dtype": args.dtype,
               "backend": torch.distributed.get_backend()}
        if kind == "train":
            dp = run_train(case, args.scale, dev, dtype, mesh, args.profile,
                           rows)
            sharded[label] = dp["tree"], dp["grads"]
            res["ranks_equal"] = _all_equal(digest(dp["tree"]))
            res["launches_by_rank"] = _gather(dp["launches"])
            res["host_ms"] = dp["host_ms"]
            res["collectives"] = dp.get("collectives")
            res["config"] = dp["config"]
        elif kind == "serve":
            res["dtype"] = args.serve_dtype
            probs = run_serve(case, args.scale, dev, DTYPES[res["dtype"]],
                              mesh)
            sharded[label] = probs
            res["ranks_equal"] = _all_equal(
                hashlib.sha256(probs.tobytes()).hexdigest())
        else:   # indivisible: one labelled row more than the ranks share
            try:
                run_train(case, args.scale, dev, dtype, mesh, False,
                          (rows[0] + 1, rows[1]))
                raised = ""
            except ValueError as e:
                raised = str(e)
            res["raised"] = _gather(raised)
            res["ok"] = all(res["raised"])
        results.append(res)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    mine = [i for i in range(len(results))
            if (i % args.ranks if dev.type == "cpu" else 0) == rank]
    for i in mine:
        res = results[i]
        case = CASES[res["case"]]
        if res["kind"] == "train":
            single = run_train(case, args.scale, dev, dtype, None, False,
                               rows)
            res["host_ms_single"] = single["host_ms"]
            res["launches_single"] = single["launches"]
            tree, grads = sharded[res["case"]]
            res.update(compare(single["tree"], tree, args.dtype))
            res.update(grad_gap(single["grads"], grads),
                       grad_limit=GRAD_LIMIT[args.dtype])
            res["unmoved"] = _unmoved(case, single["init"], single["tree"])
            res["ok"] = (res["ok"] and res["ranks_equal"]
                         and res["grad_gap"] <= res["grad_limit"]
                         and not res["unmoved"])
        elif res["kind"] == "serve":
            probs = sharded[res["case"]]
            base = run_serve(case, args.scale, dev, DTYPES[res["dtype"]],
                             None)
            rtol, atol = TOLERANCE[res["dtype"]]
            res.update(max_abs_diff=float(np.abs(probs - base).max()),
                       argmax_equal=bool((probs.argmax(1)
                                          == base.argmax(1)).all()),
                       atol=atol, rows=len(probs))
            res["ok"] = bool(res["ranks_equal"] and res["argmax_equal"]
                             and np.allclose(probs, base, rtol, atol))
    done = _gather({i: results[i] for i in mine})
    if rank == 0:
        for part in done:
            for i, res in part.items():
                results[i] = res
        for res in results:
            print(json.dumps(res), flush=True)
        Path(args.out).mkdir(parents=True, exist_ok=True)
        Path(args.out, f"dryrun_{args.ranks}.json").write_text(
            json.dumps(results, indent=1))
    torch.distributed.destroy_process_group()


def _gather(obj) -> list:
    out = [None] * _ranks()
    torch.distributed.all_gather_object(out, obj)
    return out


def _all_equal(obj) -> bool:
    return len(set(_gather(obj))) == 1


def _unmoved(case, init, tree) -> List[str]:
    """The watched leaves (and the parameters) that the steps left
    where the seeded state had them."""
    watched = list(case[4])
    unmoved = [w for w in watched
               if not any(k.startswith(w) and not np.array_equal(v, init[k])
                          for k, v in tree.items())]
    if all(np.array_equal(v, init[k]) for k, v in tree.items()
           if k.startswith("net.") and k in init):
        unmoved.append("net")
    return unmoved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--hybrid", default="",
                    help="DxI: a create_hybrid_mesh(I, D) layout")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--scale", default="tiny", choices=("tiny", "full"))
    ap.add_argument("--cases", nargs="*", default=list(DRYRUN_ALGORITHMS),
                    help=f"of {', '.join(CASES)}; 'all' for every case")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default="",
                    help="directory for dryrun_<ranks>.json (default: a "
                         "new temporary one)")
    args = ap.parse_args(argv)
    if args.cases == ["all"]:
        args.cases = list(CASES)
    unknown = [c for c in args.cases if c not in CASES]
    if unknown:
        ap.error(f"unknown cases {unknown}")
    if args.hybrid:
        dcn, ici = (int(v) for v in args.hybrid.split("x"))
        if dcn * ici != args.ranks:
            ap.error(f"--hybrid {args.hybrid} needs {dcn * ici} ranks")
    # the card's kernels take no float64; serving on the card is bf16
    args.dtype = "float64" if args.device == "cpu" else "float32"
    args.serve_dtype = "float64" if args.device == "cpu" else "bfloat16"
    args.address = f"tcp://localhost:{_free_port()}"
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA card", file=sys.stderr)
        return 1
    args.out = args.out or tempfile.mkdtemp(prefix="dryrun_")
    import torch.multiprocessing as mp
    # the ranks print one JSON line a case (rank 0); the summary follows
    ctx = mp.start_processes(worker, args=(args,), nprocs=args.ranks,
                             join=False, start_method="spawn")
    try:
        while not ctx.join():
            pass
    except Exception as e:   # a rank failed: the others were stopped
        print(f"dryrun_multichip: {e}", file=sys.stderr)
        return 1
    results = json.loads(Path(args.out, f"dryrun_{args.ranks}.json")
                         .read_text())
    failed = 0
    for r in results:
        tag = "PASS" if r["ok"] else "FAIL"
        failed += not r["ok"]
        print(f"dryrun_multichip({args.ranks}) {r['case']}: {tag}; "
              f"mesh={r['mesh']} dtype={r['dtype']} "
              + (f"leaves={r.get('leaves')} "
                 f"max_abs_diff={r.get('max_abs_diff')} "
                 f"grad_gap={r.get('grad_gap')} "
                 f"ranks_equal={r.get('ranks_equal')}"
                 if r["kind"] == "train" else
                 f"max_abs_diff={r.get('max_abs_diff')} "
                 f"argmax_equal={r.get('argmax_equal')}"
                 if r["kind"] == "serve" else
                 f"raised={bool(r['ok'])}"), flush=True)
        for m in r.get("mismatches", []):
            print(f"  {m}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
