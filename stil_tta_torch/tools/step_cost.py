"""One eager train step's cost on the card at full width: host clock,
device busy time and kernel launches.

    python stil_tta_torch/tools/step_cost.py [--config-name NAME]
        [--steps N] [--plain-optimizer] [key=value ...]

Run as a file (not with ``-m``), it measures the ``stil_tta_torch`` that
comes first on ``PYTHONPATH``, so that two checkouts of the package (a
change and its parent) can be held side by side, each in a process of its
own, on the same config, seed and batch. The step is ``chip_smoke.py``'s
phase-8 step: the DVM widths (ResNet-50 on 128² images, a 4-layer tabular
transformer at d = 512, 286 classes, batch 512 = 64 + 448) with seeded
random weights, the first rows of each split, epoch 1 (past
``start_epoch``), bfloat16. One warm-up step, ``--steps`` steps on the
host's clock (each synchronised; the median is reported), then one under
the profiler (its kernels and their device time). ``--plain-optimizer``
gives the state an optimizer built without ``capturable`` (only where the
package has that option). Prints one JSON line; card only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

OVERRIDES = [
    "dataset=synthetic_dvm", "num_classes=286", "batch_size=512",
    "synthetic_labelled=512", "synthetic_unlabelled=3584",
    "synthetic_val=64", "synthetic_test=64", "start_epoch=0",
    "strict_prototypes=false", "lr_eval=1.0e-4",
]


def measure(config_name: str, overrides, steps: int,
            plain_optimizer: bool) -> dict:
    import stil_tta_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from stil_tta_torch.algorithms.registry import get_algorithm
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.train import optim
    dev = torch.device("cuda", 0)
    cfg = load_config(config_name, OVERRIDES + list(overrides))
    src = load_sources(cfg)
    src_l, src_u = src["train_labelled"], src["train_unlabelled"]
    if cfg.algorithm_name == "SimMatch" and not cfg.K:
        cfg.K = len(src_l)
    algo = get_algorithm(cfg.algorithm_name)(cfg, src_l.field_lengths,
                                             dtype=torch.bfloat16, device=dev)
    state = algo.init_state(0)
    if plain_optimizer:
        state.optimizer = optim.build_optimizer(
            state.net.parameters(), float(cfg.lr_eval),
            float(cfg.weight_decay_eval or 0.0),
            frozen=optim.frozen_parameters(cfg, state.net),
            mu_dtype=getattr(cfg, "adam_mu_dtype", None), capturable=False)
    step = algo.make_train_step()
    b_l = int(cfg.batch_size) // (1 + int(cfg.unlabelled_ratio))
    batch = (DeviceCache(src_l, device=dev).as_dict(),
             DeviceCache(src_u, device=dev).as_dict(),
             torch.arange(b_l, device=dev),
             torch.arange(int(cfg.batch_size) - b_l, device=dev))
    step(state, *batch, 1)
    torch.cuda.synchronize()
    host = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(state, *batch, 1)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, *batch, 1)
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(  # noqa: E731
        e, "device_time_total", getattr(e, "cuda_time_total", 0))
    # kernels only: the optimizer's range also appears on the device
    # timeline and would count its kernels twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    groups = state.optimizer.param_groups
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"package": stil_tta_torch.__file__, "config": config_name,
            "overrides": list(overrides), "optimizer": type(
                state.optimizer).__name__,
            "capturable": bool(groups[0].get("capturable", False)),
            "lr_is_tensor": isinstance(groups[0]["lr"], torch.Tensor),
            "host_ms": host, "host_ms_median": statistics.median(host),
            "busy_ms": sum(dev_time(e) for e in events) / 1e3,
            "kernel_launches": sum(e.count for e in events),
            "card": smi.strip()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-name", default="config_dvm_STiL")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--plain-optimizer", action="store_true")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_cost: needs a CUDA card")
    print(json.dumps(measure(args.config_name, args.overrides, args.steps,
                             args.plain_optimizer)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
