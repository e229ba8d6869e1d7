#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Run from the root of the repository. It needs a CUDA card and fails
without one; it never runs on the CPU. Phases, each fatal on failure:

1. Device: name, count, and ``nvidia-smi`` name and power limit.
2. Build: ``csrc/bn_stats.cu`` with ``nvcc`` for sm_90a; build time and
   the compiler's register / shared-memory / spill report.
3. Kernel against plain: ``bn_stats`` against ``bn_stats_plain`` at every
   distinct (M, C) of ResNet-50's BatchNorms at batch 512 and 128x128,
   in bfloat16 and float32, and two launches bitwise equal.
4. The slice at full width: ``config_dvm_STiL dataset=synthetic_dvm
   num_classes=286 synthetic_test=2048 batch_size=512 test=True tta=True
   tta_strategy=bn_adapt`` through ``train.test.test`` (ResNet-50, 4-layer
   tabular transformer at d=512, one fusion layer, seeded random
   weights), with the kernel's launch count, wall time and peak memory;
   then the same adaptation with the kernel and with the plain statistics
   side by side.
5. Serving: ``Predictor`` at batch 512, samples/s.
6. Timing: per shape, the kernel, its device-memory bound, the plain
   version and ``torch.batch_norm_stats`` (the library yardstick, never
   called by the port), with the L2 cache flushed before every launch.

Float32 convolutions and matmuls run in full float32 here (TF32 off), so
float32 comparisons are not blurred by TF32 rounding. The second-to-last
line is the kernels' JSON record and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import copy
import json
import math
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
BATCH, IMG = 512, 128
TOL = 1e-5                  # of sum|x| (of sum x^2 for the squares)


def log(*args):
    print(*args, flush=True)


def resnet50_bn_shapes(device) -> list:
    """(M, C) of each of ResNet-50's BatchNorm inputs at BATCH and IMG,
    in forward order, read off the tower with forward hooks."""
    from stil_tta_torch.models.resnet import resnet50
    from stil_tta_torch.ops.batch_norm import BatchNorm2d
    tower = resnet50(dtype=torch.bfloat16).to(device).eval()
    seen = []
    for m in tower.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(
                lambda mod, inp: seen.append(
                    (BATCH * inp[0].shape[2] * inp[0].shape[3],
                     inp[0].shape[1])))
    with torch.no_grad():
        tower(torch.zeros(1, IMG, IMG, 3, device=device))
    return seen


def time_ms(fn, x, buf, reps=50) -> float:
    """Mean device time of ``fn(x)``, each call after an L2 flush (a
    write of ``buf``). A spin kernel first gives the card a head start,
    so the host queues every call before the card reaches them and the
    span holds no host time; the flushes' own span, measured the same
    way, is subtracted."""
    def span(body) -> float:
        body()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms of spinning
        start.record()
        for _ in range(reps):
            body()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    flush = span(buf.zero_)
    both = span(lambda: (buf.zero_(), fn(x)))
    return (both - flush) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)

    # ---- 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {kind} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    # ---- 2. build
    from stil_tta_torch.ops import cuda_build
    t0 = time.perf_counter()
    lib = cuda_build.build("bn_stats")
    build_s = time.perf_counter() - t0
    log(f"[build] {lib.name} in {build_s:.2f} s")
    for line in cuda_build.build_log("bn_stats").splitlines():
        if "Used" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # ---- 3. kernel against plain at every ResNet-50 BN shape
    from stil_tta_torch.ops.batch_norm import bn_stats, bn_stats_plain
    shapes = resnet50_bn_shapes(dev)
    assert len(shapes) == 53, len(shapes)
    per_forward = collections.Counter(shapes)
    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for m, c in per_forward:
            x = (torch.randn(m, c, generator=gen, device=dev)
                 + 0.5).to(dtype)
            s, ss = bn_stats(x)
            s2, ss2 = bn_stats(x)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(s, s2) and torch.equal(ss, ss2))
            ps, pss = bn_stats_plain(x)
            scale = x.float().abs().sum(0, keepdim=True)
            rel = max(float(((s - ps).abs() / scale).max()),
                      float(((ss - pss).abs() / pss).max()))
            abs_err = max(float((s - ps).abs().max()),
                          float((ss - pss).abs().max()))
            max_abs = max(max_abs, abs_err)
            ok = bitwise and rel < TOL
            log(f"[kernel] {str(dtype)[6:]:8s} M={m:>9,d} C={c:>5d} "
                f"max rel err {rel:.2e} (tol {TOL:.0e}) abs {abs_err:.3e} "
                f"bitwise-repeat {bitwise}")
            if not ok:
                raise SystemExit(f"bn_stats disagrees at {(m, c, dtype)}")
            del x

    # ---- 4. the slice at full width
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.train.test import build_algo, load_test_split, test
    from stil_tta_torch.tta import adapt
    overrides = ["dataset=synthetic_dvm", "num_classes=286",
                 "synthetic_test=2048", "batch_size=512", "test=True",
                 "tta=True", "tta_strategy=bn_adapt",
                 "enable_progress_bar=false",
                 "logdir=runs/chip_smoke"]
    cfg = load_config("config_dvm_STiL", overrides)
    log(f"[slice] {cfg.model} img {cfg.img_size} tabular "
        f"{cfg.tabular_transformer_num_layers}x{cfg.tabular_embedding_dim} "
        f"fusion {cfg.multimodal_transformer_num_layers}x"
        f"{cfg.multimodal_embedding_dim} classes {cfg.num_classes} "
        f"batch {cfg.batch_size} test {cfg.synthetic_test}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bn_stats.launches = 0
    t0 = time.perf_counter()
    metrics = test(cfg.copy(), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bn_stats.launches
    peak = torch.cuda.max_memory_allocated()
    stats_batches = math.ceil(int(cfg.synthetic_test) / int(cfg.batch_size))
    log(f"[slice] metrics {json.dumps(metrics)}")
    log(f"[slice] bn_stats launches {launches} (53 x {stats_batches} stats "
        f"batches = {53 * stats_batches}); wall {wall:.3f} s "
        f"(first call: includes data synthesis, weight init and cuDNN "
        f"warm-up); peak memory {peak / 2**30:.3f} GiB")
    if launches != 53 * stats_batches:
        raise SystemExit("bn_stats launch count off the main path")
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0
               for v in metrics.values()):
        raise SystemExit(f"bad test metrics {metrics}")

    # same adaptation, kernel statistics against plain statistics
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, "cuda")
    cache = DeviceCache(src, device="cuda").as_dict()
    init_state = copy.deepcopy(algo.net.state_dict())
    step = algo.make_eval_step()
    idx = torch.arange(int(cfg.batch_size), device=dev)
    runs = {}
    for name, fn in (("kernel", bn_stats), ("plain", bn_stats_plain)):
        algo.net.load_state_dict(init_state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adapt(cfg, algo, cache, stats=fn)
        torch.cuda.synchronize()
        t_adapt = time.perf_counter() - t0
        t0 = time.perf_counter()
        prob = step(cache, idx)["prob_m"].float()
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t0
        bufs = {k: v.float().clone() for k, v in
                algo.net.state_dict().items() if k.endswith(
                    ("running_mean", "running_var"))}
        runs[name] = (bufs, prob, t_adapt, t_eval)
        log(f"[slice] adapt with {name} statistics: {t_adapt * 1e3:.1f} ms "
            f"({stats_batches} batches), eval batch {t_eval * 1e3:.1f} ms")
    kb, kp = runs["kernel"][:2]
    pb, pp = runs["plain"][:2]
    # a running mean's difference in units of its channel's std, a
    # running variance's relative to itself
    d_mean = max(float(((kb[k] - pb[k]).abs()
                        / pb[k[:-4] + "var"].clamp_min(1e-12).sqrt()).max())
                 for k in kb if k.endswith("mean"))
    d_var = max(float(((kb[k] - pb[k]).abs() / pb[k].clamp_min(1e-12)).max())
                for k in kb if k.endswith("var"))
    d_prob = float((kp - pp).abs().max())
    finite = all(bool(torch.isfinite(v).all()) for v in kb.values())
    rows = float((kp.sum(1) - 1).abs().max())
    log(f"[slice] adapted running stats, kernel vs plain ({len(kb)} "
        f"buffers): max |d mean|/std {d_mean:.3e}, max |d var|/var "
        f"{d_var:.3e}; prob_m max abs diff {d_prob:.3e}; prob rows sum to "
        f"1 within {rows:.1e}")
    if not finite or not bool(torch.isfinite(kp).all()) or rows > 1e-3:
        raise SystemExit("non-finite adapted statistics or probabilities")
    # bfloat16 activations: the two runs differ only by float32 summation
    # order in the statistics, which can flip a bf16 rounding of a
    # channel's mean or variance (0.4%) and then carries through the
    # following layers
    if max(d_mean, d_var) > 0.1 or d_prob > 0.05:
        raise SystemExit("kernel and plain adaptation disagree")

    # where the BN-adapt pass spends device time
    from torch.profiler import ProfilerActivity, profile
    algo.net.load_state_dict(init_state)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        adapt(cfg, algo, cache)
        torch.cuda.synchronize()
    # kernel events only: operator rows repeat their kernels' time
    dev_time = lambda e: getattr(  # noqa: E731
        e, "device_time_total", getattr(e, "cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_time(e) for e in events)
    bn_us = sum(dev_time(e) for e in events if "bn_stats" in e.key)
    log(f"[profile] BN-adapt pass: device busy {busy_us / 1e3:.3f} ms, "
        f"bn_stats kernels {bn_us / 1e3:.3f} ms "
        f"({bn_us / max(busy_us, 1e-9):.1%})")
    top = sorted(events, key=dev_time, reverse=True)[:8]
    for e in top:
        log(f"[profile]   {dev_time(e) / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")

    # ---- 5. serving
    from stil_tta_torch.serve import Predictor
    import numpy as np
    pred = Predictor(algo, batch_size=512)
    images, tabular = np.asarray(src.images), np.asarray(src.tabular)
    pred(images[:512], tabular[:512])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = pred(images, tabular)
    serve_s = time.perf_counter() - t0
    sps = len(images) / serve_s
    log(f"[serve] Predictor batch 512: {len(images)} samples in "
        f"{serve_s * 1e3:.1f} ms = {sps:.1f} samples/s (host arrays in, "
        f"probabilities out)")
    if probs.shape != (len(images), int(cfg.num_classes)) \
            or not np.isfinite(probs).all():
        raise SystemExit("bad serving output")

    # ---- 6. timing per shape (bfloat16, the path's dtype)
    buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    lib_fn = lambda x: torch.batch_norm_stats(x, 1e-5)  # noqa: E731
    tot = collections.defaultdict(float)
    bytes_fwd = 0
    ops_fwd = 0
    for (m, c), n in per_forward.items():
        x = torch.randn(m, c, generator=gen, device=dev).to(torch.bfloat16)
        t_k = time_ms(bn_stats, x, buf)
        t_p = time_ms(bn_stats_plain, x, buf)
        t_l = time_ms(lib_fn, x, buf)
        nbytes = m * c * 2 + 2 * c * 4
        nops = 3 * m * c
        bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS) * 1e3
        log(f"[time] M={m:>9,d} C={c:>5d} x{n:<2d} kernel {t_k:.4f} ms "
            f"bound {bound:.4f} ms ({bound / t_k:.0%} of bound) plain "
            f"{t_p:.4f} ms batch_norm_stats {t_l:.4f} ms")
        tot["ms"] += n * t_k
        tot["plain_ms"] += n * t_p
        tot["library_ms"] += n * t_l
        tot["bound_ms"] += n * bound
        bytes_fwd += n * nbytes
        ops_fwd += n * nops
        del x
    bound_by = ("bytes" if bytes_fwd / HBM_BYTES_PER_S
                >= ops_fwd / F32_FLOPS else "operations")
    log(f"[time] one forward (53 BNs, batch 512): kernel {tot['ms']:.4f} ms, "
        f"bound {tot['bound_ms']:.4f} ms ({bytes_fwd / 1e9:.3f} GB), plain "
        f"{tot['plain_ms']:.4f} ms, batch_norm_stats "
        f"{tot['library_ms']:.4f} ms")

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "bn_stats", "route": "cuda",
        "source": "stil_tta_torch/csrc/bn_stats.cu",
        "replaces": "stil_tta_tpu/ops/batch_norm.py:61",
        "launches": launches, "max_abs_err": max_abs,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": bound_by,
        "library_ms": tot["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
