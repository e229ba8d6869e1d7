#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Run from the root of the repository. It needs a CUDA card and fails
without one; it never runs on the CPU. Phases, each fatal on failure:

1. Device: name, count, and ``nvidia-smi`` name and power limit.
2. Build: ``csrc/bn_stats.cu``, ``csrc/bn_bwd_reduce.cu``,
   ``csrc/conv_chain.cu`` and ``csrc/conv_bwd_join.cu`` with ``nvcc`` for
   sm_90a, all compilers started together; build time and each
   compiler's register / shared-memory / spill report.
3. Kernels against plain: ``bn_stats`` and ``bn_bwd_reduce`` against
   their plain versions at every distinct (M, C) of ResNet-50's
   BatchNorms at batch 512 and 128x128, at batch 128 (the chunk
   shapes of ``micro_batches=4``), at batch 256 (cardiac), 64
   (``Supervised``'s labelled rows at DVM batch 512) and 32 (cardiac
   ``Supervised``), and ``bn_stats`` also at batch 960 (CoMatch's
   momentum encoder), in bfloat16 and float32, and two
   launches bitwise equal; then the train-mode BN Function's gradients
   (dx, dweight, dbias) with the kernels against the plain Function on
   the stem's shape.
4. The test-time slice at full width: ``config_dvm_STiL
   dataset=synthetic_dvm num_classes=286 synthetic_test=2048
   batch_size=512 test=True tta=True tta_strategy=bn_adapt`` through
   ``train.test.test`` (ResNet-50, 4-layer tabular transformer at d=512,
   one fusion layer, seeded random weights), with the kernel's launch
   count, wall time and peak memory; then the same adaptation with the
   kernel and with the plain statistics side by side; then a profile of
   the adaptation, which must show one ``bn_stats`` kernel a launch (212)
   and no ``column_sums`` kernel.
5. Serving: ``Predictor`` at batch 512, samples/s.
6. Training at full width: ``config_dvm_STiL dataset=synthetic_dvm
   num_classes=286 batch_size=512 synthetic_labelled=512
   synthetic_unlabelled=3584 evaluate=True max_epochs=2 start_epoch=0
   strict_prototypes=false test_and_eval=true`` through
   ``train.evaluate.evaluate``: 8 steps an epoch of 64 labelled + 448
   unlabelled rows, the second epoch with the pseudo-label losses; the
   train, val and test logs, both kernels' launch counts (53 x 16 each),
   steps/s, samples/s and peak memory.
7. One train step with the kernels and one with the plain pair, from one
   state, in float32 (in bfloat16 a rounding flip of one channel's
   statistics moves a whole step; the kernels' bfloat16 results are held
   at every shape in phase 3): loss, gradients, parameters and BN running
   statistics side by side, and the kernel run's launches.
8. Profile of one bfloat16 train step: device busy time against the
   host's clock, the shares of the two BN reduction kernels and of BN's
   elementwise work, and the top kernels. Each reduction is one
   cooperative kernel a call: the step must show 53
   ``bn_bwd_reduce_kernel`` events and no ``column_sums`` kernel (every
   profiled step of phases 13-16 is held to the latter too).
9. Timing: per shape, each kernel, its device-memory bound, the plain
   version and the library call that computes the same sums
   (``torch.batch_norm_stats``, ``torch.batch_norm_backward_reduce``;
   never called by the port), with the L2 cache flushed before every
   launch (and ``bn_stats`` also after a flush that only reads, which
   leaves no dirty lines in L2); each kernel's plan beside each shape,
   the count of backward shapes slower than the library call, both
   sources' registers, shared memory and spills (the ``-Xptxas -v``
   report; a spill fails the run), and both kernels' per-call floor (one
   row a block) beside ``x.add_(0)``; then both kernels again at the
   cardiac batch-256 shapes.
10. TTA strategies at full width: ``test()`` with ``tta_strategy`` tent,
    eata and sar on the configuration of phase 4, each with its metrics,
    wall time and ``bn_stats`` launches (53 x 4, the stats phase); then
    ``adapt`` alone on fresh weights, with what it ran (steps, samples
    the filters kept, SAR's resets), its wall time, and a check that only
    the BatchNorm affine parameters and running statistics changed.
11. The conv+BN probe (``stil_tta_torch.tools.bench_conv_probe``) at
    M = 524,288, K = 256, N = 64, NJ = 256: ``conv_chain``,
    ``conv_chain_scratch`` and ``conv_bwd_join`` against their plain
    versions at that M and at a ragged M, two launches bitwise equal;
    then the probe's entry point (its own check, and every variant's
    slope time against the bound), the plain versions' times and the
    join's GEMM timed the same way, and each kernel's time and share of
    its bound beside its registers, shared memory and spills (the
    ``-Xptxas -v`` report) and its shared-memory plan.
12. STiL_SAINT at full width (``config_dvm_STiL_SAINT``: the SAINT
    tabular encoder, colrow, token dim 32, on the same ResNet-50 and
    fusion): the test-time slice of phase 4 through ``test()`` (212
    ``bn_stats`` launches), its wall time and peak memory; ``Predictor``
    at batch 512; training with phase 6's flags (53 x 16 launches of
    each kernel), steps/s, samples/s and peak memory; one train step
    with the kernels and one with the plain pair, as phase 7.
13. The fast numerics profile: ``config_dvm_STiL`` with phase 6's flags
    and ``micro_batches=4 adam_mu_dtype=bfloat16`` for one epoch (4
    chunks of 16 + 112 rows a step, one Adam step with a bfloat16 first
    moment): 212 launches of each kernel a step, steps/s; then one step
    profiled as
    phase 8 profiles the single-batch step, beside phase 8's numbers.
14. MMatch and Co-Training at full width (the three-head concat
    backbone: the same ResNet-50 and tabular transformer, a 512-wide
    concat fusion projected to 128, three heads over 286 classes):
    ``config_dvm_CoTrain`` (EMAN teacher) trained with phase 6's flags for
    one epoch (53 x 8 launches of each kernel), its test-time slice (212
    ``bn_stats`` launches) and ``Predictor`` as phase 12;
    ``config_dvm_MMatch`` trained the same way, then two steps whose
    memory bank and DA ring stay finite and whose bank position goes 0
    -> 512 -> 0 (the enqueue truncates at the ring's end);
    ``config_dvm_CoTrain_SAINT`` trained for 8 steps (53 x 8); and the
    kernel-against-plain step of phase 7 for CoTrain, MMatch and
    CoTrain at ``micro_batches=4`` (212 launches of each kernel); one
    bfloat16 step of CoTrain and of MMatch profiled beside phase 8's.
15. The FixMatch families at full width (``ImagingNet``: the same
    ResNet-50, a linear head over 286 classes and a 2048-wide projection
    head to 128; ``MatchMultimodalNet``: the ResNet-50 and tabular
    transformer, a 1024-wide concat fusion, a projection head to 128 and
    one head): the six DVM YAMLs (``config_dvm_{,Multi}{SimMatch,
    CoMatch,FreeMatch}``) trained with phase 6's flags for one epoch; 53
    launches of each kernel a step by the student, and
    53 more of ``bn_stats`` by CoMatch's momentum encoder, which runs in
    train-mode BatchNorm without gradient on 64 + 448 + 448 rows;
    MultiSimMatch's test-time slice (212 ``bn_stats`` launches) and
    ``Predictor``; two CoMatch steps whose queues, DA ring and momentum
    encoder's statistics are checked; and for each multimodal family the
    kernel-against-plain step of phase 7 and one bfloat16 step profiled
    beside phase 8's.
16. The cardiac task, ``Supervised``, ``TabularEval`` and
    ``missing_tabular`` at full width, on synthetic data with the cardiac
    widths (2 classes, 26 categorical fields of 2-6 values and 49
    continuous ones, AUC): (a) ``config_cardiac_STiL`` trained two epochs
    at batch 256 = 32 + 224 with the rotation-warp contrastive views
    (53 + 53 launches a step), a float32 kernel-against-plain step, a
    bfloat16 step profiled beside phase 8's, ``test()`` with BN-adapt
    (53 ``bn_stats`` a statistics batch) and ``Predictor`` at batch 256;
    (b) ``Supervised`` with phase 6's flags, one epoch (53 + 53 a step at
    the 64-row shapes), its float32 kernel-against-plain step and a
    bfloat16 step profiled beside phase 8's; (c)
    ``TabularEval`` with phase 6's flags, one epoch, ``test()`` and
    ``Predictor``, with no BN kernel launched; (d) phase 4's test-time
    slice with ``missing_tabular`` (212 ``bn_stats``), whose probabilities
    differ from the unmasked ones; (e) two bfloat16 steps of
    ``config_cardiac_MultiSimMatch`` with its rotating hard-eval labelled
    view (53 + 53 a step).
17. The int8 image tower and the encoder warm start: (a) at every
    distinct convolution shape of ResNet-50 at batch 512 and 256, the
    integer GEMM's (``torch._int_mm``) s32 sums bitwise equal to a
    float64 convolution of the same int8 tensors on the card, the bf16
    and float32 outputs bitwise equal to the plain route's, two calls
    bitwise equal; (b) each part of the int8 route (quantize, im2col,
    ``_int_mm``, epilogue) per shape at batch 512, L2 flushed, beside the
    bf16 cuDNN convolution; (c) the eval forward of the tower at batch
    512, int8 against bf16: the cosine of the pooled features (> 0.99),
    the share of agreeing ``out_m`` argmaxes, both times, and a profile
    with 53 ``aten::_int_mm`` calls, their GEMM kernels and no
    convolution kernel; (d) ``Predictor(int8=True)`` at batch 512 beside
    the bf16 one and phase 5, then ``config_dvm_STiL teacher_int8=true``
    with phase 6's flags for one epoch (53 x 8 launches of each kernel),
    steps/s beside phase 6's, peak memory, and a profiled step with 53
    ``_int_mm`` calls (the teacher's convolutions) and 53
    ``bn_bwd_reduce`` kernels; (e) a warm-start checkpoint written by the
    port's converter from seeded random weights, then one epoch with
    ``finetune_strategy=frozen`` and no warm-up (53 x 8 launches): the
    encoders' parameters bitwise unchanged, their BN running statistics
    moved, the fusion and heads moved.
18. Data parallelism (``python -m stil_tta_torch.tools.dryrun_multichip``,
    ranks in processes of their own): (a) ``config_dvm_STiL`` at full
    width and global batch 512 (64 + 448) on 2 gloo ranks of the one card,
    256 rows a rank, two float32 steps from one seeded state against the
    one-process steps at 512: the largest parameter, running-statistic
    and prototype-sum differences within the dry run's tolerance, the
    ranks bitwise equal, 53 ``bn_stats`` and 53 ``bn_bwd_reduce``
    launches a step on each rank, the host time of a 2-rank step and of a
    single step and the collectives' share of the profiled 2-rank step;
    (b) a 2-rank ``Predictor`` at global batch 512 against the single one,
    bf16 and int8, 700 rows (a padded tail): the largest probability
    difference and equal argmaxes; (c) a one-rank NCCL group through the
    same path, two tiny steps; (d) the dry run's ten families at its tiny
    shapes on 2 ranks; (a)-(b) run alone on the card, then (c) and (d)
    side by side, with phase 21 (e) and (c) in this process beside them.
19. The host stream and the rest of the encoder zoo: (a) splits of the
    DVM widths written from the seed (32,768 unlabelled and 4,096
    labelled rows of 128² x 3 uint8, read back memmapped), then
    ``config_dvm_STiL`` at batch 512 for one epoch of 16 steps from them,
    twice through the ``DeviceCache`` and twice with ``host_stream=true``
    in turns, the native gather built before the first (cuDNN
    deterministic): 53 + 53 launches a step on each, the
    checkpoints bitwise equal (or the host runs within the two cache
    runs' gap), steps/s, the consumer's waits, queue occupancy, the
    native gather's rate and the pinned pool; a host-stream step against
    a cache step in turns on the host's clock, and one host-stream step
    profiled (its idle share); (b) both BN kernels against plain at every
    (M, C) the zoo adds to phase 3's list; for ResNet-34, -101, -152,
    ResNeXt-50 (32x4d), ResNeXt-101 (32x8d) and the wide ResNet-50 and
    -101 one bfloat16 STiL step at batch 512 with the net's BN count of
    launches of each kernel (36, 104, 155, 53, 104, 53, 104), for
    ResNet-34 and ResNeXt-101 a timed and a profiled step (host clock,
    device busy, peak memory), and phase 7's float32 step with the
    kernels against the plain pair;
    ``vit_small`` and ``vit_base``: two STiL steps with no BN kernel
    launched and ``Predictor`` at 512; (c) the grouped int8 convolution
    bitwise equal to its plain route at every grouped shape of ResNeXt-50
    and -101 at batch 512, timed against bf16 cuDNN at ResNeXt-50's,
    ``Predictor(int8=True)`` on ResNeXt-50 beside the bf16 one (argmax
    agreement over 0.95, one profiled serving batch with 549
    ``aten::_int_mm`` calls: 37 convs and 16 grouped ones of 32 groups),
    phase 17 (c)'s tower forward on ResNeXt-50 (cosine over 0.99, 549
    calls, no convolution kernel), and one ``teacher_int8`` step on
    ResNeXt-50 (549 calls).
20. The offline data prep and the shift workflow: (a) a DVM-width source
    from the seed (8,192 rows of 128² x 3 uint8, the synthetic_dvm field
    lengths, 286 classes), then ``python -m stil_tta_torch.dataprep.shifted``
    for the seven shifts of ``run_dist_shifts_torch.sh`` (``normal``;
    ``black``, ``b-s-g``, ``b-s-b-g-w`` on categorical column 0;
    ``miles`` and ``adv_year`` quantile shifts on two continuous columns;
    the ``labels`` label-distribution shift), one subprocess each, all
    started together, with each shift's sizes and JS-divergence report,
    and ``black`` built twice byte-equal; (b) ``train.test.test`` with
    BN-adapt on each shift's splits at full width (53 ``bn_stats`` a
    statistics batch, no ``bn_bwd_reduce``), and Tent on ``black`` (the
    same counts: its entropy steps run BN in eval mode), each run also
    held to the counts ``adapt`` returns inside ``test()`` and to its
    BN affine change (0 for BN-adapt, above 0 for Tent), each run's wall
    time and the sweep's peak memory; (c) BN-adapt on ``black`` with the
    kernel against the plain statistics (phase 4's tolerance), and the
    command ``run_dist_shifts_torch.sh`` builds for ``normal`` (read through
    a stub ``python``) as one subprocess, exit 0; (d) the TTA demo
    (``stil_tta_torch.tools.tta_demo``, ResNet-18 at 64², 8 classes, its
    base training cut to DEMO_EPOCHS epochs): clean, shifted and recovered
    accuracy of each strategy, and 20 launches of each kernel a train step
    and 20 ``bn_stats`` a BN-adapt batch.
21. ``steps_per_dispatch`` (``stil_tta_torch/train/multistep.py``), cuDNN
    deterministic: (a) two bfloat16 STiL states at full width from one
    seed, two dispatches of 8 steps (epoch 0, then 1, past
    ``start_epoch``), eager against replays of one captured step (its
    first step eager, the warm-up): every state tensor bitwise equal
    after each dispatch, 53 + 53 launches a step on both routes; (b) a
    graphed dispatch of 4 under the profiler: 53 ``bn_stats`` and 53
    ``bn_bwd_reduce`` kernels a replayed step, the Python counters in
    agreement, one graph launch a step, the host's launch calls a step;
    a step with a planted host sync fails its capture, and the next
    eager step draws its random numbers again; (d) dispatches of 16:
    host ms a step eager and graphed (median of three), device busy and
    idle share, the host's launch calls, the capture's time and pool,
    peak memory; then FreeMatch under ``steps_per_dispatch: 32`` on the
    graph route, one dispatch of 8 steps (53 + 53 a step), and STiL with
    ``teacher_int8``, the route left eager, one eager dispatch of 2; (f)
    CoMatch and STiL at ``micro_batches`` 4 at full width in bf16:
    dispatches of 4 steps eager against graphed, host ms a step (median
    of three), device busy and idle share, the host's launch calls and
    BN kernels a step (a profiled dispatch of 2), the capture's time and
    pool, peak memory (an eager dispatch is profiled without operator
    events, in (d) too); (c) ``evaluate`` in float32 with phase 6's flags
    for one epoch of 8 steps at ``steps_per_dispatch`` 1 and 3 (two
    dispatches and a tail of two) through the device cache, and 3
    through the host stream: the last checkpoints bitwise equal, 424 +
    424 launches each; (e) at a small width (ResNet-18 on 32², batch
    16): each newly captured route (the six FixMatch YAMLs, MMatch,
    CoTrain, CoTrain_SAINT, TabularEval, STiL at ``micro_batches`` 4)
    from one seed, two dispatches of 3 across ``start_epoch`` eager
    against graphed, every state tensor bitwise equal (the queues' and
    banks' positions among them), and the BN kernels a replayed step in
    the profile at the route's count. (e) and then (c) run beside phase
    18's NCCL and tiny dry runs (no check reads a time of theirs), the
    rest in the order (a), (b), (d), (f) at the end.

Each phase's wall time and the total are printed as the phases end.

Float32 convolutions and matmuls run in full float32 here (TF32 off), so
float32 comparisons are not blurred by TF32 rounding. The second-to-last
line is the kernels' JSON record and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
BATCH, IMG = 512, 128
MICRO = 4                   # micro_batches of the fast profile (phase 13)
TEACHER_ROWS = 960          # CoMatch's train-mode momentum encoder
TOL = 1e-5                  # relative, of float32 sums over the same data
FN_TOL = 1e-2               # of max|dx|: one bfloat16 rounding is 2^-8
SOURCES = ("bn_stats", "bn_bwd_reduce", "conv_chain", "conv_bwd_join")
TEST_OVERRIDES = ["dataset=synthetic_dvm", "num_classes=286",
                  "synthetic_test=2048", "batch_size=512", "test=True",
                  "tta=True", "enable_progress_bar=false"]
# with random weights the head's entropies lie near ln 286, beyond the
# default margin (0.4 ln 286): at 1.0 EATA's and SAR's filters keep
# samples and their steps do work
TTA_MARGIN = "tta_e_margin_scale=1.0"
RAGGED = 29                 # rows the probe's ragged check leaves out
TRAIN_OVERRIDES = [
    "dataset=synthetic_dvm", "num_classes=286", "batch_size=512",
    "synthetic_labelled=512", "synthetic_unlabelled=3584",
    "synthetic_val=1024", "synthetic_test=1024", "evaluate=True",
    "start_epoch=0", "strict_prototypes=false",
    "test_and_eval=true", "enable_progress_bar=false",
    "logdir=runs/chip_smoke_train",
]
STEPS_PER_EPOCH = 8         # 3584 // 448 and, for cardiac, 1792 // 224
# the cardiac widths (UK Biobank CAD): 26 categorical fields, here of
# 2-6 values (the real cardinalities come with the data), and 49
# continuous ones; 2 classes, scored by AUC
CARDIAC_FIELDS = [2 + i % 5 for i in range(26)] + [1] * 49
CARDIAC_BATCH = 256
CARDIAC_DATA = [
    "dataset=synthetic_dvm", "target=CAD", "num_classes=2",
    "eval_metric=auc",
    f"field_lengths=[{','.join(map(str, CARDIAC_FIELDS))}]",
    f"batch_size={CARDIAC_BATCH}", "synthetic_labelled=256",
    "synthetic_unlabelled=1792", "synthetic_val=512", "synthetic_test=1024",
    "enable_progress_bar=false"]
SLICE9_BATCHES = (CARDIAC_BATCH, 64, 32)   # cardiac, Supervised at DVM
# batch 512 (64 labelled rows), cardiac Supervised (32)
STEP_LR = 1e-4              # lr_eval, for the side-by-side step
INT8_OPS = 1979e12          # H100 SXM dense int8 tensor-core rate
# cuDNN's convolution kernels, none of which may run in an int8 forward
CONV_KERNEL_MARKS = ("conv", "fprop", "cudnn", "implicit_gemm", "winograd")


def log(*args):
    print(*args, flush=True)


def cache_synthetic_sources(keep: int = 4) -> None:
    """Make each size of synthetic splits once for the whole script: the
    package's ``load_sources`` (as ``train.evaluate`` and ``train.test``
    call it) keeps the ``keep`` sizes used last. Synthesis is seeded host
    work that no phase measures, and the splits are never written to (a
    mask or a truncation makes new ones)."""
    from stil_tta_torch.data import datasets
    from stil_tta_torch.train import test as test_mod
    real = datasets.load_sources
    cache: collections.OrderedDict = collections.OrderedDict()

    def load_sources(cfg):
        if not cfg.synthetic:
            return real(cfg)
        key = json.dumps([cfg.synthetic_labelled, cfg.synthetic_unlabelled,
                          cfg.synthetic_val, cfg.synthetic_test,
                          cfg.num_classes, cfg.synthetic_image_size,
                          cfg.img_size, cfg.field_lengths, cfg.target],
                         default=str)
        if key not in cache:
            cache[key] = real(cfg)
            while len(cache) > keep:
                cache.popitem(last=False)
        cache.move_to_end(key)
        return dict(cache[key])

    datasets.load_sources = test_mod.load_sources = load_sources


class PhaseClock:
    """Wall time of each phase, printed as it ends, and the total."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        log(f"[time] phase {name}: {now - self.last:.1f} s (total "
            f"{now - self.start:.1f} s)")
        self.last = now


def resnet50_bn_shapes(device, batch: int = BATCH) -> list:
    """(M, C) of each of ResNet-50's BatchNorm inputs at ``batch`` and
    IMG, in forward order, read off the tower with forward hooks."""
    from stil_tta_torch.models.resnet import resnet50
    from stil_tta_torch.ops.batch_norm import BatchNorm2d
    tower = resnet50(dtype=torch.bfloat16).to(device).eval()
    seen = []
    for m in tower.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(
                lambda mod, inp: seen.append(
                    (batch * inp[0].shape[2] * inp[0].shape[3],
                     inp[0].shape[1])))
    with torch.no_grad():
        tower(torch.zeros(1, IMG, IMG, 3, device=device))
    return seen


def time_ms(fn, x, buf, reps=50, flush=None) -> float:
    """Mean device time of ``fn(x)``, each call after an L2 flush (a
    write of ``buf``, or ``flush()``). A spin kernel first gives the card
    a head start, so the host queues every call before the card reaches
    them and the span holds no host time; the flushes' own span, measured
    the same way, is subtracted. The write leaves up to 50 MB of dirty
    lines in L2, which the timed call's reads evict to device memory."""
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

    flush = flush or buf.zero_
    alone = span(flush)
    both = span(lambda: (flush(), fn(x)))
    return (both - alone) / reps


def check_bwd_kernel(per_forward, gen, dev) -> float:
    """``bn_bwd_reduce`` against its plain version at every shape, in
    bfloat16 and float32, two launches bitwise equal; returns the largest
    absolute error."""
    from stil_tta_torch.ops.batch_norm import (bn_bwd_reduce,
                                               bn_bwd_reduce_plain)
    max_abs = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for m, c in per_forward:
            x = (torch.randn(m, c, generator=gen, device=dev)
                 + 0.5).to(dtype)
            dy = torch.randn(m, c, generator=gen, device=dev).to(dtype)
            xf = x.float()
            mean = xf.mean(0)
            inv = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
            s, q = bn_bwd_reduce(x, dy, mean, inv)
            s2, q2 = bn_bwd_reduce(x, dy, mean, inv)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(s, s2) and torch.equal(q, q2))
            ps, pq = bn_bwd_reduce_plain(x, dy, mean, inv)
            dyf = dy.float()
            scale_s = dyf.abs().sum(0, keepdim=True)
            scale_q = (dyf * ((xf - mean) * inv)).abs().sum(0, keepdim=True)
            rel_s = float(((s - ps).abs() / scale_s).max())
            rel_q = float(((q - pq).abs() / scale_q).max())
            abs_err = max(float((s - ps).abs().max()),
                          float((q - pq).abs().max()))
            max_abs = max(max_abs, abs_err)
            log(f"[bwd] {str(dtype)[6:]:8s} M={m:>9,d} C={c:>5d} max rel "
                f"err of sum|dy| {rel_s:.2e}, of sum|dy x_hat| {rel_q:.2e} "
                f"(tol {TOL:.0e}) abs {abs_err:.3e} bitwise-repeat "
                f"{bitwise}")
            if not (bitwise and max(rel_s, rel_q) < TOL):
                raise SystemExit(f"bn_bwd_reduce disagrees at {(m, c, dtype)}")
            del x, dy, xf, dyf
    return max_abs


def check_bn_function(gen, dev) -> None:
    """The train-mode BN Function's gradients with the kernel pair
    against the plain pair, at the stem's shape in bfloat16.

    dy is drawn as ``k * x_hat + 0.5 + noise`` per channel, so that the
    sums (dbias = sum dy, dweight = sum dy x_hat) are of order M and the
    terms they put into dx are of the order of dy itself: sums that were
    zero or of the wrong sign would move dx by about max|dx|."""
    from stil_tta_torch.ops.batch_norm import (BNTrain, bn_bwd_reduce,
                                               bn_bwd_reduce_plain, bn_stats,
                                               bn_stats_plain)
    n, c, hw = BATCH, 64, IMG // 2
    cl = torch.channels_last
    x = (torch.randn(n, c, hw, hw, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16).contiguous(memory_format=cl)
    xf = x.float()
    mu = xf.mean((0, 2, 3), keepdim=True)
    sd = (xf.var((0, 2, 3), unbiased=False, keepdim=True) + 1e-5).sqrt()
    k = torch.rand(1, c, 1, 1, generator=gen, device=dev) + 0.5
    dy = (k * (xf - mu) / sd + 0.5
          + torch.randn(n, c, hw, hw, generator=gen, device=dev)).to(
        torch.bfloat16).contiguous(memory_format=cl)
    del xf
    w = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.randn(c, generator=gen, device=dev)
    grads = {}
    for name, fns in (("kernel", (bn_stats, bn_bwd_reduce)),
                      ("plain", (bn_stats_plain, bn_bwd_reduce_plain))):
        xr = x.detach().requires_grad_()
        wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
        y, _, _ = BNTrain.apply(xr, wr, br, 1e-5, *fns)
        y.backward(dy)
        grads[name] = (xr.grad.float(), wr.grad, br.grad)
    (dxk, dwk, dbk), (dxp, dwp, dbp) = grads["kernel"], grads["plain"]
    rel_dx = float((dxk - dxp).abs().max() / dxp.abs().max())
    rel_dw = float(((dwk - dwp).abs() / dwp.abs().clamp_min(1e-30)).max())
    rel_db = float(((dbk - dbp).abs() / dbp.abs().clamp_min(1e-30)).max())
    m = n * hw * hw
    log(f"[bwd] BN Function at {(n, c, hw, hw)} bf16, kernels vs plain: "
        f"max|d dx|/max|dx| {rel_dx:.2e} (tol {FN_TOL:.0e}); dweight max "
        f"rel {rel_dw:.2e}, dbias max rel {rel_db:.2e} (tol {TOL:.0e}); "
        f"reduction terms against max|dy|: sum dy/M "
        f"{float(dbp.abs().min()) / m:.3f}-{float(dbp.abs().max()) / m:.3f}, "
        f"sum dy x_hat/M {float(dwp.abs().min()) / m:.3f}-"
        f"{float(dwp.abs().max()) / m:.3f}, max|dy| "
        f"{float(dy.abs().max()):.3f}")
    if rel_dx > FN_TOL:
        raise SystemExit("BN Function: kernel and plain dx disagree")
    if max(rel_dw, rel_db) > TOL:
        raise SystemExit("BN Function: kernel and plain dweight or dbias "
                         "disagree")


def train_full_width(config_name: str = "config_dvm_STiL", extra=(),
                     per_step: int = 53, tag: str = "train",
                     epochs: int = 2, teacher_stats: int = 0) -> tuple:
    """Phase 6 (and 12-15): ``evaluate`` at full width for ``epochs``
    epochs of 8 steps; returns the config, the kernels' launch counts of
    the run and its last epoch's steps/s. ``per_step``: the launches of
    each kernel a step by the student; ``teacher_stats``: the ``bn_stats``
    launches a step of a train-mode teacher (CoMatch's momentum
    encoder)."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.ops.batch_norm import BNTrain, bn_bwd_reduce, bn_stats
    from stil_tta_torch.train.evaluate import evaluate
    cfg = load_config(config_name, TRAIN_OVERRIDES + list(extra)
                      + [f"max_epochs={epochs}"])
    n_steps = STEPS_PER_EPOCH * epochs
    logdir = Path(cfg.logdir)
    shutil.rmtree(logdir, ignore_errors=True)
    log(f"[{tag}] {cfg.algorithm_name}, micro_batches {cfg.micro_batches}, "
        f"adam_mu_dtype {cfg.adam_mu_dtype}")
    log(f"[{tag}] {cfg.model} img {cfg.img_size} tabular "
        f"{cfg.tabular_transformer_num_layers}x{cfg.tabular_embedding_dim} "
        f"fusion {cfg.multimodal_transformer_num_layers}x"
        f"{cfg.multimodal_embedding_dim} classes {cfg.num_classes} batch "
        f"{cfg.batch_size} (unlabelled_ratio {cfg.unlabelled_ratio}) "
        f"labelled {cfg.synthetic_labelled} unlabelled "
        f"{cfg.synthetic_unlabelled} epochs {cfg.max_epochs}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bn_stats.launches = bn_bwd_reduce.launches = 0
    BNTrain.dy_copies = 0
    t0 = time.perf_counter()
    results = evaluate(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"bn_stats": bn_stats.launches,
                "bn_bwd_reduce": bn_bwd_reduce.launches}
    dy_copies = BNTrain.dy_copies
    peak = torch.cuda.max_memory_allocated()
    records = [json.loads(line) for line in
               (logdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "multimodal.train.loss" in r]
    val = [r for r in records if "eval.val.acc" in r]
    for r in train:
        log(f"[{tag}] epoch {r['_step']} train {json.dumps(r)}")
    for r in val:
        log(f"[{tag}] epoch {r['_step']} val {json.dumps(r)}")
    log(f"[{tag}] results {json.dumps(results)}")
    sps = train[-1]["multimodal.train.samples_per_sec"]
    log(f"[{tag}] epoch {epochs}: {sps / int(cfg.batch_size):.3f} steps/s, "
        f"{sps:.1f} samples/s (8 steps and epoch_end, host clock); whole "
        f"run {wall:.1f} s (data synthesis, weight init, validation, "
        f"checkpoints, test); peak memory {peak / 2**30:.3f} GiB")
    want = {"bn_stats": (per_step + teacher_stats) * n_steps,
            "bn_bwd_reduce": per_step * n_steps}
    log(f"[{tag}] launches {launches} (expected {want}: {per_step} + "
        f"{teacher_stats} and {per_step} a step, {n_steps} steps); dy "
        f"copied to channels_last in {dy_copies} of "
        f"{launches['bn_bwd_reduce']} BN backwards")
    if launches != want:
        raise SystemExit(f"{tag}: a kernel's launch count is off the "
                         "training path")
    values = [v for r in train + val for k, v in r.items()
              if k != "_step" and isinstance(v, (int, float))]
    values += list(results.values())
    if len(train) != epochs or not all(math.isfinite(v) for v in values):
        raise SystemExit(f"{tag}: non-finite or missing training logs or "
                         "metrics")
    return cfg, launches, sps / int(cfg.batch_size)


def _clone(named) -> dict:
    return {k: t.detach().float().clone() for k, t in named}


def step_setup(cfg, dev, dtype=torch.bfloat16) -> tuple:
    """The algorithm of ``cfg`` computing in ``dtype``, its train step
    and a full batch (the first rows of each split): (algo, step,
    batch)."""
    from stil_tta_torch.algorithms.registry import get_algorithm
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.data.loader import DeviceCache
    src = load_sources(cfg)
    src_l, src_u = src["train_labelled"], src["train_unlabelled"]
    if cfg.algorithm_name == "SimMatch" and not cfg.K:
        cfg.K = len(src_l)   # as train.evaluate sets it
    algo = get_algorithm(cfg.algorithm_name)(cfg, src_l.field_lengths,
                                             dtype=dtype, device=dev)
    cache_l = DeviceCache(src_l, device=dev).as_dict()
    cache_u = DeviceCache(src_u, device=dev).as_dict()
    b_l = int(cfg.batch_size) // (1 + int(cfg.unlabelled_ratio))
    batch = (cache_l, cache_u, torch.arange(b_l, device=dev),
             torch.arange(int(cfg.batch_size) - b_l, device=dev))
    return algo, algo.make_train_step(), batch


def train_step_kernel_vs_plain(cfg, dev, per_step: int = 53,
                               teacher_stats: int = 0) -> None:
    """Phase 7 (and 12-15): one train step (epoch 1, past start_epoch)
    from one state with the kernels and with the plain pair (in the
    student and in the EMA teacher), cuDNN deterministic, the net
    computing in float32; the kernel run must launch ``bn_bwd_reduce``
    ``per_step`` times and ``bn_stats`` ``per_step + teacher_stats``
    times.

    Float32, not the path's bfloat16: in bfloat16 the two pairs' float32
    sums, in different orders, now and then round a channel's bf16 mean
    or scale differently, and one such flip moves the whole step (a
    STiL_SAINT step's gradients 0.206 apart, rel L2), whichever kernel is
    right. In float32 the pairs differ by summation order alone: on an
    H100 80GB HBM3 at 700 W, gradients 3.1e-3 to 6.8e-3 apart (rel L2)
    for STiL and STiL_SAINT, 1.7e-2 to 1.9e-2 for MMatch and Co-Training,
    whose losses and gradients are far smaller. The gates (loss 1e-2
    relative, gradients 0.1 and parameter updates 0.5 rel L2, BN
    statistics 0.1) leave room over that, and a kernel whose sums were
    wrong would move the gradients by order 1; the updates' gate is
    wider because Adam's first step is about lr * sign(g), so a gradient
    element near 0 can move its parameter by 2 lr. The kernels' bfloat16
    results are held to their plain versions at every shape in phase
    3."""
    from stil_tta_torch.ops.batch_norm import (bn_bwd_reduce,
                                               bn_bwd_reduce_plain,
                                               bn_functions, bn_stats,
                                               bn_stats_plain)
    from stil_tta_torch.train.optim import set_learning_rate
    algo, step, batch = step_setup(cfg, dev, torch.float32)
    state = algo.init_state(0)
    net0 = copy.deepcopy(state.net.state_dict())
    p0 = _clone(state.net.named_parameters())
    ema0 = None if state.ema is None else copy.deepcopy(state.ema.state_dict())
    rng0 = torch.cuda.get_rng_state()
    torch.backends.cudnn.deterministic = True
    runs = {}
    for name, fns in (("kernel", (bn_stats, bn_bwd_reduce)),
                      ("plain", (bn_stats_plain, bn_bwd_reduce_plain))):
        state = algo.init_state(0)
        state.net.load_state_dict(net0)
        if ema0 is not None:
            state.ema.load_state_dict(ema0)
        torch.cuda.set_rng_state(rng0)
        set_learning_rate(state.optimizer, STEP_LR)
        bn_stats.launches = bn_bwd_reduce.launches = 0
        with contextlib.ExitStack() as stack:
            for mod in (state.net, state.ema):
                if mod is not None:
                    stack.enter_context(bn_functions(mod, *fns))
            step(state, *batch, 1)
        torch.cuda.synchronize()
        launches = (bn_stats.launches, bn_bwd_reduce.launches)
        net = state.net
        runs[name] = {
            "loss": float(state.log_sums["loss"]),
            "params": _clone(net.named_parameters()),
            # Supervised's projectors and CLUB heads get no gradient
            "grads": _clone((k, p.grad) for k, p in net.named_parameters()
                            if p.grad is not None),
            "stats": _clone((k, b) for k, b in net.named_buffers()
                            if k.endswith(("running_mean", "running_var"))),
            "launches": launches}
    torch.backends.cudnn.deterministic = False
    k, p = runs["kernel"], runs["plain"]

    def rel_l2(a: dict, b: dict, base: dict = None) -> float:
        num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in a)
        den = sum(float(((b[n] - (0 if base is None else base[n])) ** 2)
                        .sum()) for n in b)
        return math.sqrt(num / max(den, 1e-30))

    d_loss = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    d_grad = rel_l2(k["grads"], p["grads"])
    d_upd = rel_l2(k["params"], p["params"], p0)
    d_upd_max = max(float((k["params"][n] - p["params"][n]).abs().max())
                    for n in p0) / STEP_LR
    d_mean = max(float(((k["stats"][n] - p["stats"][n]).abs()
                        / p["stats"][n[:-4] + "var"].clamp_min(1e-12).sqrt())
                       .max()) for n in k["stats"] if n.endswith("mean"))
    d_var = max(float(((k["stats"][n] - p["stats"][n]).abs()
                       / p["stats"][n].clamp_min(1e-12)).max())
                for n in k["stats"] if n.endswith("var"))
    log(f"[step] {cfg.algorithm_name} (micro_batches {cfg.micro_batches}, "
        f"float32): one train step, kernels vs plain (epoch 1, lr "
        f"{STEP_LR}): loss {k['loss']:.6f} vs {p['loss']:.6f} (rel "
        f"{d_loss:.2e}, tol 1e-2); gradients rel L2 {d_grad:.3e} (tol 0.1); "
        f"parameter updates rel L2 {d_upd:.3e} (tol 0.5), largest element "
        f"difference {d_upd_max:.3f} x lr; BN running stats max |d mean|/std "
        f"{d_mean:.3e}, max |d var|/var {d_var:.3e} (tol 0.1); kernel "
        f"launches (bn_stats, bn_bwd_reduce) {k['launches']} (expected "
        f"{(per_step + teacher_stats, per_step)}), plain {p['launches']}")
    if k["launches"] != (per_step + teacher_stats, per_step) \
            or p["launches"] != (0, 0):
        raise SystemExit("kernel vs plain step: launch counts off the path")
    if (d_loss > 1e-2 or d_grad > 0.1 or d_upd > 0.5
            or max(d_mean, d_var) > 0.1):
        raise SystemExit("kernel and plain train steps disagree")


def profile_train_step(state, step, batch, tag: str = "m=1") -> dict:
    """Phase 8 (and 13): one train step under the profiler, and one more
    on the host's clock alone. BN's forward and backward run inside named ranges
    (a subclass of the Function, for this phase only), so the device time
    of their elementwise kernels can be read off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from stil_tta_torch.ops import batch_norm as bn_mod
    base = bn_mod.BNTrain

    class Ranged(base):
        @staticmethod
        def forward(ctx, *args):
            with record_function("bn_train.forward"):
                return base.forward(ctx, *args)

        @staticmethod
        def backward(ctx, *grads):
            with record_function("bn_train.backward"):
                return base.backward(ctx, *grads)

    step(state, *batch, 1)
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(state, *batch, 1)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = sorted(host)[1]
    bn_mod.BNTrain = Ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, *batch, 1)
            torch.cuda.synchronize()
            prof_host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        bn_mod.BNTrain = base
    dev_time = lambda e: getattr(  # noqa: E731
        e, "device_time_total", getattr(e, "cuda_time_total", 0))
    # kernels only: ranges (ours, the optimizer's) also appear on the
    # device timeline and would count their kernels twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith(("bn_train.", "Optimizer."))]
    busy = sum(dev_time(e) for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    part = lambda tag: sum(dev_time(e) for e in events  # noqa: E731
                           if tag in e.key) / 1e3
    # each BN reduction is one kernel a call: no column_sums pass
    stats_ms = part("bn_stats_kernel")
    bwd_ms = part("bn_bwd_reduce_kernel")
    count = lambda tag: sum(e.count for e in events  # noqa: E731
                            if tag in e.key)
    bwd_kernels, pass2 = count("bn_bwd_reduce_kernel"), count("column_sums")
    if pass2:
        raise SystemExit(f"train step ({tag}): {pass2} column_sums kernels; "
                         f"bn_bwd_reduce must be one kernel a call")

    def kernels_under(e):
        yield from e.kernels
        for ch in e.cpu_children:
            yield from kernels_under(ch)

    ours = ("bn_stats_kernel", "bn_bwd_reduce_kernel")
    elem_ms = sum(k.duration for e in prof.events()
                  if e.name.startswith("bn_train.")
                  and e.device_type == DeviceType.CPU
                  for k in kernels_under(e)
                  if not any(t in k.name for t in ours)) / 1e3
    int_mm = sum(e.count for e in prof.key_averages()
                 if e.key == "aten::_int_mm")
    out = {"host_ms": host_ms, "profiled_host_ms": prof_host_ms,
           "busy_ms": busy, "bn_stats_ms": stats_ms,
           "bn_bwd_reduce_ms": bwd_ms, "bn_elementwise_ms": elem_ms,
           "kernel_launches": n_kernels,
           "bn_bwd_reduce_kernels": bwd_kernels, "int_mm_calls": int_mm}
    log(f"[profile] train step ({tag}): host clock {host_ms:.3f} ms (median of "
        f"{', '.join(f'{t:.3f}' for t in host)}; profiled "
        f"{prof_host_ms:.3f} ms), device busy {busy:.3f} ms, idle share "
        f"{1 - busy / host_ms:.1%}; {n_kernels} kernel launches, "
        f"{host_ms / max(n_kernels, 1) * 1e3:.1f} us of host clock each; "
        f"{bwd_kernels} bn_bwd_reduce kernels, {pass2} column_sums")
    for name, ms in (("bn_stats", stats_ms), ("bn_bwd_reduce", bwd_ms),
                     ("BN elementwise (fwd + bwd)", elem_ms)):
        log(f"[profile]   {name}: {ms:.3f} ms ({ms / max(busy, 1e-9):.1%} "
            f"of device busy)")
    for e in sorted(events, key=dev_time, reverse=True)[:8]:
        log(f"[profile]   {dev_time(e) / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")
    return out


def tta_strategies_full_width() -> None:
    """Phase 10: ``test()`` with Tent, EATA and SAR at full width, then
    ``adapt`` alone on fresh weights to see what it ran and changed."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.ops.batch_norm import bn_stats
    from stil_tta_torch.train.test import build_algo, load_test_split, test
    from stil_tta_torch.tta import adapt
    from stil_tta_torch.tta.tent import bn_parameters
    for strategy in ("tent", "eata", "sar"):
        cfg = load_config("config_dvm_STiL", TEST_OVERRIDES + [
            f"tta_strategy={strategy}", TTA_MARGIN,
            f"logdir=runs/chip_smoke_{strategy}"])
        torch.cuda.synchronize()
        bn_stats.launches = 0
        t0 = time.perf_counter()
        metrics = test(cfg.copy(), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bn_stats.launches
        batches = math.ceil(int(cfg.synthetic_test) / int(cfg.batch_size))
        log(f"[tta] {strategy}: metrics {json.dumps(metrics)}; test() "
            f"{wall:.3f} s (data synthesis, weight init, adaptation, "
            f"scoring); bn_stats launches {launches} (53 x {batches})")
        if launches != 53 * batches:
            raise SystemExit(f"{strategy}: bn_stats launch count off the "
                             "stats phase")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0
                   for v in metrics.values()):
            raise SystemExit(f"{strategy}: bad test metrics {metrics}")

        src = load_test_split(cfg)
        algo = build_algo(cfg, src.field_lengths, "cuda")
        cache = DeviceCache(src, device="cuda").as_dict()
        before = {k: v.detach().clone()
                  for k, v in algo.net.state_dict().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = adapt(cfg, algo, cache)
        torch.cuda.synchronize()
        t_adapt = time.perf_counter() - t0
        bn_names = {k for k, _ in bn_parameters(algo.net)}
        stats = ("running_mean", "running_var", "num_batches_tracked")
        after = algo.net.state_dict()
        changed = {k for k, v in after.items()
                   if not torch.equal(v, before[k])}
        stray = sorted(k for k in changed
                       if k not in bn_names and not k.endswith(stats))
        moved = max(float((after[k] - before[k]).abs().max())
                    for k in bn_names)
        log(f"[tta] {strategy}: adapt {t_adapt * 1e3:.1f} ms, {counts}; "
            f"{len(changed & bn_names)} of {len(bn_names)} BN affine "
            f"tensors changed, largest move {moved:.3e} "
            f"(lr {float(cfg.tta_lr):.0e}); other parameters changed: "
            f"{stray or 'none'}")
        if stray or not math.isfinite(moved):
            raise SystemExit(f"{strategy}: adaptation changed {stray}")
        if counts.get("selected", 1) == 0 or moved == 0.0:
            raise SystemExit(f"{strategy}: the adaptation did no work")
        del algo, cache, src


def adapt_and_serve(config_name: str, tag: str, overrides=TEST_OVERRIDES,
                    per_batch: int = 53, serve_batch: int = 512) -> int:
    """Phase 12 (and 14-16): ``test()`` with BN-adapt at full width on
    ``config_name`` with ``overrides``, ``per_batch`` ``bn_stats``
    launches a statistics batch (0 for a net without BatchNorm), then
    ``adapt`` alone and ``Predictor`` at ``serve_batch`` on fresh weights;
    returns the ``bn_stats`` launches of ``test()``."""
    import numpy as np
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.ops.batch_norm import bn_stats
    from stil_tta_torch.serve import Predictor
    from stil_tta_torch.train.test import build_algo, load_test_split, test
    from stil_tta_torch.tta import adapt
    cfg = load_config(config_name, list(overrides) + [
        "tta_strategy=bn_adapt", f"logdir=runs/chip_smoke_{tag}"])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bn_stats.launches = 0
    t0 = time.perf_counter()
    metrics = test(cfg.copy(), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    adapt_launches = bn_stats.launches
    peak = torch.cuda.max_memory_allocated()
    batches = math.ceil(int(cfg.synthetic_test) / int(cfg.batch_size))
    name = cfg.algorithm_name
    log(f"[{tag}] {name} test(): metrics {json.dumps(metrics)}")
    log(f"[{tag}] bn_stats launches {adapt_launches} ({per_batch} x "
        f"{batches}); wall {wall:.3f} s (data synthesis, weight init, "
        f"BN-adapt, scoring); peak memory {peak / 2**30:.3f} GiB")
    if adapt_launches != per_batch * batches:
        raise SystemExit(f"{name}: bn_stats launch count off the BN-adapt "
                         "path")
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0
               for v in metrics.values()):
        raise SystemExit(f"{name}: bad test metrics {metrics}")

    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, "cuda")
    cache = DeviceCache(src, device="cuda").as_dict()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adapt(cfg, algo, cache)
    torch.cuda.synchronize()
    t_adapt = time.perf_counter() - t0
    pred = Predictor(algo, batch_size=serve_batch)
    images, tabular = np.asarray(src.images), np.asarray(src.tabular)
    pred(images[:serve_batch], tabular[:serve_batch])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = pred(images, tabular)
    serve_s = time.perf_counter() - t0
    log(f"[{tag}] BN-adapt alone {t_adapt * 1e3:.1f} ms ({batches} batches); "
        f"Predictor batch {serve_batch}: {len(images)} samples in "
        f"{serve_s * 1e3:.1f} ms = {len(images) / serve_s:.1f} samples/s")
    if probs.shape != (len(images), int(cfg.num_classes)) \
            or not np.isfinite(probs).all() \
            or np.abs(probs.sum(1) - 1).max() > 1e-3:
        raise SystemExit(f"{name}: bad serving output")
    return adapt_launches


def saint_phase(dev) -> dict:
    """Phase 12: STiL_SAINT's test-time slice, serving and training at
    full width, and a train step with the kernels against the plain
    pair; returns the kernels' launch counts of its paths."""
    adapt_launches = adapt_and_serve("config_dvm_STiL_SAINT", "saint")
    train_cfg, launches, _ = train_full_width(
        "config_dvm_STiL_SAINT", ["logdir=runs/chip_smoke_saint_train"],
        tag="saint-train")
    train_step_kernel_vs_plain(train_cfg, dev)
    return {"stil_saint_bn_adapt": {"bn_stats": adapt_launches},
            "stil_saint_train": launches}


def check_mmatch_bank(cfg, dev) -> None:
    """Phase 14: two MMatch steps at full width; the memory bank and the
    DA ring stay finite and the bank's position follows
    ``(ptr + min(512, 640 - ptr)) % 640``: 0 -> 512 -> 0."""
    algo, step, batch = step_setup(cfg, dev)
    state = algo.init_state(0)
    ptrs = [int(state.extra["ptr"])]
    for _ in range(2):
        step(state, *batch, 1)
        ptrs.append(int(state.extra["ptr"]))
    torch.cuda.synchronize()
    ex = state.extra
    finite = all(bool(torch.isfinite(t).all()) for t in (
        ex["embed_queue"], ex["probs_queue"], state.da.queue))
    written = float(ex["probs_queue"].sum(0).gt(0).float().sum())
    log(f"[pair] MMatch bank after 2 steps: positions {ptrs} (expected "
        f"[0, 512, 0]), {written:.0f} of 640 target columns written, bank "
        f"and DA ring finite {finite}, DA position {state.da.ptr}")
    if ptrs != [0, 512, 0] or not finite or written != 640 \
            or state.da.ptr != 2:
        raise SystemExit("MMatch: the memory bank or the DA ring is off")


def profile_beside(cfg, dev, single: dict, tag: str,
                   teacher_stats: int = 0) -> dict:
    """One bfloat16 step of ``cfg`` profiled as phase 8 profiles STiL's,
    with its launches of each kernel (``bn_stats`` 53 + ``teacher_stats``,
    ``bn_bwd_reduce`` 53), beside phase 8's numbers (``single``)."""
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    from stil_tta_torch.train.optim import set_learning_rate
    algo, step, batch = step_setup(cfg, dev)
    state = algo.init_state(0)
    set_learning_rate(state.optimizer, STEP_LR)
    bn_stats.launches = bn_bwd_reduce.launches = 0
    step(state, *batch, 1)
    torch.cuda.synchronize()
    if (bn_stats.launches, bn_bwd_reduce.launches) != (53 + teacher_stats,
                                                       53):
        raise SystemExit(f"{tag}: {bn_stats.launches}, "
                         f"{bn_bwd_reduce.launches} launches a step")
    out = profile_train_step(state, step, batch, tag=tag)
    out["launches"] = {"bn_stats": bn_stats.launches,
                       "bn_bwd_reduce": bn_bwd_reduce.launches}
    log(f"[pair] {tag} step against STiL's (phase 8): host "
        f"{out['host_ms']:.3f} vs {single['host_ms']:.3f} ms "
        f"({out['host_ms'] / single['host_ms']:.3f}x), device busy "
        f"{out['busy_ms']:.3f} vs {single['busy_ms']:.3f} ms, kernel "
        f"launches {out['kernel_launches']} vs {single['kernel_launches']}")
    return out


def pair_phase(dev, single: dict) -> dict:
    """Phase 14: the semi-multimodal pair at full width (Co-Training with
    its EMAN teacher, MMatch, Co-Training with SAINT), with one step of
    Co-Training and of MMatch profiled beside STiL's (``single``, phase
    8); returns the kernels' launch counts of their paths."""
    by_path = {}
    _, by_path["cotrain_train"], _ = train_full_width(
        "config_dvm_CoTrain", ["logdir=runs/chip_smoke_cotrain_train"],
        tag="cotrain-train", epochs=1)
    by_path["cotrain_bn_adapt"] = {
        "bn_stats": adapt_and_serve("config_dvm_CoTrain", "cotrain")}
    cfg, by_path["mmatch_train"], _ = train_full_width(
        "config_dvm_MMatch", ["logdir=runs/chip_smoke_mmatch_train"],
        tag="mmatch-train", epochs=1)
    check_mmatch_bank(cfg, dev)
    _, by_path["cotrain_saint_train"], _ = train_full_width(
        "config_dvm_CoTrain_SAINT",
        ["logdir=runs/chip_smoke_cotrain_saint_train"],
        tag="cotrain-saint-train", epochs=1)
    from stil_tta_torch.config import load_config
    for name, tag in (("config_dvm_CoTrain", "CoTrain"),
                      ("config_dvm_MMatch", "MMatch")):
        cfg = load_config(name, TRAIN_OVERRIDES)
        train_step_kernel_vs_plain(cfg, dev)
        profile_beside(cfg, dev, single, tag)
    train_step_kernel_vs_plain(
        load_config("config_dvm_CoTrain",
                    TRAIN_OVERRIDES + [f"micro_batches={MICRO}"]),
        dev, per_step=53 * MICRO)
    return by_path


# the FixMatch families' DVM configs: (name, bn_stats launches a step of
# a train-mode teacher, epochs trained); the multimodal ones are held
# against the plain pair and profiled
FIXMATCH = (("SimMatch", 0, 1), ("MultiSimMatch", 0, 1), ("CoMatch", 53, 1),
            ("MultiCoMatch", 53, 1), ("FreeMatch", 0, 1),
            ("MultiFreeMatch", 0, 1))


def check_comatch_buffers(cfg, dev) -> None:
    """Phase 15: two CoMatch steps at full width; the momentum encoder's
    BatchNorm running statistics and counters stay as they were (its
    train-mode forwards normalise by the batch), the queues' positions
    advance by 448 (strong) and 512 (labelled and weak) a step, the DA
    ring's length by one, and the buffers stay finite."""
    algo, step, batch = step_setup(cfg, dev)
    state = algo.init_state(0)
    before = {k: v.clone() for k, v in state.ema.named_buffers()}
    ex = state.extra
    pos = [tuple(int(ex[k]) for k in ("ptr_s", "ptr_w", "hist_len"))]
    for _ in range(2):
        step(state, *batch, 1)
        pos.append(tuple(int(ex[k]) for k in ("ptr_s", "ptr_w",
                                                 "hist_len")))
    torch.cuda.synchronize()
    kept = all(torch.equal(v, before[k])
               for k, v in state.ema.named_buffers())
    finite = all(bool(torch.isfinite(ex[k]).all()) for k in (
        "queue_s", "probs_u", "queue_w", "probs_xu", "hist_prob"))
    log(f"[fixmatch] CoMatch after 2 steps: (ptr_s, ptr_w, hist_len) "
        f"{pos} (expected [(0, 0, 0), (448, 512, 1), (896, 1024, 2)]); "
        f"momentum encoder's {len(before)} BN buffers unchanged {kept}; "
        f"buffers finite {finite}")
    if pos != [(0, 0, 0), (448, 512, 1), (896, 1024, 2)] or not kept \
            or not finite:
        raise SystemExit("CoMatch: the queues, the DA ring or the momentum "
                         "encoder's statistics are off")


def fixmatch_phase(dev, single: dict) -> dict:
    """Phase 15: the six FixMatch YAMLs trained at full width, BN-adapt
    and serving on MultiSimMatch, CoMatch's buffers, and for each
    multimodal family a float32 kernel-against-plain step and a bfloat16
    step profiled beside STiL's (``single``, phase 8); returns the
    kernels' launch counts of the paths."""
    from stil_tta_torch.config import load_config
    by_path = {}
    for name, teacher, epochs in FIXMATCH:
        tag = name.lower()
        _, by_path[f"{tag}_train"], _ = train_full_width(
            f"config_dvm_{name}", [f"logdir=runs/chip_smoke_{tag}"],
            tag=f"{tag}-train", epochs=epochs, teacher_stats=teacher)
    by_path["multisimmatch_bn_adapt"] = {
        "bn_stats": adapt_and_serve("config_dvm_MultiSimMatch",
                                    "multisimmatch")}
    check_comatch_buffers(
        load_config("config_dvm_MultiCoMatch", TRAIN_OVERRIDES), dev)
    for name, teacher, _ in FIXMATCH[1::2]:
        cfg = load_config(f"config_dvm_{name}", TRAIN_OVERRIDES)
        train_step_kernel_vs_plain(cfg, dev, teacher_stats=teacher)
        profile_beside(cfg, dev, single, name, teacher_stats=teacher)
    return by_path


def fast_profile_phase(dev, single: dict) -> dict:
    """Phase 13: training in the fast numerics profile, then one of its
    steps profiled beside phase 8's single-batch step (``single``);
    returns the kernels' launch counts of the training run."""
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    from stil_tta_torch.train.optim import Adam, set_learning_rate
    extra = [f"micro_batches={MICRO}", "adam_mu_dtype=bfloat16",
             "logdir=runs/chip_smoke_fast"]
    cfg, launches, sps = train_full_width(
        "config_dvm_STiL", extra, per_step=53 * MICRO, tag="fast", epochs=1)
    train_step_kernel_vs_plain(cfg, dev, per_step=53 * MICRO)
    algo, step, batch = step_setup(cfg, dev)
    state = algo.init_state(0)
    set_learning_rate(state.optimizer, STEP_LR)
    bn_stats.launches = bn_bwd_reduce.launches = 0
    step(state, *batch, 1)
    torch.cuda.synchronize()
    per_step = (bn_stats.launches, bn_bwd_reduce.launches)
    if per_step != (53 * MICRO, 53 * MICRO):
        raise SystemExit(f"fast profile: {per_step} launches a step")
    moments = state.optimizer.state.values()
    if not isinstance(state.optimizer, Adam) or not moments or any(
            st["exp_avg"].dtype != torch.bfloat16 for st in moments):
        raise SystemExit("fast profile: the first moment is not bfloat16")
    fast = profile_train_step(state, step, batch, tag=f"m={MICRO}")
    log(f"[fast] steps/s over the epoch {sps:.3f} (m={MICRO}); one "
        f"step: host {fast['host_ms']:.3f} ms vs {single['host_ms']:.3f} ms "
        f"(m=1), device busy {fast['busy_ms']:.3f} vs "
        f"{single['busy_ms']:.3f} ms, idle share "
        f"{1 - fast['busy_ms'] / fast['host_ms']:.1%} vs "
        f"{1 - single['busy_ms'] / single['host_ms']:.1%}, kernel launches "
        f"{fast['kernel_launches']} vs {single['kernel_launches']}")
    return launches


def missing_phase() -> dict:
    """Phase 16 (d): phase 4's test-time slice with ``missing_tabular``
    (random masks at rate 0.3): ``test()`` with BN-adapt, 53 ``bn_stats``
    a statistics batch; then on fresh weights, after BN-adapt, the eval
    step's probabilities with and without the masks, which must differ
    (the masks reach the tabular encoder's attention)."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.train.test import build_algo, load_test_split
    from stil_tta_torch.tta import adapt
    flags = ["missing_tabular=true", "missing_strategy=random",
             "missing_rate=0.3"]
    launches = adapt_and_serve("config_dvm_STiL", "missing",
                               TEST_OVERRIDES + flags)
    cfg = load_config("config_dvm_STiL", TEST_OVERRIDES + flags + [
        "tta_strategy=bn_adapt"])
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, "cuda")
    cache = DeviceCache(src, device="cuda").as_dict()
    adapt(cfg, algo, cache)
    step = algo.make_eval_step()
    idx = torch.arange(int(cfg.batch_size), device="cuda")
    masked = step(cache, idx)["prob_m"].float()
    clean = {k: v for k, v in cache.items() if k != "missing"}
    plain = step(clean, idx)["prob_m"].float()
    share = float(cache["missing"].float().mean())
    diff = float((masked - plain).abs().max())
    log(f"[missing] masks: {share:.3f} of the test split's fields missing "
        f"(rate 0.3); prob_m with and without them max abs diff {diff:.3e}")
    if not 0.25 < share < 0.35 or not diff > 1e-4 \
            or not bool(torch.isfinite(masked).all()):
        raise SystemExit("missing_tabular: the masks did not reach the "
                         "model")
    return {"bn_stats": launches}


def cardiac_phase(dev, single: dict) -> dict:
    """Phase 16: cardiac STiL, ``Supervised``, ``TabularEval``,
    ``missing_tabular`` and cardiac MultiSimMatch at full width; returns
    the kernels' launch counts of their paths."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    by_path = {}
    # (a) cardiac STiL: training, a float32 kernel-against-plain step, a
    # profiled bf16 step, test() with BN-adapt and serving at batch 256
    cfg, by_path["cardiac_stil_train"], sps = train_full_width(
        "config_cardiac_STiL",
        CARDIAC_DATA + ["logdir=runs/chip_smoke_cardiac"],
        tag="cardiac-train")
    if cfg.algorithm_name != "STiL" or cfg.target != "CAD" \
            or int(cfg.batch_size) != CARDIAC_BATCH:
        raise SystemExit("cardiac STiL: the config did not compose")
    train_step_kernel_vs_plain(cfg, dev)
    profile_beside(cfg, dev, single, "cardiac STiL")
    by_path["cardiac_stil_bn_adapt"] = {"bn_stats": adapt_and_serve(
        "config_cardiac_STiL", "cardiac-test",
        CARDIAC_DATA + ["test=True", "tta=True"], serve_batch=CARDIAC_BATCH)}
    # (b) Supervised on DVM: the labelled 64 rows of each batch
    sup = ["algorithm_name=Supervised"]
    _, by_path["supervised_train"], _ = train_full_width(
        "config_dvm_STiL", sup + ["logdir=runs/chip_smoke_supervised"],
        tag="supervised-train", epochs=1)
    sup_cfg = load_config("config_dvm_STiL", TRAIN_OVERRIDES + sup)
    train_step_kernel_vs_plain(sup_cfg, dev)
    profile_beside(sup_cfg, dev, single, "Supervised")
    # (c) TabularEval: no image tower, no BatchNorm, no kernel
    tab = ["algorithm_name=TabularEval", "eval_datatype=tabular"]
    _, by_path["tabular_eval_train"], _ = train_full_width(
        "config_dvm_STiL", tab + ["logdir=runs/chip_smoke_tabular"],
        per_step=0, tag="tabular-train", epochs=1)
    by_path["tabular_eval_bn_adapt"] = {"bn_stats": adapt_and_serve(
        "config_dvm_STiL", "tabular-test", TEST_OVERRIDES + tab,
        per_batch=0)}
    # (d) missing_tabular
    by_path["missing_bn_adapt"] = missing_phase()
    # (e) cardiac MultiSimMatch: two bf16 steps with the rotating
    # hard-eval labelled view
    from stil_tta_torch.train.optim import set_learning_rate
    cfg = load_config("config_cardiac_MultiSimMatch",
                      TRAIN_OVERRIDES + CARDIAC_DATA)
    algo, step, batch = step_setup(cfg, dev)
    state = algo.init_state(0)
    set_learning_rate(state.optimizer, STEP_LR)
    bn_stats.launches = bn_bwd_reduce.launches = 0
    for _ in range(2):
        step(state, *batch, 1)
    torch.cuda.synchronize()
    launches = {"bn_stats": bn_stats.launches,
                "bn_bwd_reduce": bn_bwd_reduce.launches}
    loss = float(state.log_sums["loss"]) / float(state.log_count)
    log(f"[cardiac] MultiSimMatch two bf16 steps at batch "
        f"{cfg.batch_size}: labelled view rotates up to "
        f"{algo.aug_labeled.rotate_limit} degrees, mean loss {loss:.4f}, "
        f"launches {launches} (53 + 53 a step)")
    if launches != {"bn_stats": 106, "bn_bwd_reduce": 106} \
            or algo.aug_labeled.rotate_limit != 45.0 \
            or not math.isfinite(loss):
        raise SystemExit("cardiac MultiSimMatch: launches, view or loss off")
    by_path["cardiac_multisimmatch_steps"] = launches
    log(f"[cardiac] steps/s cardiac STiL {sps:.3f} (second epoch, batch "
        f"{CARDIAC_BATCH})")
    return by_path


def ptxas_report(source: str) -> dict:
    """Registers, shared memory and spills of each kernel entry of a built
    source, from its ``-Xptxas -v`` report: {mangled name: summary}."""
    from stil_tta_torch.ops import cuda_build
    report, entry = {}, None
    for line in cuda_build.build_log(source).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("spill" in line or "Used" in line):
            report[entry] = f"{report.get(entry, '')} {line.strip()}".strip()
    return report


def probe_phase() -> list:
    """Phase 11: the probe's kernels against their plain versions, then
    its entry point with the launch counts read around it; returns the
    record rows of the three kernels."""
    from stil_tta_torch.ops.conv_chain import (conv_bwd_join, conv_chain,
                                               conv_chain_scratch)
    from stil_tta_torch.tools import bench_conv_probe as probe
    t0 = time.perf_counter()
    chain_in = probe.make_inputs("cuda")
    join_in = probe.make_join_inputs("cuda")
    log(f"[probe] inputs M={probe.M} K={probe.K} N={probe.N} "
        f"NJ={probe.NJ} (numpy RandomState, seeds 0 and 1) in "
        f"{time.perf_counter() - t0:.1f} s")
    max_abs = collections.defaultdict(float)
    m_r = probe.M - RAGGED
    for name in probe.KERNELS:
        inputs = join_in if name == "conv_bwd_join" else chain_in
        ragged = tuple(t[:m_r] if t.dim() == 2 and t.shape[0] == probe.M
                       else t for t in inputs)
        for m, args in ((probe.M, inputs), (m_r, ragged)):
            check = probe.check_kernel(name, args)
            log(f"[probe] {name} M={m:,d} vs plain: {json.dumps(check)} "
                f"(tol: at most {probe.ULP_SHARE:.0e} of outputs differ, "
                f"each by <= {check['ulp_limit']} ulp; sums "
                f"{probe.SUM_TOL:.0e} of sum|.|)")
            if not probe.passes(check):
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"at M={m}")
            max_abs[name] = max(max_abs[name], check["max_abs_err"])

    kernels = {"conv_chain": conv_chain,
               "conv_chain_scratch": conv_chain_scratch,
               "conv_bwd_join": conv_bwd_join}
    for fn in kernels.values():
        fn.launches = 0
    result = probe.run(chain_in, join_in,
                       log=lambda line: log(f"[probe] {line}"))
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"[probe] launches in the probe's run {launches}")
    if min(launches.values()) == 0:
        raise SystemExit("a probe kernel was not launched by the probe")

    dy_up, w1 = join_in[:2]
    plain_ms = {name: probe.measure(
        lambda fn=plain, a=(join_in if name == "conv_bwd_join"
                            else chain_in): fn(*a))
        for name, (_, plain) in probe.KERNELS.items()}
    gemm_join = probe.measure(lambda: torch.matmul(dy_up, w1.T))
    ms = result["ms"]
    log(f"[probe] plain versions {json.dumps(plain_ms)} ms; join GEMM "
        f"torch.matmul(dy_up, w1.T) {gemm_join:.4f} ms")
    from stil_tta_torch.ops.conv_chain import _plan
    plans = {"conv_chain": _plan(probe.K, probe.N),
             "conv_bwd_join": _plan(probe.N, probe.NJ, join=True)}
    # the kernel entries: conv_chain_kernel<false>, <true>, the join's
    entries = {"conv_chain": "conv_chain_kernelILb0",
               "conv_chain_scratch": "conv_chain_kernelILb1",
               "conv_bwd_join": "conv_bwd_join_kernel"}
    rows = []
    for name, variant, lib, line in (
            ("conv_chain", "pallas_chain", ms["gemm"], 100),
            ("conv_chain_scratch", "pallas_chain_scratch", ms["gemm"], 165),
            ("conv_bwd_join", "pallas_bwd_join", gemm_join, 277)):
        source = "conv_bwd_join" if name == "conv_bwd_join" else "conv_chain"
        bound, by = result["bounds"]["join" if "join" in name else "chain"]
        ptxas = [v for k, v in ptxas_report(source).items()
                 if entries[name] in k]
        plan = plans[source]
        log(f"[probe] {name}: {ms[variant]:.4f} ms, {bound / ms[variant]:.1%}"
            f" of the {bound:.4f} ms bound; ptxas: {' | '.join(ptxas)}; "
            f"dynamic shared memory {plan['smem']:,d} bytes, "
            f"{plan['stages']} stages of {plan['stage_bytes']:,d}")
        if not ptxas:
            raise SystemExit(f"no ptxas report for {name}")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"stil_tta_torch/csrc/{source}.cu",
            "replaces": f"tools/bench_conv_probe.py:{line}",
            "launches": launches[name], "max_abs_err": max_abs[name],
            "ms": ms[variant], "plain_ms": plain_ms[name],
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "library_call": "torch.matmul of the same product: GEMM only, "
                            "not the same function"})
    return rows


def time_forward(shapes, gen, dev, buf, clean, batch: int) -> tuple:
    """Phase 9: ``bn_stats`` per (M, C) of ``shapes`` (a Counter of one
    ResNet-50 forward at ``batch``), bf16, against its bound, its plain
    version and ``torch.batch_norm_stats``, and with ``clean`` (a buffer
    whose sum flushes L2 by reading) also after that flush; returns the
    forward's totals and what bounds it."""
    from stil_tta_torch.ops.batch_norm import (bn_stats, bn_stats_plain,
                                               bn_stats_plan)
    lib_fn = lambda x: torch.batch_norm_stats(x, 1e-5)  # noqa: E731
    tot = collections.defaultdict(float)
    nbytes_all = nops_all = 0
    for (m, c), n in shapes.items():
        x = torch.randn(m, c, generator=gen, device=dev).to(torch.bfloat16)
        t_k = time_ms(bn_stats, x, buf)
        t_p = time_ms(bn_stats_plain, x, buf)
        t_l = time_ms(lib_fn, x, buf)
        nbytes = m * c * 2 + 2 * c * 4
        nops = 3 * m * c
        bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS) * 1e3
        after = ""
        if clean is not None:
            t_c = time_ms(bn_stats, x, buf, flush=clean.sum)
            tot["clean_ms"] += n * t_c
            after = (f"; kernel after a reading flush {t_c:.4f} ms "
                     f"({bound / t_c:.1%})")
        plan = bn_stats_plan(x)
        log(f"[time] M={m:>9,d} C={c:>5d} x{n:<2d} kernel {t_k:.4f} ms "
            f"bound {bound:.4f} ms ({bound / t_k:.1%} of bound) plain "
            f"{t_p:.4f} ms batch_norm_stats {t_l:.4f} ms{after}; plan grid "
            f"{plan.grid}, {plan.tiles} tile(s) of {plan.tile_c} x "
            f"{plan.chunks} chunks of {plan.rows_per_chunk} rows, "
            f"{plan.stages} stages of {plan.stage_rows} rows "
            f"({plan.stage_bytes:,d} bytes), {plan.chunks} partial "
            f"rows, smem {plan.smem:,d}")
        tot["ms"] += n * t_k
        tot["plain_ms"] += n * t_p
        tot["library_ms"] += n * t_l
        tot["bound_ms"] += n * bound
        nbytes_all += n * nbytes
        nops_all += n * nops
        del x
    bound_by = ("bytes" if nbytes_all / HBM_BYTES_PER_S
                >= nops_all / F32_FLOPS else "operations")
    after = ("" if clean is None else
             f"; kernel after a reading flush {tot['clean_ms']:.4f} ms "
             f"({tot['bound_ms'] / tot['clean_ms']:.1%})")
    log(f"[time] one forward (53 BNs, batch {batch}): kernel "
        f"{tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
        f"({nbytes_all / 1e9:.3f} GB; the kernel at "
        f"{tot['bound_ms'] / tot['ms']:.1%} of it), plain "
        f"{tot['plain_ms']:.4f} ms, batch_norm_stats "
        f"{tot['library_ms']:.4f} ms{after}")
    return tot, bound_by


def time_backward(shapes, gen, dev, buf, batch: int) -> tuple:
    """Phase 9: ``bn_bwd_reduce`` per (M, C) of ``shapes``, bf16, against
    its bound, its plain version and
    ``torch.batch_norm_backward_reduce``: x and dy read once, mean and inv
    read, two sums out; returns the backward's totals and what bounds
    it."""
    from stil_tta_torch.ops.batch_norm import (bn_bwd_reduce,
                                               bn_bwd_reduce_plain,
                                               bn_bwd_reduce_plan)
    lib_bwd = lambda t: torch.batch_norm_backward_reduce(  # noqa: E731
        t[1], t[0], t[2], t[3], t[4], True, True, True)
    tot_b = collections.defaultdict(float)
    nbytes_all = nops_all = 0
    for (m, c), n in shapes.items():
        x = (torch.randn(m, c, generator=gen, device=dev)
             + 0.5).to(torch.bfloat16)
        dy = torch.randn(m, c, generator=gen, device=dev).to(torch.bfloat16)
        mean = x.float().mean(0)
        inv = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
        weight = torch.ones(c, device=dev)
        args = (x, dy, mean, inv, weight)
        t_k = time_ms(lambda t: bn_bwd_reduce(*t[:4]), args, buf)
        t_p = time_ms(lambda t: bn_bwd_reduce_plain(*t[:4]), args, buf)
        t_l = time_ms(lib_bwd, args, buf)
        nbytes = 2 * m * c * 2 + 4 * c * 4
        nops = 5 * m * c
        bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS) * 1e3
        plan = bn_bwd_reduce_plan(x, dy)
        log(f"[time] bwd M={m:>9,d} C={c:>5d} x{n:<2d} kernel {t_k:.4f} ms "
            f"bound {bound:.4f} ms ({bound / t_k:.1%} of bound) plain "
            f"{t_p:.4f} ms batch_norm_backward_reduce {t_l:.4f} ms "
            f"({t_l / t_k:.2f}x the kernel's); plan grid {plan.grid}, "
            f"{plan.tiles} tile(s) of {plan.tile_c} x {plan.chunks} chunks "
            f"of {plan.rows_per_chunk} rows, {plan.stages} stages of "
            f"{plan.stage_rows} rows ({plan.stage_bytes:,d} bytes of x and "
            f"of dy), smem {plan.smem:,d}")
        tot_b["ms"] += n * t_k
        tot_b["plain_ms"] += n * t_p
        tot_b["library_ms"] += n * t_l
        tot_b["bound_ms"] += n * bound
        tot_b["slower_than_library"] += t_k > t_l
        nbytes_all += n * nbytes
        nops_all += n * nops
        del x, dy, args
    bound_by = ("bytes" if nbytes_all / HBM_BYTES_PER_S
                >= nops_all / F32_FLOPS else "operations")
    log(f"[time] one backward (53 BNs, batch {batch}): kernel "
        f"{tot_b['ms']:.4f} ms, bound {tot_b['bound_ms']:.4f} ms "
        f"({nbytes_all / 1e9:.3f} GB; the kernel at "
        f"{tot_b['bound_ms'] / tot_b['ms']:.1%} of it), plain "
        f"{tot_b['plain_ms']:.4f} ms, batch_norm_backward_reduce "
        f"{tot_b['library_ms']:.4f} ms; {int(tot_b['slower_than_library'])}"
        f" of {len(shapes)} shapes slower than the library call")
    return tot_b, bound_by


def resnet50_conv_shapes(device, batch: int = BATCH) -> list:
    """(batch, Cin, H, W, Cout, k, stride, padding) of each of
    ResNet-50's 53 convolutions at ``batch`` and IMG, in forward order."""
    from stil_tta_torch.models.resnet import Conv2d, resnet50
    tower = resnet50(dtype=torch.bfloat16).to(device).eval()
    seen = []
    for m in tower.modules():
        if isinstance(m, Conv2d):
            m.register_forward_pre_hook(
                lambda mod, inp: seen.append(
                    (batch, inp[0].shape[1], inp[0].shape[2],
                     inp[0].shape[3], mod.out_channels, mod.kernel_size[0],
                     mod.stride[0], mod.padding[0])))
    with torch.no_grad():
        tower(torch.zeros(1, IMG, IMG, 3, device=device))
    return seen


def _conv_inputs(shape, gen, dev):
    b, cin, h, w, cout, k, _, _ = shape
    x = torch.randn(b, cin, h, w, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = torch.randn(cout, cin, k, k, generator=gen, device=dev) * math.sqrt(
        2.0 / (cout * k * k))
    return x, wt


def check_int8_convs(shapes, gen, dev) -> int:
    """Phase 17 (a): at each conv shape the integer GEMM's s32 sums equal
    a float64 ``F.conv2d`` of the same int8 tensors on the card bit for
    bit, the bfloat16 and float32 outputs equal the plain route's, and
    two calls agree bit for bit; returns the shapes checked."""
    from stil_tta_torch.ops import quant_conv as qc
    for shape in shapes:
        s, p = shape[6:]
        x, wt = _conv_inputs(shape, gen, dev)
        x_q, w_q, _, _ = qc.quantize(x, wt)
        y = qc.int8_conv_card(x_q, w_q, s, p)
        ok = torch.equal(y, qc.int8_conv_plain(x_q, w_q, s, p))
        for dt in (torch.bfloat16, torch.float32):
            got = qc.quant_conv2d(x, wt, s, p, dt)
            ok = ok and torch.equal(got, qc.quant_conv2d(x, wt, s, p, dt))
            ok = ok and torch.equal(got, qc.quant_conv2d_plain(x, wt, s, p,
                                                               dt))
        log(f"[int8] {shape}: s32 sums, bf16 and f32 outputs bitwise equal "
            f"to plain and repeatable: {ok}")
        if not ok:
            raise SystemExit(f"int8 conv disagrees with plain at {shape}")
        del x, wt, x_q, w_q, y
    return len(shapes)


def time_int8_convs(shapes, gen, dev, buf) -> dict:
    """Phase 17 (b): each part of the int8 route (quantize, im2col and
    the weight matrix, ``torch._int_mm``, the epilogue) and the whole
    route, beside the bfloat16 cuDNN conv at the same shape, each after
    an L2 flush; per shape and summed over ``shapes`` (a Counter)."""
    import torch.nn.functional as F
    from stil_tta_torch.ops import quant_conv as qc
    tot = collections.defaultdict(float)
    for shape, n in shapes.items():
        b, cin, h, w, cout, k, s, p = shape
        x, wt = _conv_inputs(shape, gen, dev)
        x_q, w_q, s_x, s_w = qc.quantize(x, wt)
        cols, (_, ho, wo) = qc.im2col(x_q, k, k, s, p)
        wm = qc.weight_matrix(w_q, cols.shape[-1])
        cols, wm = cols[0], wm[0]
        y = torch._int_mm(cols, wm)
        m = b * ho * wo

        def epilogue(t):
            return qc.dequantize(t[:m, :cout].reshape(b, ho, wo, cout)
                                 .permute(0, 3, 1, 2), s_x, s_w,
                                 torch.bfloat16)

        wb = wt.to(torch.bfloat16)
        parts = {
            "quantize": time_ms(lambda a: qc.quantize(*a), (x, wt), buf, 20),
            "im2col": time_ms(lambda a: (qc.im2col(a, k, k, s, p),
                                         qc.weight_matrix(w_q, cols.shape[-1])),
                              x_q, buf, 20),
            "int_mm": time_ms(lambda a: torch._int_mm(*a), (cols, wm), buf,
                              20),
            "epilogue": time_ms(epilogue, y, buf, 20),
            "int8": time_ms(lambda a: qc.quant_conv2d(a, wt, s, p,
                                                      torch.bfloat16),
                            x, buf, 20),
            "bf16": time_ms(lambda a: F.conv2d(a, wb, None, s, p), x, buf,
                            20)}
        ops = 2 * m * cout * cin * k * k
        nbytes = x.numel() * 2 + wt.numel() * 4 + m * cout * 2
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS) * 1e3
        log(f"[int8-time] {shape} x{n}: quantize {parts['quantize']:.4f} ms"
            f", im2col {parts['im2col']:.4f} ms, _int_mm "
            f"{parts['int_mm']:.4f} ms ({ops / parts['int_mm'] / 1e9:.1f} "
            f"TOP/s), epilogue {parts['epilogue']:.4f} ms; int8 route "
            f"{parts['int8']:.4f} ms against bf16 cuDNN {parts['bf16']:.4f}"
            f" ms ({parts['int8'] / parts['bf16']:.2f}x); int8 bound "
            f"{bound:.4f} ms; GEMM {m} x {cols.shape[1]} x {wm.shape[1]}")
        for key, t in parts.items():
            tot[key] += n * t
        tot["bound"] += n * bound
        del x, wt, x_q, cols, wm, y
    log(f"[int8-time] the 53 convs of one forward (batch {BATCH}): "
        + ", ".join(f"{key} {t:.4f} ms" for key, t in tot.items())
        + f"; int8 route / bf16 cuDNN {tot['int8'] / tot['bf16']:.2f}x")
    return dict(tot)


def int8_forward_phase(algo, images, tabular, int_mm_calls: int = 53
                       ) -> float:
    """Phase 17 (c) (and 19 (c) for ResNeXt-50): the eval forward of the
    net's tower at batch 512, int8 against bf16 on the same weights and
    inputs: the cosine of the pooled features (> 0.99, the JAX package's
    bound), the share of agreeing argmaxes of ``out_m``, both towers'
    times, and a profile of the int8 tower: ``int_mm_calls``
    ``aten::_int_mm`` calls (53 for ResNet-50), the GEMM kernels they
    launch by name, and no convolution kernel. Returns the cosine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    net = algo.net.eval()
    tower = net.model.encoder_imaging
    img = algo.aug_eval(images)
    with torch.no_grad():
        pooled = {q: tower(img, int8=q)[-1].float().mean((1, 2))
                  for q in (False, True)}
        out_m = {q: net(img, tabular, int8_image=q)["out_m"]
                 for q in (False, True)}
        a, b = pooled[False], pooled[True]
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        per = torch.nn.functional.cosine_similarity(a, b, dim=1)
        agree = float((out_m[False].argmax(1)
                       == out_m[True].argmax(1)).float().mean())
        ms = {}
        for q in (False, True, True, False):
            tower(img, int8=q)
            torch.cuda.synchronize()
            t = []
            for _ in range(5):
                t0 = time.perf_counter()
                tower(img, int8=q)
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            ms.setdefault(q, []).append(sorted(t)[2])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tower(img, int8=True)
            torch.cuda.synchronize()
    events = prof.key_averages()
    int_mm = sum(e.count for e in events if e.key == "aten::_int_mm")
    kernels = collections.Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] += e.count
    gemm = {k: n for k, n in kernels.items()
            if any(t in k.lower() for t in ("gemm", "xmma", "cutlass",
                                           "splitk", "imma"))}
    convs = {k: n for k, n in kernels.items()
             if any(t in k.lower() for t in CONV_KERNEL_MARKS)}
    log(f"[int8] eval forward of the {algo.cfg.model} tower at batch "
        f"{img.shape[0]}: cosine "
        f"of the pooled features, int8 against bf16, {cos:.6f} (bound 0.99;"
        f" per sample min {float(per.min()):.6f}); out_m argmax agreement "
        f"{agree:.4f}; tower forward int8 {ms[True]} ms, bf16 {ms[False]} "
        f"ms (medians of 5, in turns)")
    log(f"[int8] profile of the int8 tower: {int_mm} aten::_int_mm calls; "
        f"GEMM kernels {sum(gemm.values())}: {json.dumps(gemm)}; "
        f"convolution kernels {json.dumps(convs)}")
    split = sum(gemm.values()) - int_mm
    if split:
        log(f"[int8] the integer GEMMs launch {split} kernels beside their "
            f"{int_mm} main ones (split-K or helper kernels)")
    if int_mm != int_mm_calls or convs or not math.isfinite(cos) \
            or cos <= 0.99:
        raise SystemExit(f"int8 eval forward: expected {int_mm_calls} "
                         "_int_mm calls, no convolution kernel and a cosine "
                         "over 0.99")
    return cos


def int8_phase(dev, single: dict, serve_sps: float) -> dict:
    """Phase 17 (a)-(d): the int8 convolution at every ResNet-50 shape,
    its timing, the int8 eval forward, teacher-int8 training and int8
    serving."""
    import numpy as np
    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.serve import Predictor
    from stil_tta_torch.train.optim import set_learning_rate
    gen = torch.Generator(device=dev).manual_seed(17)
    t0 = time.perf_counter()
    # (a) every distinct conv shape at batch 512 and 256
    per_forward = collections.Counter(resnet50_conv_shapes(dev))
    assert sum(per_forward.values()) == 53, per_forward
    cardiac = collections.Counter(resnet50_conv_shapes(dev, CARDIAC_BATCH))
    n = check_int8_convs(list(per_forward) + list(cardiac), gen, dev)
    log(f"[int8] {n} conv shapes ({len(per_forward)} at batch {BATCH}, "
        f"{len(cardiac)} at {CARDIAC_BATCH}) bitwise equal to plain "
        f"({time.perf_counter() - t0:.1f} s)")
    # (b) per-shape timing at batch 512
    t0 = time.perf_counter()
    buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    times = time_int8_convs(per_forward, gen, dev, buf)
    del buf
    log(f"[int8-time] {time.perf_counter() - t0:.1f} s")
    # (c) the eval forward, on phase 4's and 5's test split
    t_c = time.perf_counter()
    cfg = load_config("config_dvm_STiL", TEST_OVERRIDES)
    src = load_sources(cfg)["test"]
    algo = STiL(cfg, src.field_lengths, device=dev)
    algo.init_state(0)
    images = torch.as_tensor(np.asarray(src.images[:BATCH]), device=dev)
    tabular = torch.as_tensor(np.asarray(src.tabular[:BATCH], np.float32),
                              device=dev)
    int8_forward_phase(algo, images, tabular)
    # (d) serving at batch 512, int8 and bf16 in turns, beside phase 5
    imgs, tabs = np.asarray(src.images), np.asarray(src.tabular)
    sps = {}
    for q in (False, True, True, False):
        pred = Predictor(algo, batch_size=BATCH, int8=q)
        pred(imgs[:BATCH], tabs[:BATCH])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = pred(imgs, tabs)
        sps.setdefault(q, []).append(len(imgs) / (time.perf_counter() - t0))
        if not np.isfinite(probs).all() \
                or np.abs(probs.sum(1) - 1).max() > 1e-3:
            raise SystemExit("int8 serving: bad probabilities")
    log(f"[int8-serve] Predictor batch {BATCH}, {len(imgs)} samples: int8 "
        f"{sps[True]} samples/s, bf16 {sps[False]} samples/s (in turns); "
        f"phase 5's bf16 {serve_sps:.1f} samples/s "
        f"((c) and serving {time.perf_counter() - t_c:.1f} s)")
    del algo, images, tabular, pred
    # (d) teacher-int8 training with phase 6's flags, one epoch
    torch.cuda.reset_peak_memory_stats()
    cfg, launches, steps = train_full_width(
        extra=["teacher_int8=true", "logdir=runs/chip_smoke_int8"],
        tag="int8-train", epochs=1)
    log(f"[int8-train] {steps:.3f} steps/s against phase 6's "
        f"{single['steps_per_s']:.3f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    algo, step, batch = step_setup(cfg, dev)
    state = algo.init_state(0)
    set_learning_rate(state.optimizer, STEP_LR)
    prof = profile_train_step(state, step, batch, tag="teacher int8")
    log(f"[int8-train] profiled step against phase 8's: host "
        f"{prof['host_ms']:.3f} vs {single['host_ms']:.3f} ms, device busy "
        f"{prof['busy_ms']:.3f} vs {single['busy_ms']:.3f} ms, "
        f"{prof['int_mm_calls']} aten::_int_mm calls")
    if prof["int_mm_calls"] != 53 or prof["bn_bwd_reduce_kernels"] != 53:
        raise SystemExit("teacher-int8 step: expected 53 _int_mm calls and "
                         "53 bn_bwd_reduce kernels")
    del algo, state, step, batch
    return {"stil_int8_teacher_train": launches}, times


def warm_start_phase(dev) -> dict:
    """Phase 17 (e): a warm-start checkpoint written by the port's
    converter from seeded random weights, then one epoch of
    ``config_dvm_STiL`` with ``finetune_strategy=frozen`` at ``lr_eval``
    (no warm-up): the encoders' parameters bitwise unchanged, their BN
    running statistics moved, the fusion and heads moved from their
    seeded initial values."""
    import tempfile
    from stil_tta_torch.algorithms.base import init_weights
    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.train.convert import save_encoder_checkpoint
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config("config_dvm_STiL", TRAIN_OVERRIDES)
        fl = load_sources(cfg)["train_labelled"].field_lengths
        donor = STiL(cfg, fl, device=dev).net.model
        init_weights(donor, torch.Generator(device=dev).manual_seed(23))
        ckpt = save_encoder_checkpoint(donor, Path(tmp) / "pretrained.ckpt")
        pre = torch.load(ckpt, weights_only=True)["state_dict"]
        start = STiL(cfg, fl, device=dev)
        start.init_state(int(cfg.seed or 0))
        start = {k: v.detach().cpu().clone()
                 for k, v in start.net.state_dict().items()}
        # no warm-up: epoch 0 trains at lr_eval (the schedule's warm-up
        # starts at 0), while the frozen group stays at 0
        cfg, launches, steps = train_full_width(
            extra=["test_and_eval=false", "logdir=runs/chip_smoke_frozen",
                   f"checkpoint={ckpt}", "finetune_strategy=frozen",
                   "checkpoint_every_n_epochs=1", "warmup_epochs=0"],
            tag="frozen", epochs=1)
    net = torch.load(Path(cfg.logdir) / "checkpoint_last",
                     weights_only=True, map_location="cpu")["net"]
    enc = {k: v for k, v in net.items()
           if k.split(".")[1] in ("encoder_imaging", "encoder_tabular")}
    stats = ("running_mean", "running_var", "num_batches_tracked")
    frozen = [k for k in enc if not k.endswith(stats)]
    same = all(torch.equal(enc[k], pre[k[len("model."):]]) for k in frozen)
    moved_stats = sum(not torch.equal(enc[k], pre[k[len("model."):]])
                      for k in enc if k.endswith(stats[:2]))
    n_stats = sum(k.endswith(stats[:2]) for k in enc)
    heads = ("model.reduce.weight", "model.classifier_multimodal.weight",
             "model.classifier_imaging.weight", "model.transformer.0.")
    moved_heads = {h: any(not torch.equal(v, start[k])
                          for k, v in net.items() if k.startswith(h))
                   for h in heads}
    log(f"[frozen] {len(frozen)} encoder parameters bitwise equal to the "
        f"warm-start file: {same}; {moved_stats} of {n_stats} BN running "
        f"statistics moved; fusion and heads moved: "
        f"{json.dumps(moved_heads)}; {steps:.3f} steps/s; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if not same or moved_stats != n_stats or not all(moved_heads.values()):
        raise SystemExit("frozen warm start: the encoders moved, or the BN "
                         "statistics, fusion or heads did not")
    return {"stil_frozen_train": launches}


def _dryruns(jobs: dict, meanwhile=None) -> dict:
    """``stil_tta_torch.tools.dryrun_multichip`` on the card once for each
    tag of ``jobs`` (its arguments), all started together; the PASS lines
    logged, each run's results returned by tag. ``meanwhile`` (if given)
    runs in this process while they do. Fails unless every case of every
    run passed."""
    import tempfile
    t0 = time.perf_counter()
    runs = {}
    for tag, args in jobs.items():
        out = tempfile.mkdtemp(prefix="dryrun_")
        runs[tag] = (out, args, subprocess.Popen(
            [sys.executable, "-m", "stil_tta_torch.tools.dryrun_multichip",
             "--device", "cuda", "--out", out, *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    if meanwhile is not None:
        try:
            meanwhile()
        except BaseException:
            for _, _, proc in runs.values():
                proc.kill()
                proc.wait()
            raise
    results, failed = {}, []
    for tag, (out, args, proc) in runs.items():
        stdout, stderr = proc.communicate(timeout=900)
        for line in stdout.splitlines():
            if line.startswith(("dryrun_multichip", "  ")):
                log(f"[dp] {tag}: {line}")
        log(f"[dp] {tag}: exit {proc.returncode} after "
            f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0:
            log(stdout[-4000:])
            log(stderr[-4000:])
            failed.append(tag)
            continue
        ranks = args[args.index("--ranks") + 1]
        results[tag] = json.loads(
            (Path(out) / f"dryrun_{ranks}.json").read_text())
    if failed:
        raise SystemExit(f"data parallel: the dry run failed: {failed}")
    return results


def data_parallel_phase(clock, meanwhile=None) -> dict:
    """Phase 18: the data-parallel slice on the one card (see the module's
    docstring); returns the per-rank launches of the 2-rank STiL step.
    ``meanwhile`` runs in this process beside (c) and (d)."""
    # (a), (b) at full width alone on the card, so that its host times and
    # collectives share are read without another process beside it; then
    # (c) NCCL alone on the card and (d) the tiny families over gloo, side
    # by side, with ``meanwhile`` (no timing of theirs is read)
    runs = _dryruns({"full width": [
        "--ranks", "2", "--scale", "full", "--profile", "--cases", "STiL",
        "serve", "serve[int8]"]})
    clock.lap("18 (a, b) data parallel at full width, alone")
    runs.update(_dryruns({"nccl": ["--ranks", "1", "--cases", "STiL"],
                          "tiny": ["--ranks", "2"]}, meanwhile))
    full = {r["case"]: r for r in runs["full width"]}
    r = full["STiL"]
    expected = [53, 53]   # (bn_stats, bn_bwd_reduce) a rank-step
    launches_ok = (all(step == expected for rank in r["launches_by_rank"]
                       for step in rank)
                   and all(s == expected for s in r["launches_single"]))
    diffs = {k: r["max_abs_diff"].get(k) for k in
             ("params", "running", "prototypes_sum")}
    coll = r["collectives"]
    log(f"[dp] STiL float32, global batch 512 on 2 ranks against 1 "
        f"process: largest differences {json.dumps(diffs)} (tol "
        f"{r['atol']} + {r['rtol']} x |value|; Adam moments, buffers and "
        f"loss sums as the JAX dry run holds them); first step's summed "
        f"gradients against the single process's: worst relative L2 gap "
        f"{r['grad_gap']:.3e} (limit {r['grad_limit']}; worst leaves "
        f"{r['grad_worst']}); ranks bitwise equal "
        f"{r['ranks_equal']}; launches (bn_stats, bn_bwd_reduce) by rank "
        f"and step {r['launches_by_rank']}, single {r['launches_single']}")
    log(f"[dp] host time a step: 2 ranks {r['host_ms']} ms, 1 process "
        f"{r['host_ms_single']} ms; collectives (dp.all_reduce and "
        f"dp.all_gather ranges, rank 0's profiled step) {coll['ms']:.1f} ms"
        f" = {coll['share']:.3f} of the step; calls {coll['calls']}")
    if not (r["ok"] and r["ranks_equal"] and launches_ok):
        raise SystemExit("data parallel: the 2-rank step differs from the "
                         "single one, the ranks differ, or a kernel's "
                         "launches are off")
    for case in ("serve", "serve[int8]"):
        s = full[case]
        log(f"[dp] {case} (bf16 net) at batch 512 over {s['rows']} rows: "
            f"largest probability difference {s['max_abs_diff']:.3e} (tol "
            f"{s['atol']}); argmax equal {s['argmax_equal']}")
    backends = {tag: sorted({c["backend"] for c in res})
                for tag, res in runs.items() if tag != "full width"}
    log(f"[dp] process group backends: {backends}")
    if backends != {"nccl": ["nccl"], "tiny": ["gloo"]}:
        raise SystemExit("data parallel: one rank on the card did not form "
                         "an NCCL group, or two ranks on it not a gloo one")
    # rank 0's measured launches at the last step
    last = r["launches_by_rank"][0][-1]
    return {"stil_dp_step_per_rank": {"bn_stats": last[0],
                                      "bn_bwd_reduce": last[1]}}


# ---- phase 19: the host stream and the rest of the encoder zoo -----------

HOST_LABELLED, HOST_UNLABELLED = 4096, 32768   # 128² x 3 uint8 rows
HOST_STEPS = 16             # limit_train_batches of the host-stream epoch
HOST_DATA = Path("runs/chip_smoke_host_data")
# the ResNets of the zoo beyond ResNet-50, each with its BatchNorm count
# (the launches of each BN kernel a train step)
ZOO_RESNETS = (("resnet34", 36), ("resnet101", 104), ("resnet152", 155),
               ("resnext50_32x4d", 53), ("resnext101_32x8d", 104),
               ("wide_resnet50_2", 53), ("wide_resnet101_2", 104))
ZOO_VITS = ("vit_small", "vit_base")
# the zoo's ResNets whose step is timed (the smallest and the one with the
# most device work); every one of them is stepped, its BN kernels counted
# by the counters and the profiler, and held against the plain pair
ZOO_TIMED = ("resnet34", "resnext101_32x8d")
# ResNeXt-50's teacher forward in int8: 37 ungrouped convs, one integer
# GEMM each, and 16 grouped 3x3 convs of 32 groups, one GEMM a group
RESNEXT50_INT_MM = 37 + 16 * 32
# int8 against bf16 serving of ResNeXt-50 with random weights (286
# classes): the share of agreeing argmaxes must pass this (0.9824 read on
# the H100)
INT8_SERVE_AGREE = 0.95


def zoo_bn_shapes(name: str, batch: int = BATCH) -> list:
    """(M, C) of each BatchNorm input of the ``name`` tower at ``batch``
    and IMG, in forward order (read on the meta device)."""
    from stil_tta_torch.models.resnet import image_encoder
    from stil_tta_torch.ops.batch_norm import BatchNorm2d
    with torch.device("meta"):
        tower = image_encoder(name).eval()
    seen = []
    for m in tower.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(lambda mod, inp: seen.append(
                (batch * inp[0].shape[2] * inp[0].shape[3], inp[0].shape[1])))
    with torch.no_grad():
        tower(torch.zeros(1, IMG, IMG, 3, device="meta"))
    return seen


def grouped_conv_shapes(name: str, batch: int = BATCH) -> list:
    """(batch, Cin, H, W, Cout, k, stride, padding, groups) of each
    grouped convolution of the ``name`` tower, in forward order."""
    from stil_tta_torch.models.resnet import Conv2d, image_encoder
    with torch.device("meta"):
        tower = image_encoder(name).eval()
    seen = []
    for m in tower.modules():
        if isinstance(m, Conv2d) and m.groups > 1:
            m.register_forward_pre_hook(lambda mod, inp: seen.append(
                (batch, inp[0].shape[1], inp[0].shape[2], inp[0].shape[3],
                 mod.out_channels, mod.kernel_size[0], mod.stride[0],
                 mod.padding[0], mod.groups)))
    with torch.no_grad():
        tower(torch.zeros(1, IMG, IMG, 3, device="meta"))
    return seen


def _tensors(tree, prefix=""):
    """Every tensor of a checkpoint payload, by path."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}/{i}")


def write_host_splits(field_lengths) -> dict:
    """Phase 19 (a): the DVM-width splits written from the seed as
    artifact directories under HOST_DATA (images memmapped when read);
    returns each split's bytes on disk."""
    from stil_tta_torch.data.source import synthetic_source
    shutil.rmtree(HOST_DATA, ignore_errors=True)
    sizes = {}
    for seed, (split, n, frac) in enumerate((
            ("train_labelled", HOST_LABELLED, 1.0),
            ("train_unlabelled", HOST_UNLABELLED, 0.0),
            ("val", 1024, 1.0), ("test", 512, 1.0))):
        synthetic_source(n, num_classes=286, field_lengths=field_lengths,
                         image_size=IMG, labelled_frac=frac,
                         seed=seed).save(HOST_DATA / split)
        sizes[split] = sum(f.stat().st_size
                           for f in (HOST_DATA / split).iterdir())
    return sizes


def host_stream_run(host_stream: bool, tag: str) -> dict:
    """One epoch of ``config_dvm_STiL`` at batch 512 from HOST_DATA,
    HOST_STEPS steps; returns the checkpoint's tensors, the launches,
    the steps/s and the host streams the run made."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data import loader as loader_mod
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    from stil_tta_torch.train import evaluate as evaluate_mod
    logdir = Path(f"runs/chip_smoke_host_{tag}")
    shutil.rmtree(logdir, ignore_errors=True)
    cfg = load_config("config_dvm_STiL", [
        "dataset=synthetic_dvm", "num_classes=286", "batch_size=512",
        "synthetic=false", f"data_base={HOST_DATA}", "evaluate=True",
        "start_epoch=0", "strict_prototypes=false", "test_and_eval=false",
        "enable_progress_bar=false", "max_epochs=1",
        f"limit_train_batches={HOST_STEPS}", "limit_val_batches=1",
        "checkpoint_every_n_epochs=1", f"logdir={logdir}",
        f"host_stream={str(host_stream).lower()}"])
    streams = []

    class Recorded(loader_mod.HostStream):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            streams.append(self)

    evaluate_mod.HostStream = Recorded
    bn_stats.launches = bn_bwd_reduce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        evaluate_mod.evaluate(cfg, device="cuda")
    finally:
        evaluate_mod.HostStream = loader_mod.HostStream
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (bn_stats.launches, bn_bwd_reduce.launches)
    rec = [json.loads(line) for line in
           (logdir / "metrics.jsonl").read_text().splitlines()]
    sps = [r["multimodal.train.samples_per_sec"] for r in rec
           if "multimodal.train.samples_per_sec" in r][-1]
    payload = torch.load(logdir / "checkpoint_last", map_location="cpu",
                         weights_only=True)
    log(f"[host] {tag}: host_stream {host_stream}, {HOST_STEPS} steps at "
        f"batch 512: {sps / 512:.3f} steps/s (epoch, host clock), run "
        f"{wall:.1f} s; launches (bn_stats, bn_bwd_reduce) {launches} "
        f"(expected {(53 * HOST_STEPS,) * 2}); step {payload['step']}")
    if launches != (53 * HOST_STEPS,) * 2 or payload["step"] != HOST_STEPS:
        raise SystemExit(f"host stream phase ({tag}): launch count or step "
                         "off the path")
    return {"tensors": dict(_tensors(payload)), "steps_per_s": sps / 512,
            "streams": streams, "launches": launches}


def profile_host_stream_step(dev) -> None:
    """One STiL step fed by two host streams (the next batches gathered,
    copied and waited for inside the timed region) against one fed by
    ``DeviceCache`` gathers, in turns on one state, on the host's clock;
    then a host-stream step under the profiler: device busy and the
    idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.data.loader import (VIRTUAL_CACHE_KEYS,
                                            CyclingEpochView, CyclingSampler,
                                            DeviceCache, EpochSampler,
                                            HostStream)
    from stil_tta_torch.train.optim import set_learning_rate
    cfg = load_config("config_dvm_STiL", TRAIN_OVERRIDES + [
        "synthetic=false", f"data_base={HOST_DATA}"])
    src = load_sources(cfg)
    src_l, src_u = src["train_labelled"], src["train_unlabelled"]
    algo = STiL(cfg, src_l.field_lengths, device=dev)
    state = algo.init_state(0)
    set_learning_rate(state.optimizer, STEP_LR)
    step = algo.make_train_step()
    marg = {k: torch.tensor(s.tabular, device=dev)
            for k, s in (("l", src_l), ("u", src_u))}
    il = torch.arange(64, dtype=torch.int32, device=dev)
    iu = torch.arange(448, dtype=torch.int32, device=dev)
    streams = (
        HostStream(src_l, CyclingEpochView(CyclingSampler(len(src_l), 64,
                                                          seed=1), 8),
                   device=dev).epoch(),
        HostStream(src_u, EpochSampler(len(src_u), 448, drop_last=True,
                                       seed=0), device=dev).epoch())

    def one():
        bl, bu = next(streams[0]), next(streams[1])
        vl = {k: bl[k] for k in VIRTUAL_CACHE_KEYS if k in bl}
        vu = {k: bu[k] for k in VIRTUAL_CACHE_KEYS if k in bu}
        vl["marginal"], vu["marginal"] = marg["l"], marg["u"]
        step(state, vl, vu, il, iu, 1)

    caches = (DeviceCache(src_l, device=dev).as_dict(),
              DeviceCache(src_u, device=dev).as_dict())
    gen = torch.Generator().manual_seed(0)
    idx = (torch.randperm(len(src_l), generator=gen)[:64].to(dev),
           torch.randperm(len(src_u), generator=gen)[:448].to(dev))

    def cached():
        step(state, *caches, *idx, 1)

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    try:
        for _ in range(2):
            one()
            cached()
        torch.cuda.synchronize()
        host, cache_ms = [], []
        for _ in range(3):
            host.append(timed(one))
            cache_ms.append(timed(cached))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for s in streams:
            s.close()
    dev_time = lambda e: getattr(  # noqa: E731
        e, "device_time_total", getattr(e, "cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    busy = sum(dev_time(e) for e in events) / 1e3
    copies = sum(dev_time(e) for e in events if "Memcpy" in e.key) / 1e3
    host_ms = sorted(host)[1]
    log(f"[host-profile] a STiL step fed by the host streams: host clock "
        f"{host_ms:.3f} ms (median of {', '.join(f'{t:.3f}' for t in host)};"
        f" profiled {prof_ms:.3f} ms), fed by DeviceCache gathers in turns "
        f"{sorted(cache_ms)[1]:.3f} ms (median of "
        f"{', '.join(f'{t:.3f}' for t in cache_ms)}); device busy "
        f"{busy:.3f} ms, idle share {1 - busy / prof_ms:.1%} of the "
        f"profiled step; host-to-device copies {copies:.3f} ms on the "
        f"device")


def host_stream_phase(dev) -> dict:
    """Phase 19 (a): STiL trained from memmapped DVM-width splits through
    the host stream against the ``DeviceCache`` path, from the same
    files: launches, bitwise parameters (or the gap of two cache runs),
    steps/s, the consumer's waits, queue occupancy, the native gather's
    rate, the pinned pool, and a profiled host-stream step."""
    import numpy as np
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data import native_loader
    from stil_tta_torch.data.loader import GATHER_THREADS
    t0 = time.perf_counter()
    fl = load_config("config_dvm_STiL", ["dataset=synthetic_dvm"]
                     ).field_lengths
    sizes = write_host_splits(list(fl))
    log(f"[host] splits written in {time.perf_counter() - t0:.1f} s: "
        f"{HOST_UNLABELLED} unlabelled and {HOST_LABELLED} labelled rows of "
        f"{IMG}x{IMG}x3 uint8, {len(fl)} tabular fields; "
        f"{sum(sizes.values()) / 1e9:.3f} GB on disk {json.dumps(sizes)}")
    # the gather's g++ build before any timed epoch, as the CUDA kernels
    # are built before they are timed
    t0 = time.perf_counter()
    native_loader.load()
    log(f"[host] native gather loaded in {time.perf_counter() - t0:.2f} s")
    torch.backends.cudnn.deterministic = True
    try:
        # in turns, so that a drift of the host's speed falls on both paths
        order = [host_stream_run(False, "cache_a"),
                 host_stream_run(True, "host_a"),
                 host_stream_run(False, "cache_b"),
                 host_stream_run(True, "host_b")]
    finally:
        torch.backends.cudnn.deterministic = False
    runs = [order[0], order[2], order[1], order[3]]   # cache, cache, host, host

    def gap(a, b) -> tuple:
        """(tensors differing, largest |difference|) of two payloads."""
        ta, tb = a["tensors"], b["tensors"]
        if set(ta) != set(tb):
            raise SystemExit("host stream phase: checkpoints differ in keys")
        diff = [k for k in ta if not torch.equal(ta[k], tb[k])]
        worst = max((float((ta[k].double() - tb[k].double()).abs().max())
                     for k in diff if ta[k].is_floating_point()),
                    default=0.0)
        return len(diff), worst

    n_cc, cc = gap(runs[0], runs[1])
    log(f"[host] cache run against cache run: {n_cc} of "
        f"{len(runs[0]['tensors'])} tensors differ, largest |diff| {cc:.3e} "
        f"(the gate of the host runs: bitwise when the cache runs agree, "
        f"else within their gap)")
    for run in runs[2:]:
        n_ch, ch = gap(runs[0], run)
        log(f"[host] host stream against cache: {n_ch} differ, largest "
            f"{ch:.3e}")
        if (n_cc == 0 and n_ch) or ch > cc:
            raise SystemExit("host stream and DeviceCache training disagree")
    for tag, run in (("host_a", runs[2]), ("host_b", runs[3])):
        for s, name in zip(run["streams"], ("labelled", "unlabelled")):
            waits = np.asarray(s.waits_ms[:-1])   # the end marker left out
            slot = sum(a[:1].nbytes for a in s.arrays.values()) + 4
            rows = 64 if name == "labelled" else 448
            log(f"[host] {tag} {name} stream: {len(waits)} batches, "
                f"consumer wait first {waits[0]:.3f} ms, the rest summed "
                f"{waits[1:].sum():.3f} ms, median {np.median(waits):.3f} "
                f"ms, p90 {np.percentile(waits, 90):.3f} ms, max "
                f"{waits.max():.3f} ms; mean queue occupancy "
                f"{np.mean(s.occupancy[:-1]):.2f} of {s.depth}; native "
                f"gather {s.gather_bytes / 1e9:.3f} GB in "
                f"{s.gather_s * 1e3:.1f} ms = "
                f"{s.gather_bytes / max(s.gather_s, 1e-9) / 1e9:.2f} GB/s on "
                f"{GATHER_THREADS} threads a gather; pinned pool "
                f"{s.pool_size} buffers of {rows * slot / 2**20:.2f} MiB")
    log(f"[host] steps/s over the epoch (run order cache, host, cache, "
        f"host): DeviceCache {runs[0]['steps_per_s']:.3f} and "
        f"{runs[1]['steps_per_s']:.3f}, host stream "
        f"{runs[2]['steps_per_s']:.3f} and {runs[3]['steps_per_s']:.3f}; "
        f"host over cache in each turn "
        f"{runs[2]['steps_per_s'] / runs[0]['steps_per_s']:.3f} and "
        f"{runs[3]['steps_per_s'] / runs[1]['steps_per_s']:.3f}")
    launches = dict(zip(("bn_stats", "bn_bwd_reduce"), runs[3]["launches"]))
    del runs
    profile_host_stream_step(dev)
    shutil.rmtree(HOST_DATA, ignore_errors=True)
    return {"stil_host_stream_train": launches}


def zoo_step_profile(state, step, batch, timed: bool = True) -> dict:
    """One step on the host's clock (``timed``), then one under the
    profiler with CUDA activity alone (phase 8's profile, without its
    ranges, which a 12,000-kernel step makes slow to read): host clock,
    device busy (kernels), launches, ``bn_stats`` and ``bn_bwd_reduce``
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    host_ms = None
    if timed:
        t0 = time.perf_counter()
        step(state, *batch, 1)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *batch, 1)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    dev_time = lambda e: getattr(  # noqa: E731
        e, "device_time_total", getattr(e, "cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    count = lambda tag: sum(e.count for e in events  # noqa: E731
                            if tag in e.key)
    return {"host_ms": host_ms, "profiled_host_ms": prof_ms,
            "busy_ms": sum(dev_time(e) for e in events) / 1e3,
            "kernel_launches": sum(e.count for e in events),
            "bn_stats_kernels": count("bn_stats_kernel"),
            "bn_bwd_reduce_kernels": count("bn_bwd_reduce_kernel")}


def zoo_phase(dev) -> dict:
    """Phase 19 (b): each ResNet of the zoo at the DVM widths: one
    bfloat16 STiL step at batch 512 with its launches (the net's BN
    count of each kernel), then a profiled step whose BN kernels must
    number as many, for ZOO_TIMED after a step on the host's clock (host
    clock, device busy, peak memory), then phase 7's float32 step
    with the kernels against the plain pair; the BN kernels at every (M, C)
    the zoo adds to phase 3's list; each ViT's two STiL steps (no BN
    kernel) and ``Predictor`` at 512. Every net's float32 step fits at
    batch 512 on the 80 GB card."""
    import numpy as np
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.ops.batch_norm import (bn_bwd_reduce,
                                               bn_bwd_reduce_plain, bn_stats,
                                               bn_stats_plain)
    from stil_tta_torch.serve import Predictor
    from stil_tta_torch.train.optim import set_learning_rate
    gen = torch.Generator(device=dev).manual_seed(19)
    base = set(resnet50_bn_shapes(dev)) | set(
        resnet50_bn_shapes(dev, CARDIAC_BATCH))
    new = sorted({s for n, _ in ZOO_RESNETS for s in zoo_bn_shapes(n)}
                 - base)
    for dtype in (torch.bfloat16, torch.float32):
        for m, c in new:
            x = (torch.randn(m, c, generator=gen, device=dev)
                 + 0.5).to(dtype)
            dy = torch.randn(m, c, generator=gen, device=dev).to(dtype)
            s, ss = bn_stats(x)
            ps, pss = bn_stats_plain(x)
            mean = torch.rand(c, generator=gen, device=dev)
            inv = torch.rand(c, generator=gen, device=dev) + 0.5
            g, gx = bn_bwd_reduce(x, dy, mean, inv)
            pg, pgx = bn_bwd_reduce_plain(x, dy, mean, inv)
            xhat = (x.float() - mean) * inv
            rel = max(
                float(((s - ps).abs() / x.float().abs().sum(0)).max()),
                float(((ss - pss).abs() / pss).max()),
                float(((g - pg).abs() / dy.float().abs().sum(0)).max()),
                float(((gx - pgx).abs()
                       / (dy.float() * xhat).abs().sum(0)).max()))
            log(f"[zoo-kernel] {str(dtype)[6:]:8s} M={m:>9,d} C={c:>5d} "
                f"both kernels vs plain, max rel err {rel:.2e} (tol {TOL:.0e})")
            if rel >= TOL:
                raise SystemExit(f"a BN kernel disagrees at the zoo's "
                                 f"{(m, c, dtype)}")
            del x, dy, xhat
    by_path = {}
    for name, n_bn in ZOO_RESNETS:
        t0 = time.perf_counter()
        cfg = load_config("config_dvm_STiL", TRAIN_OVERRIDES + [
            f"model={name}"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        algo, step, batch = step_setup(cfg, dev)
        state = algo.init_state(0)
        set_learning_rate(state.optimizer, STEP_LR)
        bn_stats.launches = bn_bwd_reduce.launches = 0
        step(state, *batch, 1)
        torch.cuda.synchronize()
        launches = (bn_stats.launches, bn_bwd_reduce.launches)
        log(f"[zoo] {name}: launches a step (bn_stats, bn_bwd_reduce) "
            f"{launches} (expected {(n_bn, n_bn)})")
        if launches != (n_bn, n_bn):
            raise SystemExit(f"{name}: BN kernel launches off the path")
        prof = zoo_step_profile(state, step, batch, name in ZOO_TIMED)
        profiled = (prof["bn_stats_kernels"], prof["bn_bwd_reduce_kernels"])
        if name in ZOO_TIMED:
            peak = torch.cuda.max_memory_allocated()
            log(f"[zoo] {name}: bf16 step at batch {BATCH}: host "
                f"{prof['host_ms']:.3f} ms (profiled "
                f"{prof['profiled_host_ms']:.3f} ms), device busy "
                f"{prof['busy_ms']:.3f} ms, idle share "
                f"{1 - prof['busy_ms'] / prof['host_ms']:.1%}, "
                f"{prof['kernel_launches']} kernel launches; "
                f"peak memory {peak / 2**30:.3f} GiB")
        log(f"[zoo] {name}: profiled step's (bn_stats, bn_bwd_reduce) "
            f"kernels {profiled} (expected {(n_bn, n_bn)})")
        if profiled != (n_bn, n_bn):
            raise SystemExit(f"{name}: BN kernel launches off the path")
        by_path[f"zoo_{name}_step"] = dict(zip(("bn_stats", "bn_bwd_reduce"),
                                               launches))
        del algo, step, batch, state
        torch.cuda.empty_cache()
        train_step_kernel_vs_plain(cfg, dev, per_step=n_bn)
        log(f"[zoo] {name}: {time.perf_counter() - t0:.1f} s")
    for name in ZOO_VITS:
        t0 = time.perf_counter()
        cfg = load_config("config_dvm_STiL", TRAIN_OVERRIDES + [
            f"model={name}"])
        algo, step, batch = step_setup(cfg, dev)
        state = algo.init_state(0)
        bn_stats.launches = bn_bwd_reduce.launches = 0
        host = []
        for _ in range(2):
            t1 = time.perf_counter()
            step(state, *batch, 1)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t1) * 1e3)
        launches = (bn_stats.launches, bn_bwd_reduce.launches)
        loss = float(state.log_sums["loss"])
        src = load_sources(cfg)["test"]
        imgs, tabs = np.asarray(src.images), np.asarray(src.tabular)
        pred = Predictor(algo, batch_size=BATCH)
        pred(imgs[:BATCH], tabs[:BATCH])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probs = pred(imgs, tabs)
        sps = len(imgs) / (time.perf_counter() - t1)
        log(f"[zoo] {name}: two bf16 STiL steps at batch {BATCH}, host "
            f"{host[0]:.1f} and {host[1]:.1f} ms, loss sum {loss:.4f}, BN "
            f"kernel launches {launches}; Predictor at {BATCH}: "
            f"{sps:.1f} samples/s over {len(imgs)} rows "
            f"({time.perf_counter() - t0:.1f} s)")
        if launches != (0, 0) or not math.isfinite(loss) \
                or not np.isfinite(probs).all() \
                or np.abs(probs.sum(1) - 1).max() > 1e-3:
            raise SystemExit(f"{name}: BN kernels launched or bad outputs")
        del algo, step, batch, state, pred
    return by_path


def grouped_int8_phase(dev) -> dict:
    """Phase 19 (c): the grouped int8 convolution bitwise equal to its
    plain route at every grouped shape of ResNeXt-50 and -101 at batch
    512, timed against bf16 cuDNN at ResNeXt-50's; ``Predictor(int8=True)``
    and one ``teacher_int8`` step on ResNeXt-50."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.ops import quant_conv as qc
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    from stil_tta_torch.serve import Predictor
    from stil_tta_torch.train.optim import set_learning_rate
    gen = torch.Generator(device=dev).manual_seed(191)
    buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    t0 = time.perf_counter()
    for name in ("resnext50_32x4d", "resnext101_32x8d"):
        for shape in sorted(set(grouped_conv_shapes(name))):
            b, cin, h, w, cout, k, s, p, g = shape
            x = torch.randn(b, cin, h, w, generator=gen, device=dev).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            wt = torch.randn(cout, cin // g, k, k, generator=gen,
                             device=dev) * math.sqrt(2.0 / (cout * k * k))
            x_q, w_q, _, _ = qc.quantize(x, wt)
            y = qc.int8_conv_card(x_q, w_q, s, p, g)
            ok = torch.equal(y, qc.int8_conv_plain(x_q, w_q, s, p, g))
            got = qc.quant_conv2d(x, wt, s, p, torch.bfloat16, g)
            ok = ok and torch.equal(got, qc.quant_conv2d(
                x, wt, s, p, torch.bfloat16, g)) and torch.equal(
                got, qc.quant_conv2d_plain(x, wt, s, p, torch.bfloat16, g))
            line = (f"[int8-grouped] {name} x{tuple(x.shape)} w"
                    f"{tuple(wt.shape)} s{s} g{g}: bitwise {ok}")
            if name == "resnext50_32x4d":
                wb = wt.to(torch.bfloat16)
                t_int8 = time_ms(lambda a: qc.quant_conv2d(
                    a, wt, s, p, torch.bfloat16, g), x, buf, reps=10)
                t_bf16 = time_ms(lambda a: torch.nn.functional.conv2d(
                    a, wb, stride=s, padding=p, groups=g), x, buf, reps=10)
                line += (f"; int8 route {t_int8:.4f} ms ({g} _int_mm), "
                         f"bf16 cuDNN {t_bf16:.4f} ms")
            log(line)
            if not ok:
                raise SystemExit(f"grouped int8 conv disagrees at {shape}")
            del x, wt, x_q, w_q, y, got
    del buf
    log(f"[int8-grouped] shapes checked in {time.perf_counter() - t0:.1f} s")
    # Predictor(int8=True) on ResNeXt-50 beside the bf16 one
    cfg = load_config("config_dvm_STiL", TEST_OVERRIDES + [
        "model=resnext50_32x4d"])
    src = load_sources(cfg)["test"]
    algo = STiL(cfg, src.field_lengths, device=dev)
    algo.init_state(0)
    imgs, tabs = np.asarray(src.images), np.asarray(src.tabular)
    out = {}
    for q in (False, True):
        pred = Predictor(algo, batch_size=BATCH, int8=q)
        pred(imgs[:BATCH], tabs[:BATCH])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out[q] = pred(imgs, tabs)
        out[(q, "sps")] = len(imgs) / (time.perf_counter() - t1)
    # one int8 serving batch under the profiler: every conv of the tower
    # an integer GEMM, each group its own
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred(imgs[:BATCH], tabs[:BATCH])
        torch.cuda.synchronize()
    serve_int_mm = sum(e.count for e in prof.key_averages()
                       if e.key == "aten::_int_mm")
    agree = float((out[True].argmax(1) == out[False].argmax(1)).mean())
    log(f"[int8-grouped] ResNeXt-50 Predictor at {BATCH} over {len(imgs)} "
        f"rows: int8 {out[(True, 'sps')]:.1f} samples/s, bf16 "
        f"{out[(False, 'sps')]:.1f}; argmax agreement {agree:.4f} (bound "
        f"{INT8_SERVE_AGREE}), largest probability difference "
        f"{float(np.abs(out[True] - out[False]).max()):.3e}; one int8 "
        f"serving batch: {serve_int_mm} aten::_int_mm calls (expected "
        f"{RESNEXT50_INT_MM})")
    if not np.isfinite(out[True]).all() \
            or np.abs(out[True].sum(1) - 1).max() > 1e-3 \
            or serve_int_mm != RESNEXT50_INT_MM or agree <= INT8_SERVE_AGREE:
        raise SystemExit("ResNeXt-50 int8 serving: bad probabilities, an "
                         "argmax agreement at or under the bound, or its "
                         "convs not the integer GEMMs")
    images = torch.as_tensor(imgs[:BATCH], device=dev)
    tabular = torch.as_tensor(np.asarray(tabs[:BATCH], np.float32),
                              device=dev)
    int8_forward_phase(algo, images, tabular, RESNEXT50_INT_MM)
    del algo, pred, images, tabular
    # one teacher_int8 step on ResNeXt-50, its teacher's GEMMs counted
    cfg = load_config("config_dvm_STiL", TRAIN_OVERRIDES + [
        "model=resnext50_32x4d", "teacher_int8=true"])
    algo, step, batch = step_setup(cfg, dev)
    state = algo.init_state(0)
    set_learning_rate(state.optimizer, STEP_LR)
    step(state, *batch, 1)
    torch.cuda.synchronize()
    bn_stats.launches = bn_bwd_reduce.launches = 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t1 = time.perf_counter()
        step(state, *batch, 1)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t1) * 1e3
    int_mm = sum(e.count for e in prof.key_averages()
                 if e.key == "aten::_int_mm")
    launches = (bn_stats.launches, bn_bwd_reduce.launches)
    loss = float(state.log_sums["loss"])
    log(f"[int8-grouped] ResNeXt-50 teacher_int8 step: {int_mm} "
        f"aten::_int_mm calls (expected {RESNEXT50_INT_MM}: 37 convs and "
        f"16 x 32 groups), BN launches {launches} (expected (53, 53)), "
        f"host {host:.1f} ms (profiled), loss sum {loss:.4f}")
    if int_mm != RESNEXT50_INT_MM or launches != (53, 53) \
            or not math.isfinite(loss):
        raise SystemExit("ResNeXt-50 teacher_int8 step off the path")
    del algo, step, batch, state
    return {"resnext50_int8_teacher_step": dict(
        zip(("bn_stats", "bn_bwd_reduce"), launches))}


def adapt_kernel_vs_plain(cfg, algo, cache: dict, init_state: dict,
                          tag: str) -> None:
    """BN-adapt of ``algo.net`` from ``init_state`` on ``cache`` with the
    ``bn_stats`` kernel and with the plain statistics side by side
    (phases 4 and 20): the adapted running statistics and one eval
    batch's probabilities, held to phase 4's tolerance."""
    from stil_tta_torch.ops.batch_norm import bn_stats, bn_stats_plain
    from stil_tta_torch.tta import adapt
    dev = cache["labels"].device
    stats_batches = math.ceil(int(cache["labels"].shape[0])
                              / int(cfg.batch_size))
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
        runs[name] = (bufs, prob)
        log(f"[{tag}] adapt with {name} statistics: {t_adapt * 1e3:.1f} ms "
            f"({stats_batches} batches), eval batch {t_eval * 1e3:.1f} ms")
    kb, kp = runs["kernel"]
    pb, pp = runs["plain"]
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
    log(f"[{tag}] adapted running stats, kernel vs plain ({len(kb)} "
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


# ---- phase 20: the offline data prep and the shift workflow ---------------

SHIFT_ROWS = 8192           # 128² x 3 uint8 rows, 0.4 GB on the host
SHIFT_FIELDS = [5, 4, 2] + [1] * 14   # synthetic_dvm.yaml's field lengths
SHIFT_CLASSES = 286
SHIFT_DATA = Path("runs/chip_smoke_shift_data")
SHIFT_FRACTION = "0.1"
# the stand-ins for the DVM table's columns: categorical column 0 (five
# values, named as colours) for Color, and the continuous columns at the
# reference layout's Adv_year (8) and Runned_Miles (11) positions
COLOURS = {0: "blue", 1: "silver", 2: "white", 3: "black", 4: "grey"}
YEAR_COL, MILES_COL = 8, 11
# the dataprep CLI's arguments for each shift of the sweep, in its order.
# b-s-b-g-w holds out four colours, not five: column 0 has five values at
# these widths, and all five would leave no train pool
SHIFT_ARGS = {
    "normal": ["--shift", "normal"],
    "black": ["--shift", "column", "--column", "0", "--values", "3"],
    "b-s-g": ["--shift", "column", "--column", "0", "--values", "0", "1",
              "4"],
    "b-s-b-g-w": ["--shift", "column", "--column", "0", "--values", "0",
                  "1", "3", "4"],
    "miles": ["--shift", "quantile", "--column", str(MILES_COL),
              "--quantile", "0.8"],
    "adv_year": ["--shift", "quantile", "--column", str(YEAR_COL),
                 "--quantile", "0.8"],
    "labels": ["--shift", "labels", "--column", "0", "--labeled-values",
               "3", "--unlabeled-values", "2", "4"],
}
# the TTA demo's base training, cut from its 30 epochs to fit the phase
DEMO_EPOCHS = 2
DEMO_STEPS_PER_EPOCH = 2048 // 32   # --n-train over the labelled batch
DEMO_STATS_BATCHES = 512 // 64      # --n-test over --batch-size
RESNET18_BN = 20


def _same_tree(a: Path, b: Path) -> bool:
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    return bool(fa) and fa == fb and all(
        (a / r).read_bytes() == (b / r).read_bytes() for r in fa)


def shift_splits_phase() -> dict:
    """Phase 20 (a): the DVM-width source from the seed, then the port's
    dataprep CLI in one subprocess for each shift of the sweep (and
    ``black`` once more), all started together; returns each shift's
    ``shift_report.json``."""
    from stil_tta_torch.data.source import synthetic_source
    shutil.rmtree(SHIFT_DATA, ignore_errors=True)
    t0 = time.perf_counter()
    synthetic_source(SHIFT_ROWS, num_classes=SHIFT_CLASSES,
                     field_lengths=SHIFT_FIELDS, image_size=IMG,
                     seed=20).save(SHIFT_DATA / "all")
    log(f"[shift] source: {SHIFT_ROWS} rows of {IMG}² x 3 uint8, fields "
        f"{SHIFT_FIELDS}, {SHIFT_CLASSES} classes, written in "
        f"{time.perf_counter() - t0:.1f} s; stand-ins: colour = column 0 "
        f"{COLOURS}, adv_year = column {YEAR_COL}, miles = column "
        f"{MILES_COL}; b-s-b-g-w holds out four colours (column 0 has five "
        f"values)")
    jobs = dict(SHIFT_ARGS, black_repeat=SHIFT_ARGS["black"])
    t0 = time.perf_counter()
    procs = {tag: subprocess.Popen(
        [sys.executable, "-m", "stil_tta_torch.dataprep.shifted",
         "--source", str(SHIFT_DATA / "all"),
         "--name", tag.replace("_repeat", ""),
         "--label-fraction", SHIFT_FRACTION, "--out", str(SHIFT_DATA / tag),
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag, args in jobs.items()}
    failed = []
    for tag, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            log(stderr[-4000:])
            failed.append(tag)
    log(f"[shift] {len(procs)} dataprep subprocesses in "
        f"{time.perf_counter() - t0:.1f} s")
    if failed:
        raise SystemExit(f"shifted splits: the dataprep CLI failed: {failed}")
    reports = {}
    for shift in SHIFT_ARGS:
        rep = json.loads((SHIFT_DATA / shift / "shift_report.json")
                         .read_text())
        reports[shift] = rep
        log(f"[shift] {shift}: {rep['description']}; sizes "
            f"{json.dumps(rep['sizes'])}; {rep['num_classes']} classes; "
            f"JS divergence {json.dumps(rep['js_divergence'])}")
    repeat = _same_tree(SHIFT_DATA / "black", SHIFT_DATA / "black_repeat")
    log(f"[shift] black built twice: byte-equal files {repeat}")
    if not repeat:
        raise SystemExit("shifted splits: one shift built twice differs")
    shutil.rmtree(SHIFT_DATA / "black_repeat")
    return reports


def shift_overrides(shift: str) -> list:
    """The shift sweep's flags for ``shift`` (``run_dist_shifts_torch.sh``'s
    own and the split directories; ``data_val`` is read by the loader and
    not by the test entry point)."""
    d = SHIFT_DATA / shift
    return [f"dataset=dvm_all_server_reordered_SemiPseudo_{SHIFT_FRACTION}_"
            f"{shift}", "test=True", "evaluate=False",
            f"data_base={d}", f"data_val={d / 'test'}",
            "enable_progress_bar=false"]


@contextlib.contextmanager
def recording_adapt(record: dict):
    """Within the block, ``tta.adapt`` (which ``test()`` calls and whose
    counts it drops) writes into ``record`` the counts it returns and the
    largest change of a BatchNorm weight or bias over the call."""
    from stil_tta_torch import tta
    from stil_tta_torch.tta.tent import bn_parameters
    inner = tta.adapt

    def adapt(cfg, algo, cache, *args, **kwargs):
        params = [p for _, p in bn_parameters(algo.net)]
        before = [p.detach().float().clone() for p in params]
        record["counts"] = inner(cfg, algo, cache, *args, **kwargs)
        record["moved"] = max(float((p.detach().float() - b).abs().max())
                              for p, b in zip(params, before))
        return record["counts"]

    tta.adapt = adapt
    try:
        yield record
    finally:
        tta.adapt = inner


def shift_sweep_phase(reports: dict) -> dict:
    """Phase 20 (b): ``train.test.test`` with BN-adapt for each shift at
    full width (ResNet-50 at 128², the 4-layer tabular transformer at
    d=512, batch 512, seeded random weights), and Tent on ``black``;
    returns the launches of each. Each run is also held to what ``adapt``
    says it ran: BN-adapt one stats sweep and no affine change, Tent its
    entropy steps and a moved BN affine parameter."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    from stil_tta_torch.train.test import test
    from stil_tta_torch.tta.tent import knob
    torch.cuda.reset_peak_memory_stats()
    by_path = {}
    runs = [(s, "bn_adapt") for s in SHIFT_ARGS] + [("black", "tent")]
    for shift, strategy in runs:
        cfg = load_config("config_dvm_STiL", shift_overrides(shift) + [
            "tta=True", f"tta_strategy={strategy}",
            f"logdir=runs/chip_smoke_shift_{shift}_{strategy}"])
        n_test = reports[shift]["sizes"]["test"]
        batches = math.ceil(n_test / int(cfg.batch_size))
        expected = {"stats_batches": batches}
        if strategy == "tent":
            expected["steps"] = batches * int(knob(cfg.tta_steps, 1))
        torch.cuda.synchronize()
        bn_stats.launches = bn_bwd_reduce.launches = 0
        t0 = time.perf_counter()
        with recording_adapt({}) as adapted:
            metrics = test(cfg.copy(), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"bn_stats": bn_stats.launches,
                    "bn_bwd_reduce": bn_bwd_reduce.launches}
        results = Path(cfg.logdir) / "test_results.csv"
        log(f"[shift] {shift} {strategy}: {cfg.model} {cfg.img_size}² "
            f"tabular {cfg.tabular_transformer_num_layers}x"
            f"{cfg.tabular_embedding_dim} batch {cfg.batch_size}, "
            f"{n_test} test rows, YAML classes {cfg.num_classes} (split "
            f"{reports[shift]['num_classes']}); test() {wall:.3f} s; "
            f"launches {json.dumps(launches)} (bn_stats 53 x {batches}); "
            f"adapt ran {json.dumps(adapted.get('counts'))} (expected "
            f"{json.dumps(expected)}), largest BN affine change "
            f"{adapted.get('moved', float('nan')):.3e}; "
            f"metrics {json.dumps(metrics)}; results file {results.exists()}")
        # Tent's entropy steps run the net in eval mode (the JAX package's
        # train=False forward): BatchNorm reads its running statistics and
        # neither kernel runs there, so the launches alone cannot tell
        # Tent from BN-adapt; adapt's counts and the affine change can
        if launches != {"bn_stats": 53 * batches, "bn_bwd_reduce": 0}:
            raise SystemExit(f"shift {shift} {strategy}: launches off the "
                             "path")
        moved = adapted.get("moved", float("nan"))
        if adapted.get("counts") != expected or not (
                moved > 0 if strategy == "tent" else moved == 0):
            raise SystemExit(f"shift {shift} {strategy}: adapt ran "
                             f"{adapted.get('counts')} and moved the BN "
                             f"affine parameters by {moved}; expected "
                             f"{expected}")
        if not results.exists() or not all(
                math.isfinite(v) and 0.0 <= v <= 1.0
                for v in metrics.values()):
            raise SystemExit(f"shift {shift} {strategy}: bad test metrics "
                             f"{metrics}")
        shutil.rmtree(cfg.logdir, ignore_errors=True)
        by_path[f"shift_{shift}_{strategy}"] = launches
    log(f"[shift] peak memory over the sweep "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return by_path


def script_commands(script, *extra: str, env: dict = None) -> list:
    """The ``python`` command lines that the shell script ``script`` runs
    with ``extra`` as its arguments, read through a stub ``python`` first
    on ``PATH`` that records its arguments. The sweep script's
    ``FRACTION``, ``CONFIG`` and ``CHECKPOINT`` are unset unless ``env``
    sets them. Phase 20 (c) and the sweep script's CPU test read it."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        stub, record = Path(tmp) / "python", Path(tmp) / "argv"
        stub.write_text("#!/bin/sh\nprintf '%s\\037' \"$@\" >> \"$STUB_LOG\"\n"
                        "echo >> \"$STUB_LOG\"\n")
        stub.chmod(0o755)
        run_env = {k: v for k, v in os.environ.items()
                   if k not in ("FRACTION", "CONFIG", "CHECKPOINT")}
        run_env.update(env or {}, STUB_LOG=str(record),
                       PATH=f"{tmp}{os.pathsep}{os.environ['PATH']}")
        subprocess.run(["bash", str(script), *extra], env=run_env,
                       check=True, capture_output=True)
        return [line.split("\x1f")[:-1]
                for line in record.read_text().splitlines()]


def sweep_command(shift: str, *extra: str) -> list:
    """The ``python`` command line ``run_dist_shifts_torch.sh`` builds for
    ``shift`` with ``extra`` as its arguments."""
    [cmd] = [c for c in script_commands("run_dist_shifts_torch.sh", *extra)
             if any(a.endswith(f"_{shift}") for a in c)]
    return cmd


def shift_cli_phase() -> None:
    """Phase 20 (c): BN-adapt on ``black`` with the kernel's statistics
    against the plain ones (phase 4's check), then the ``normal`` shift
    as one subprocess of the sweep script's command."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.train.test import build_algo, load_test_split
    cfg = load_config("config_dvm_STiL", shift_overrides("black") + [
        "tta=True", "tta_strategy=bn_adapt"])
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, "cuda")
    cache = DeviceCache(src, device="cuda").as_dict()
    adapt_kernel_vs_plain(cfg, algo, cache,
                          copy.deepcopy(algo.net.state_dict()), "shift black")
    del algo, cache, src

    d = SHIFT_DATA / "normal"
    cmd = sweep_command("normal", f"data_base={d}", f"data_val={d / 'test'}")
    log(f"[shift] run_dist_shifts_torch.sh's command for normal: "
        f"python {' '.join(cmd)}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *cmd], capture_output=True,
                          text=True, timeout=900)
    logdir = Path(next(a for a in cmd if a.startswith("logdir="))[7:])
    results = logdir / "test_results.csv"
    log(f"[shift] the sweep script's normal command: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{proc.stdout.strip().splitlines()[-1][:600] if proc.stdout else ''}"
        f"; results file {results.exists()}")
    if proc.returncode != 0 or not results.exists():
        log(proc.stderr[-4000:])
        raise SystemExit("the sweep script's command failed")
    shutil.rmtree(logdir, ignore_errors=True)


def tta_demo_phase() -> dict:
    """Phase 20 (d): the TTA demo (``stil_tta_torch.tools.tta_demo``) at
    its own widths (ResNet-18, 64², 8 classes) with DEMO_EPOCHS of base
    training; returns its launches."""
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    from stil_tta_torch.tools import tta_demo
    root = Path("runs/chip_smoke_tta_demo")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    bn_stats.launches = bn_bwd_reduce.launches = 0
    t0 = time.perf_counter()
    rc = tta_demo.main(["--root", str(root), "--epochs", str(DEMO_EPOCHS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"bn_stats": bn_stats.launches,
                "bn_bwd_reduce": bn_bwd_reduce.launches}
    steps = DEMO_EPOCHS * DEMO_STEPS_PER_EPOCH
    stats = len(tta_demo.STRATEGIES) * DEMO_STATS_BATCHES
    expected = {"bn_stats": RESNET18_BN * (steps + stats),
                "bn_bwd_reduce": RESNET18_BN * steps}
    out = json.loads((root / "tta_demo.json").read_text())
    log(f"[demo] tta_demo --epochs {DEMO_EPOCHS} (cut from 30 to fit the "
        f"script's time): exit {rc} in {wall:.1f} s; accuracy clean "
        f"{out['clean']}, shifted {out['shift_no_tta']}, "
        + ", ".join(f"{s} {out[f'shift_{s}']} (recovered "
                    f"{out[f'recovered_{s}']:+})"
                    for s in tta_demo.STRATEGIES)
        + f"; launches {json.dumps(launches)} (ResNet-18's 20 BatchNorms: "
        f"{steps} train steps, {stats} BN-adapt batches: "
        f"{json.dumps(expected)})")
    if rc != 0 or not all(math.isfinite(v) for v in out.values()):
        raise SystemExit(f"tta demo: bad accuracies {out}")
    if launches != expected:
        raise SystemExit("tta demo: launches off the path")
    shutil.rmtree(root, ignore_errors=True)
    return {"tta_demo": launches}


# ---- phase 21: steps_per_dispatch, one captured step replayed ------------

DISPATCH_K = 8        # (a): the steps of each compared dispatch
PROFILED_K = 4        # (b), (d): the replays of the profiled dispatch
TIMING_K = 32         # (d): the YAMLs' steps_per_dispatch
TIMED_K = 16          # (d): the steps of each timed STiL dispatch
ROUTE_K = 8           # (d): FreeMatch's graphed dispatch
EAGER_K = 2           # (d): teacher_int8's eager dispatch
SPD_EVAL = 3          # (c): 8 steps an epoch, two blocks and a tail of 2
SMALL_K = 3           # (e): the steps of each compared dispatch
FULL_K = 4            # (f): the steps of each timed dispatch
PROFILED_F = 2        # (f): the steps of each profiled dispatch


def _dispatch_rows(caches, block) -> list:
    """The rows of a dispatch from an (il (K, 64), iu (K, 448)) block of
    host indices: copied to the card once, one view a step."""
    il, iu = (torch.from_numpy(b).to(caches[0]["labels"].device)
              for b in block)
    return [(*caches, il[i], iu[i]) for i in range(il.shape[0])]


def _epoch_pairs(n_l: int, n_u: int, epoch: int, seed: int = 0) -> list:
    """The (idx_l, idx_u) of an epoch as ``evaluate`` draws them."""
    from stil_tta_torch.data.loader import CyclingSampler, EpochSampler
    u = EpochSampler(n_u, BATCH - 64, shuffle=True, drop_last=True,
                     seed=seed + 100003 * epoch)
    lab = CyclingSampler(n_l, 64, seed=seed + 100003 * epoch + 1)
    return [(lab.next()[0], idx_u) for idx_u, _ in u.epoch()]


def _block(pairs: list, k: int, start: int = 0):
    """k pairs of ``pairs`` from ``start`` (cycled) as one (K, B) block."""
    import numpy as np
    rows = [pairs[(start + i) % len(pairs)] for i in range(k)]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]))


def _compare_states(a: dict, b: dict) -> dict:
    """Two snapshots of named tensors: the count of bitwise equal ones,
    the largest relative L2 difference of a float one, the integer ones
    that differ."""
    equal, rel, ints = 0, 0.0, []
    for k, t in a.items():
        u = b[k]
        if torch.equal(t, u):
            equal += 1
        elif t.is_floating_point():
            d = (t.double() - u.double()).norm()
            rel = max(rel, float(d / u.double().norm().clamp_min(1e-30)))
        else:
            ints.append(k)
    return {"bitwise": equal, "tensors": len(a), "rel_l2": rel,
            "ints_off": ints, "same_names": set(a) == set(b)}


def _snapshot(state) -> dict:
    from stil_tta_torch.train.multistep import state_tensors
    return {k: t.detach().clone() for k, t in state_tensors(state).items()}


def _profiled_dispatch(dispatch, state, rows, cpu_ops: bool = True) -> dict:
    """One dispatch under the profiler: kernels on the card, the BN
    kernels among them, device busy, graph launches and the host's launch
    calls (the runtime's kernel and graph launches, copies and fills).
    ``cpu_ops=False`` records no operator events: an eager dispatch's
    profile is then read much faster, with the same kernels and runtime
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu_ops
                                      else [])
    with profile(activities=acts) as prof:
        dispatch(state, rows, 1)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    runtime = [e for e in events if e.key.startswith("cuda")]
    count = lambda es, tag: sum(e.count for e in es  # noqa: E731
                                if tag in e.key)
    return {"kernels": sum(e.count for e in kernels),
            "bn": (count(kernels, "bn_stats_kernel"),
                   count(kernels, "bn_bwd_reduce_kernel")),
            "busy_ms": sum(getattr(e, "device_time_total",
                                   getattr(e, "cuda_time_total", 0))
                           for e in kernels) / 1e3,
            "graph_launches": count(runtime, "cudaGraphLaunch"),
            "calls": sum(e.count for e in runtime if any(
                w in e.key for w in ("Launch", "Memcpy", "Memset")))}


def full_width_data(dev) -> dict:
    """Phase 6's splits on the card (``caches``), their field lengths and
    the (idx_l, idx_u) pairs of epoch 2 as ``evaluate`` draws them."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.data.loader import DeviceCache
    src = load_sources(load_config("config_dvm_STiL", TRAIN_OVERRIDES))
    n_l, n_u = len(src["train_labelled"]), len(src["train_unlabelled"])
    return {"caches": [DeviceCache(src[k], device=dev).as_dict()
                       for k in ("train_labelled", "train_unlabelled")],
            "field_lengths": src["train_labelled"].field_lengths,
            "pairs": _epoch_pairs(n_l, n_u, 2)}


def dispatch_equality(dev, smi: str) -> dict:
    """Phase 21 (a), (b): two bfloat16 STiL states from one seed at full
    width; one runs two dispatches of DISPATCH_K eager steps (epoch 0,
    then 1: the pseudo-label gate turns on), the other the same two
    dispatches as replays of one captured step (its first step eager: the
    warm-up). Every state tensor must be bitwise equal after each
    dispatch. Then a graphed dispatch of PROFILED_K under the profiler:
    53 ``bn_stats`` and 53 ``bn_bwd_reduce`` kernels a replayed step, the
    Python counters in agreement, one graph launch a step."""
    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.config import load_config
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    from stil_tta_torch.train.multistep import EagerSteps, GraphedStep
    cfg = load_config("config_dvm_STiL", TRAIN_OVERRIDES)
    data = full_width_data(dev)
    fl, caches = data["field_lengths"], data["caches"]
    n_l, n_u = (int(c["labels"].shape[0]) for c in caches)
    blocks = [_block(_epoch_pairs(n_l, n_u, e), DISPATCH_K) for e in (0, 1)]
    runs = {}
    for route in ("eager", "graph"):
        algo = STiL(cfg, fl, device=dev)
        torch.manual_seed(0)    # the dropout's generator, for both runs
        state = algo.init_state(0)
        step = algo.make_train_step()
        dispatch = (GraphedStep(algo, step) if route == "graph"
                    else EagerSteps(step))
        snaps, launches = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch, block in enumerate(blocks):
            bn_stats.launches = bn_bwd_reduce.launches = 0
            dispatch(state, _dispatch_rows(caches, block), epoch)
            torch.cuda.synchronize()
            launches.append((bn_stats.launches, bn_bwd_reduce.launches))
            snaps.append(_snapshot(state))
        runs[route] = {"algo": algo, "state": state, "dispatch": dispatch,
                       "snaps": snaps, "launches": launches,
                       "wall": time.perf_counter() - t0}
    e, g = runs["eager"], runs["graph"]
    cmp = [_compare_states(a, b) for a, b in zip(e.pop("snaps"),
                                                 g.pop("snaps"))]
    want = [(53 * DISPATCH_K,) * 2] * 2
    d = g["dispatch"]
    for i, c in enumerate(cmp):
        log(f"[dispatch] (a) bf16, dispatch {i + 1} (epoch {i}) of "
            f"{DISPATCH_K} steps, eager against graphed: {c['bitwise']} of "
            f"{c['tensors']} state tensors bitwise equal (nets, EMA "
            f"teacher, Adam, prototypes, DA ring and position, metrics), "
            f"largest float relative L2 {c['rel_l2']:.3e}, integer tensors "
            f"off {c['ints_off']}")
    log(f"[dispatch] (a) launches (bn_stats, bn_bwd_reduce) by dispatch: "
        f"eager {e['launches']}, graphed {g['launches']} (expected {want}); "
        f"captured step {d.launches_per_replay}; capture {d.capture_s:.2f} s,"
        f" graph pool {d.pool_bytes / 2**30:.3f} GiB; wall eager "
        f"{e['wall']:.2f} s, graphed {g['wall']:.2f} s (the warm-up step and "
        f"the capture included); {smi}")
    if not all(c["same_names"] and c["bitwise"] == c["tensors"]
               for c in cmp) or e["launches"] != want \
            or g["launches"] != want:
        raise SystemExit("dispatch: the graphed dispatch differs from the "
                         "eager steps, or a kernel's launches are off")
    if not torch.equal(e["state"].generator.get_state(),
                       g["state"].generator.get_state()) \
            or not e["state"].step == g["state"].step == 2 * DISPATCH_K:
        raise SystemExit("dispatch: generator or step count differs")
    # (b) a replayed dispatch under the profiler
    pairs = data["pairs"]
    bn_stats.launches = bn_bwd_reduce.launches = 0
    prof = _profiled_dispatch(d, g["state"], _dispatch_rows(
        caches, _block(pairs, PROFILED_K)))
    counters = (bn_stats.launches, bn_bwd_reduce.launches)
    log(f"[dispatch] (b) one graphed dispatch of {PROFILED_K} replays "
        f"profiled: (bn_stats, bn_bwd_reduce) kernels {prof['bn']}, "
        f"{prof['bn'][0] / PROFILED_K:.1f} and "
        f"{prof['bn'][1] / PROFILED_K:.1f} a step (53 expected); Python "
        f"counters {counters}; {prof['graph_launches']} graph launches; "
        f"{prof['calls']} host launch calls "
        f"({prof['calls'] / PROFILED_K:.2f} a step); {prof['kernels']} "
        f"kernels on the card")
    if prof["bn"] != counters or counters != (53 * PROFILED_K,) * 2 \
            or prof["graph_launches"] != PROFILED_K:
        raise SystemExit("dispatch: the replayed kernels or the counters "
                         "are off")
    return {"runs": runs, "caches": caches, "pairs": pairs,
            "field_lengths": fl, "graph_profile": prof,
            "launches": {"bn_stats": counters[0],
                         "bn_bwd_reduce": counters[1]}}


def dispatch_timing(eq: dict, smi: str) -> None:
    """Phase 21 (d): host ms a step of the eager and the graphed dispatch
    of TIMED_K steps (the median of three dispatches, host clock ending
    in a synchronize), device busy and idle share (the graph's from (b)'s
    profiled dispatch, the eager route's from a profiled dispatch of 2),
    the host's launch calls a step; the capture's time and pool, peak
    memory. The graphed step must make under 1% of the eager step's
    launch calls."""
    pairs, out = eq["pairs"], {}
    torch.cuda.reset_peak_memory_stats()
    for route in ("eager", "graph"):
        run = eq["runs"][route]
        state, d = run["state"], run["dispatch"]
        wall = []
        for i in range(3):
            rows = _dispatch_rows(eq["caches"], _block(pairs, TIMED_K, i))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d(state, rows, 1)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3 / TIMED_K)
        if route == "graph":
            prof, n = eq["graph_profile"], PROFILED_K
        else:
            n = 2
            prof = _profiled_dispatch(d, state, _dispatch_rows(
                eq["caches"], _block(pairs, n)), cpu_ops=False)
        host = sorted(wall)[1]
        busy, calls = prof["busy_ms"] / n, prof["calls"] / n
        out[route] = {"host_ms": host, "busy_ms": busy, "calls": calls}
        log(f"[dispatch] (d) bf16, dispatches of {TIMED_K}, {route}: host "
            f"{host:.3f} ms a step (median of "
            f"{', '.join(f'{w:.3f}' for w in wall)}), device busy "
            f"{busy:.3f} ms a step, idle share {1 - busy / host:.1%} (busy "
            f"of a profiled dispatch of {n}); {prof['kernels'] / n:.0f} "
            f"kernels and {calls:.2f} host launch calls a step; {smi}")
    d = eq["runs"]["graph"]["dispatch"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[dispatch] (d) capture {d.capture_s:.2f} s, graph pool "
        f"{d.pool_bytes / 2**30:.3f} GiB, peak memory allocated "
        f"{peak / 2**30:.3f} GiB over the timed dispatches (two bf16 "
        f"states); eager / graphed host time a step "
        f"{out['eager']['host_ms'] / out['graph']['host_ms']:.3f}; {smi}")
    if out["eager"]["calls"] < 1000 \
            or out["graph"]["calls"] * 100 > out["eager"]["calls"]:
        raise SystemExit("dispatch: the host's launch calls were not read, "
                         "or the graphed step makes 1% of the eager "
                         "step's or more")


def dispatch_routes(eq: dict, dev, smi: str) -> None:
    """Phase 21 (d): under ``steps_per_dispatch: 32`` FreeMatch takes the graph route (one
    dispatch of ROUTE_K steps: the warm-up step, the capture, ROUTE_K - 1
    replays; 53 + 53 a step by the counters) and STiL with
    ``teacher_int8``, the route left eager, runs a dispatch of EAGER_K
    steps one by one (53 + 53 a step)."""
    from stil_tta_torch.algorithms.registry import get_algorithm
    from stil_tta_torch.config import load_config
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    from stil_tta_torch.train.multistep import make_dispatcher
    for config, extra, k, route in (
            ("config_dvm_FreeMatch", [], ROUTE_K, "graph"),
            ("config_dvm_STiL", ["teacher_int8=true"], EAGER_K, "eager")):
        cfg = load_config(config, TRAIN_OVERRIDES + extra + [
            f"steps_per_dispatch={TIMING_K}"])
        algo = get_algorithm(cfg.algorithm_name)(cfg, eq["field_lengths"],
                                                 device=dev)
        state = algo.init_state(0)
        step = algo.make_train_step()
        dispatch, why = make_dispatcher(cfg, algo, step)
        rows = _dispatch_rows(eq["caches"], _block(eq["pairs"], k))
        bn_stats.launches = bn_bwd_reduce.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch(state, rows, 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / k
        launches = (bn_stats.launches, bn_bwd_reduce.launches)
        log(f"[dispatch] (d) {' '.join([cfg.algorithm_name] + extra)}, "
            f"steps_per_dispatch {TIMING_K}: {dispatch.route} route "
            f"({why}); one dispatch of {k} steps {ms:.3f} ms a step (host "
            f"clock, the first step warms cuDNN{', the capture included' if route == 'graph' else ''}), launches "
            f"{launches} (expected {(53 * k,) * 2}); {smi}")
        if dispatch.route != route or launches != (53 * k,) * 2 \
                or state.step != k:
            raise SystemExit(f"dispatch: {cfg.algorithm_name} did not take "
                             f"the {route} route for its {k} steps")
        del algo, state, step, dispatch
        torch.cuda.empty_cache()


# (e): small width (ResNet-18 on 32x32, batch 16 = 4 + 12), each newly
# captured route: (name, YAML, overrides, (bn_stats, bn_bwd_reduce) a step)
SMALL_OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", "img_size=32",
    "synthetic_image_size=40", "batch_size=16", "unlabelled_ratio=3",
    "synthetic_labelled=16", "synthetic_unlabelled=48", "synthetic_val=8",
    "synthetic_test=8", "num_classes=4", "tabular_embedding_dim=32",
    "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
    "projection_dim=8", "start_epoch=0", "strict_prototypes=false",
    "enable_progress_bar=false", "DA=true", "augmentation_rate=1.0",
    "corruption_rate=0.3", "lr_eval=1.0e-3"]
R18 = 20                  # ResNet-18's BatchNorms
SMALL_ROUTES = (
    ("SimMatch", "config_dvm_SimMatch", ["K=16"], (R18, R18)),
    ("CoMatch", "config_dvm_CoMatch", ["K=32"], (2 * R18, R18)),
    ("FreeMatch", "config_dvm_FreeMatch", [], (R18, R18)),
    ("MultiSimMatch", "config_dvm_MultiSimMatch", ["K=16"], (R18, R18)),
    ("MultiCoMatch", "config_dvm_MultiCoMatch", ["K=32"], (2 * R18, R18)),
    ("MultiFreeMatch", "config_dvm_MultiFreeMatch", [], (R18, R18)),
    ("MMatch", "config_dvm_MMatch", [], (R18, R18)),
    ("CoTrain_Pseudo", "config_dvm_CoTrain", [], (R18, R18)),
    ("CoTrain_Pseudo_SAINT", "config_dvm_CoTrain_SAINT", [], (R18, R18)),
    ("TabularEval", "config_dvm_STiL",
     ["algorithm_name=TabularEval", "eval_datatype=tabular"], (0, 0)),
    ("STiL m=4", "config_dvm_STiL", [f"micro_batches={MICRO}"],
     (MICRO * R18, MICRO * R18)))


def dispatch_small_routes(dev, smi: str) -> dict:
    """Phase 21 (e): each route of SMALL_ROUTES from one seed, eager
    against graphed: two dispatches of SMALL_K steps (epoch 0, then 1:
    past ``start_epoch`` every gate flips under replay, MMatch's
    smoothing too), every state tensor bitwise equal after each (the
    queues' and banks' positions included), the BN counters alike on
    both routes; then a graphed dispatch of 2 profiled: the BN kernels a
    replayed step at the route's count. Returns the launches a step."""
    import numpy as np
    from stil_tta_torch.algorithms.registry import get_algorithm
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    from stil_tta_torch.train.multistep import (EagerSteps, GraphedStep,
                                                choose_route)
    src = load_sources(load_config("config_dvm_STiL", SMALL_OVERRIDES))
    caches = [DeviceCache(src[k], device=dev).as_dict()
              for k in ("train_labelled", "train_unlabelled")]
    fl = src["train_labelled"].field_lengths
    rng = np.random.RandomState(0)
    blocks = [(rng.randint(0, 16, (SMALL_K, 4)).astype(np.int32),
               rng.randint(0, 48, (SMALL_K, 12)).astype(np.int32))
              for _ in range(3)]
    out = {}
    for name, config, extra, want in SMALL_ROUTES:
        cfg = load_config(config, SMALL_OVERRIDES + extra)
        cls = get_algorithm(cfg.algorithm_name)
        route = choose_route(cls, cfg, dev)
        runs = {}
        for graphed in (False, True):
            algo = cls(cfg, fl, device=dev)
            torch.manual_seed(0)     # the dropout's generator
            state = algo.init_state(0)
            step = algo.make_train_step()
            d = GraphedStep(algo, step) if graphed else EagerSteps(step)
            counts = []
            for epoch in (0, 1):
                bn_stats.launches = bn_bwd_reduce.launches = 0
                d(state, _dispatch_rows(caches, blocks[epoch]), epoch)
                torch.cuda.synchronize()
                counts.append((bn_stats.launches, bn_bwd_reduce.launches))
            runs[graphed] = (state, d, counts, _snapshot(state))
        (es, _, ec, esnap), (gs, gd, gc, gsnap) = runs[False], runs[True]
        cmp = _compare_states(esnap, gsnap)
        same_gen = torch.equal(es.generator.get_state(),
                               gs.generator.get_state())
        rows = _dispatch_rows(caches, blocks[2])[:2]
        bn_stats.launches = bn_bwd_reduce.launches = 0
        prof = _profiled_dispatch(gd, gs, rows)
        per = (prof["bn"][0] / 2, prof["bn"][1] / 2)
        log(f"[dispatch] (e) {name}: route {route[0]} ({route[1]}); eager "
            f"against graphed after two dispatches of {SMALL_K} (epochs 0, "
            f"1): {cmp['bitwise']} of {cmp['tensors']} state tensors "
            f"bitwise equal, largest float relative L2 {cmp['rel_l2']:.3e}, "
            f"integers off {cmp['ints_off']}, generator equal {same_gen}; "
            f"counters (bn_stats, bn_bwd_reduce) by dispatch eager {ec}, "
            f"graphed {gc}; replayed step's {gd.launches_per_replay}; "
            f"profiled kernels a replayed step {per} (expected {want}), "
            f"{prof['calls'] / 2:.1f} host launch calls a step; capture "
            f"{gd.capture_s:.2f} s; {smi}")
        if route[0] != "graph" or not cmp["same_names"] \
                or cmp["bitwise"] != cmp["tensors"] or not same_gen \
                or ec != gc or ec != [tuple(SMALL_K * n for n in want)] * 2 \
                or per != want or prof["bn"] != (bn_stats.launches,
                                                 bn_bwd_reduce.launches) \
                or prof["graph_launches"] != 2:
            raise SystemExit(f"dispatch (e): {name}'s graphed dispatch "
                             "differs from its eager steps, or its replayed "
                             "kernels are off")
        out[name] = per
        del runs, es, gs, gd
    return out


def dispatch_full_width(eq: dict, dev, smi: str) -> dict:
    """Phase 21 (f): CoMatch (its momentum encoder adds 53 ``bn_stats``
    a step) and STiL at ``micro_batches`` MICRO (53 x MICRO of each) at
    full width, bf16, epoch 1, one state a family that runs the eager
    route and then the graph route: for each route a warm dispatch of 2
    (the graph's warm-up step, its capture and a replay; a capture from
    a dispatch of one step would hold its indices as fixed inputs), then
    three dispatches of FULL_K steps on the host clock (the median), a
    dispatch of PROFILED_F steps under the profiler (device busy, idle
    share, the host's launch calls, the BN kernels, each divided by the
    steps), the capture's time and pool
    and the peak memory. The graphed step must make under 1% of the
    eager step's launch calls."""
    from stil_tta_torch.algorithms.registry import get_algorithm
    from stil_tta_torch.config import load_config
    from stil_tta_torch.train.multistep import EagerSteps, GraphedStep
    out = {}
    for name, config, extra, want in (
            ("CoMatch", "config_dvm_CoMatch", [], (106, 53)),
            (f"STiL m={MICRO}", "config_dvm_STiL",
             [f"micro_batches={MICRO}"], (53 * MICRO, 53 * MICRO))):
        cfg = load_config(config, TRAIN_OVERRIDES + extra)
        res = {}
        algo = get_algorithm(cfg.algorithm_name)(cfg, eq["field_lengths"],
                                                 device=dev)
        torch.manual_seed(0)
        state = algo.init_state(0)
        step = algo.make_train_step()
        for route in ("eager", "graph"):
            d = GraphedStep(algo, step) if route == "graph" \
                else EagerSteps(step)
            torch.cuda.reset_peak_memory_stats()
            d(state, _dispatch_rows(eq["caches"], _block(eq["pairs"], 2)), 1)
            wall = []
            for i in range(3):
                rows = _dispatch_rows(eq["caches"],
                                      _block(eq["pairs"], FULL_K, 2 + i))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                d(state, rows, 1)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3 / FULL_K)
            prof = _profiled_dispatch(d, state, _dispatch_rows(
                eq["caches"], _block(eq["pairs"], PROFILED_F, 5)),
                cpu_ops=route == "graph")
            host = sorted(wall)[1]
            busy, calls = (prof[k] / PROFILED_F for k in ("busy_ms", "calls"))
            per = tuple(n / PROFILED_F for n in prof["bn"])
            peak = torch.cuda.max_memory_allocated()
            res[route] = {"host_ms": host, "busy_ms": busy, "calls": calls,
                          "bn": per}
            extra_log = (f"; capture {d.capture_s:.2f} s, graph pool "
                         f"{d.pool_bytes / 2**30:.3f} GiB"
                         if route == "graph" else "")
            log(f"[dispatch] (f) {name}, bf16, dispatches of {FULL_K}, "
                f"{route}: host {host:.3f} ms a step (median of "
                f"{', '.join(f'{w:.3f}' for w in wall)}), device busy "
                f"{busy:.3f} ms a step, idle share {1 - busy / host:.1%} (a "
                f"profiled dispatch of {PROFILED_F}); "
                f"{prof['kernels'] / PROFILED_F:.0f} kernels, {calls:.1f} host "
                f"launch calls and (bn_stats, bn_bwd_reduce) {per} a step "
                f"(expected "
                f"{want}); peak memory {peak / 2**30:.3f} GiB{extra_log}; "
                f"{smi}")
            del d
        del algo, state, step
        torch.cuda.empty_cache()
        log(f"[dispatch] (f) {name}: eager / graphed host time a step "
            f"{res['eager']['host_ms'] / res['graph']['host_ms']:.3f}; "
            f"{smi}")
        if any(r["bn"] != want for r in res.values()) \
                or res["eager"]["calls"] < 1000 \
                or res["graph"]["calls"] * 100 > res["eager"]["calls"]:
            raise SystemExit(f"dispatch (f): {name}'s BN kernels are off, or "
                             "the graphed step makes 1% of the eager step's "
                             "launch calls or more")
        out[name] = res
    return out


def dispatch_planted_failure(eq: dict) -> None:
    """Phase 21 (b): a step with a planted host sync (a device value read
    on the host) cannot be captured: the dispatch raises, it does not run
    eager steps instead, and the generators draw eagerly again after it."""
    from stil_tta_torch.train.multistep import GraphedStep
    run = eq["runs"]["eager"]
    step = run["algo"].make_train_step()

    def synced(state, *args):
        float(state.log_count)     # the planted host sync
        return step(state, *args)

    rows = _dispatch_rows(eq["caches"], _block(eq["pairs"], 2))
    planted = GraphedStep(run["algo"], synced)
    try:
        planted(run["state"], rows, 1)
    except RuntimeError as exc:
        log(f"[dispatch] (b) capture with a planted host sync failed, as it "
            f"must: {str(exc).splitlines()[0][:160]}")
    else:
        raise SystemExit("dispatch: a step with a host sync was captured")
    if planted.graph is not None:
        raise SystemExit("dispatch: a failed capture left a graph")
    step(run["state"], *rows[1], 1)     # eager draws work again
    torch.cuda.synchronize()


def _evaluate_f32(cfg):
    """``evaluate`` on the card with the algorithm computing in float32
    (the class of the registry built with ``dtype``)."""
    from stil_tta_torch.algorithms import registry
    from stil_tta_torch.train.evaluate import evaluate
    real = registry.get_algorithm

    def float32(name):
        cls = real(name)

        class Float32(cls):
            def __init__(self, cfg, field_lengths, device):
                super().__init__(cfg, field_lengths, dtype=torch.float32,
                                 device=device)
        return Float32

    registry.get_algorithm = float32
    try:
        return evaluate(cfg, device="cuda")
    finally:
        registry.get_algorithm = real


def dispatch_evaluate(smi: str) -> None:
    """Phase 21 (c): ``evaluate`` with phase 6's flags for one epoch of 8
    steps in float32, at ``steps_per_dispatch`` 1 and SPD_EVAL (two
    graphed dispatches and a tail of two single steps) through the device
    cache, and at SPD_EVAL through the host stream: the last checkpoints
    bitwise equal, and both kernels' launches the single-step run's."""
    from stil_tta_torch.config import load_config
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    ckpts = {}
    for spd, hs in ((1, False), (SPD_EVAL, False), (SPD_EVAL, True)):
        logdir = Path(f"runs/chip_smoke_dispatch_{spd}_{hs}")
        shutil.rmtree(logdir, ignore_errors=True)
        cfg = load_config("config_dvm_STiL", TRAIN_OVERRIDES + [
            "max_epochs=1", "checkpoint_every_n_epochs=1",
            "save_checkpoints=false", "test_and_eval=false",
            f"steps_per_dispatch={spd}", f"host_stream={str(hs).lower()}",
            f"logdir={logdir}"])
        bn_stats.launches = bn_bwd_reduce.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _evaluate_f32(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (bn_stats.launches, bn_bwd_reduce.launches)
        payload = torch.load(logdir / "checkpoint_last", map_location="cpu",
                             weights_only=True)
        ckpts[(spd, hs)] = dict(_tensors(payload))
        log(f"[dispatch] (c) evaluate, float32, steps_per_dispatch {spd}, "
            f"host_stream {hs}: {wall:.1f} s, launches (bn_stats, "
            f"bn_bwd_reduce) {launches} (expected "
            f"{(53 * STEPS_PER_EPOCH,) * 2}), step {payload['step']}")
        if launches != (53 * STEPS_PER_EPOCH,) * 2 \
                or payload["step"] != STEPS_PER_EPOCH:
            raise SystemExit("dispatch: evaluate's launches or steps are off")
        shutil.rmtree(logdir, ignore_errors=True)
    ref = ckpts[(1, False)]
    for key in ((SPD_EVAL, False), (SPD_EVAL, True)):
        c = _compare_states(ckpts[key], ref)
        log(f"[dispatch] (c) the last checkpoint of steps_per_dispatch "
            f"{key[0]} (host_stream {key[1]}) against 1 (the device cache): "
            f"{c['bitwise']} of {c['tensors']} tensors bitwise equal, largest"
            f" float relative L2 {c['rel_l2']:.3e}, integers off "
            f"{c['ints_off']}; {smi}")
        if not c["same_names"] or c["bitwise"] != c["tensors"]:
            raise SystemExit("dispatch: evaluate at steps_per_dispatch "
                             f"{key[0]} differs from single steps")


def dispatch_beside_dryruns(dev, smi: str) -> dict:
    """Phase 21 (e), then (c), cuDNN deterministic, each one's wall time
    logged; they run beside phase 18's NCCL and tiny dry runs, so no
    check of theirs reads a time. Returns (e)'s launches a replayed step
    by route."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        small = dispatch_small_routes(dev, smi)
        t1 = time.perf_counter()
        log(f"[time] phase 21 (e), beside phase 18 (c, d): {t1 - t0:.1f} s")
        dispatch_evaluate(smi)
        log(f"[time] phase 21 (c), beside phase 18 (c, d): "
            f"{time.perf_counter() - t1:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {f"graphed_small_{k}": {"bn_stats": int(v[0]),
                                   "bn_bwd_reduce": int(v[1])}
            for k, v in small.items()}


def dispatch_phase(dev, smi: str, clock) -> dict:
    """Phase 21 but (e) and (c) (:func:`dispatch_beside_dryruns`):
    ``steps_per_dispatch`` as replays of one captured step (cuDNN
    deterministic for the phase); returns the launches of the profiled
    graphed dispatches."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t21 = time.perf_counter()
    try:
        eq = dispatch_equality(dev, smi)
        launches = eq["launches"]
        clock.lap("21 (a, b) dispatch equality, replayed launches")
        dispatch_timing(eq, smi)
        dispatch_planted_failure(eq)
        del eq["runs"]
        torch.cuda.empty_cache()
        clock.lap("21 (d) timing, (b) planted failure")
        dispatch_routes(eq, dev, smi)
        clock.lap("21 (d) routes")
        full = dispatch_full_width(eq, dev, smi)
        del eq
        torch.cuda.empty_cache()
        clock.lap("21 (f) CoMatch and micro-batched STiL at full width")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[time] phase 21: {time.perf_counter() - t21:.1f} s")
    out = {"stil_graphed_dispatch": launches}
    for name, res in full.items():
        bn = res["graph"]["bn"]
        out[f"graphed_{name}"] = {"bn_stats": int(bn[0]),
                                  "bn_bwd_reduce": int(bn[1])}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    cache_synthetic_sources()
    clock = PhaseClock()

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
    clock.lap("1 device")

    # ---- 2. build, one nvcc for each source, all started together
    from stil_tta_torch.ops import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(cuda_build.build, SOURCES))
    build_s = time.perf_counter() - t0
    for name, lib in zip(SOURCES, libs):
        log(f"[build] {lib.name} (all built in {build_s:.2f} s)")
        for line in cuda_build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    clock.lap("2 build")

    # ---- 3. kernel against plain at every ResNet-50 BN shape
    from stil_tta_torch.ops.batch_norm import bn_stats, bn_stats_plain
    shapes = resnet50_bn_shapes(dev)
    assert len(shapes) == 53, len(shapes)
    per_forward = collections.Counter(shapes)
    # the chunk shapes of micro_batches=4: batch 128
    chunk_shapes = [s for s in collections.Counter(
        resnet50_bn_shapes(dev, BATCH // MICRO)) if s not in per_forward]
    log(f"[kernel] batch {BATCH // MICRO} adds {len(chunk_shapes)} (M, C): "
        f"{chunk_shapes}")
    checked = list(per_forward) + chunk_shapes
    # cardiac (batch 256) and Supervised's labelled rows (64 and 32)
    for b in SLICE9_BATCHES:
        extra = [s for s in collections.Counter(resnet50_bn_shapes(dev, b))
                 if s not in checked]
        log(f"[kernel] batch {b} adds {len(extra)} (M, C): {extra}")
        checked += extra
    # CoMatch's momentum encoder: 64 + 448 + 448 rows, forward only
    teacher_shapes = [s for s in collections.Counter(
        resnet50_bn_shapes(dev, TEACHER_ROWS)) if s not in checked]
    log(f"[kernel] batch {TEACHER_ROWS} (bn_stats only) adds "
        f"{len(teacher_shapes)} (M, C)")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for m, c in checked + teacher_shapes:
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
    max_abs_bwd = check_bwd_kernel(checked, gen, dev)
    check_bn_function(gen, dev)
    clock.lap("3 kernels vs plain")

    # ---- 4. the slice at full width
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.train.test import build_algo, load_test_split, test
    from stil_tta_torch.tta import adapt
    overrides = TEST_OVERRIDES + ["tta_strategy=bn_adapt",
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
    adapt_kernel_vs_plain(cfg, algo, cache, init_state, "slice")

    # where the BN-adapt pass spends device time
    from torch.profiler import ProfilerActivity, profile
    algo.net.load_state_dict(init_state)
    torch.cuda.synchronize()
    bn_stats.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        adapt(cfg, algo, cache)
        torch.cuda.synchronize()
    profiled_launches = bn_stats.launches
    # kernel events only: operator rows repeat their kernels' time
    dev_time = lambda e: getattr(  # noqa: E731
        e, "device_time_total", getattr(e, "cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_time(e) for e in events)
    bn_us = sum(dev_time(e) for e in events if "bn_stats_kernel" in e.key)
    bn_events = sum(e.count for e in events if "bn_stats_kernel" in e.key)
    # bn_stats is one kernel a call: no second pass runs in this pass
    pass2 = sum(e.count for e in events if "column_sums" in e.key)
    log(f"[profile] BN-adapt pass: device busy {busy_us / 1e3:.3f} ms, "
        f"bn_stats kernels {bn_us / 1e3:.3f} ms "
        f"({bn_us / max(busy_us, 1e-9):.1%}); {bn_events} bn_stats kernel "
        f"events for {profiled_launches} launches "
        f"({53 * stats_batches} expected), {pass2} column_sums kernels")
    if not bn_events == profiled_launches == 53 * stats_batches or pass2:
        raise SystemExit("bn_stats is not one kernel a call in the BN-adapt "
                         "pass")
    top = sorted(events, key=dev_time, reverse=True)[:8]
    for e in top:
        log(f"[profile]   {dev_time(e) / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")
    clock.lap("4 test-time slice")

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
    adapt_launches = launches
    del algo, cache, pred, src
    clock.lap("5 serving")

    # ---- 6. training at full width
    train_cfg, launches, steps6 = train_full_width()
    clock.lap("6 training")

    # ---- 7. one train step with the kernels and with the plain pair
    train_step_kernel_vs_plain(train_cfg, dev)
    clock.lap("7 kernel vs plain step")

    # ---- 8. profile of one train step (bfloat16, the path's numerics)
    from stil_tta_torch.train.optim import set_learning_rate
    algo, step, batch = step_setup(train_cfg, dev)
    state = algo.init_state(0)
    set_learning_rate(state.optimizer, STEP_LR)
    single = profile_train_step(state, step, batch)
    single["steps_per_s"] = steps6
    if single["bn_bwd_reduce_kernels"] != 53:
        raise SystemExit(f"{single['bn_bwd_reduce_kernels']} bn_bwd_reduce "
                         f"kernels in a train step, 53 expected")
    del algo, state, step, batch
    clock.lap("8 step profile")

    # ---- 9. timing per shape (bfloat16, the path's dtype)
    for source in ("bn_stats", "bn_bwd_reduce"):
        ptxas = ptxas_report(source)
        for entry, report in ptxas.items():
            log(f"[time] {source} ptxas {entry}: {report}")
        if not any(f"{source}_kernel" in k for k in ptxas):
            raise SystemExit(f"no ptxas report for {source}")
        spills = [k for k, v in ptxas.items() if f"{source}_kernel" in k
                  and " 0 bytes spill stores, 0 bytes spill loads" not in
                  f" {v}"]
        if spills:
            raise SystemExit(f"{source}: a kernel variant spills: {spills}")
    buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    # a flush that reads: L2 then holds clean lines only
    clean = torch.ones(64 * 2**20, device=dev)
    tot, bound_by = time_forward(per_forward, gen, dev, buf, clean, BATCH)
    del clean
    # the cost of a call that moves almost no bytes: one row a block,
    # beside one elementwise kernel on the same input
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce
    x = torch.randn(132, 256, generator=gen, device=dev).to(torch.bfloat16)
    floor_args = (x, x.clone(), torch.zeros(256, device=dev),
                  torch.ones(256, device=dev))
    log(f"[time] per-call floor at M=132 C=256: bn_stats "
        f"{time_ms(bn_stats, x, buf) * 1e3:.2f} us, bn_bwd_reduce "
        f"{time_ms(lambda t: bn_bwd_reduce(*t), floor_args, buf) * 1e3:.2f}"
        f" us, x.add_(0) {time_ms(lambda t: t.add_(0), x, buf) * 1e3:.2f} "
        f"us")
    del floor_args
    tot_b, bound_by_b = time_backward(per_forward, gen, dev, buf, BATCH)
    # the cardiac batch's shapes
    cardiac_shapes = collections.Counter(resnet50_bn_shapes(dev,
                                                            CARDIAC_BATCH))
    time_forward(cardiac_shapes, gen, dev, buf, None, CARDIAC_BATCH)
    time_backward(cardiac_shapes, gen, dev, buf, CARDIAC_BATCH)
    log(f"[time] launches: BN-adapt slice bn_stats {adapt_launches}; "
        f"training {launches} (the record's counts)")
    del buf
    clock.lap("9 kernel timing")

    # ---- 10. TTA strategies at full width
    tta_strategies_full_width()
    clock.lap("10 TTA strategies")

    # ---- 11. the conv+BN probe
    probe_rows = probe_phase()
    clock.lap("11 probe")

    # ---- 12. STiL_SAINT at full width
    by_path = {"stil_bn_adapt": {"bn_stats": adapt_launches},
               "stil_train": launches}
    by_path.update(saint_phase(dev))
    clock.lap("12 STiL_SAINT")

    # ---- 13. the fast numerics profile
    by_path["fast_profile_train"] = fast_profile_phase(dev, single)
    clock.lap("13 fast profile")

    # ---- 14. the semi-multimodal pair at full width
    by_path.update(pair_phase(dev, single))
    clock.lap("14 MMatch and Co-Training")

    # ---- 15. the FixMatch families at full width
    by_path.update(fixmatch_phase(dev, single))
    clock.lap("15 FixMatch families")

    # ---- 16. cardiac, Supervised, TabularEval, missing_tabular
    by_path.update(cardiac_phase(dev, single))
    clock.lap("16 cardiac and baselines")

    # ---- 17. int8 image tower, teacher-int8 training, frozen warm start
    int8_launches, _ = int8_phase(dev, single, sps)
    by_path.update(int8_launches)
    by_path.update(warm_start_phase(dev))
    clock.lap("17 int8 and warm start")

    # ---- 18. data parallelism; phase 21 (e) and (c) beside its NCCL and
    # tiny dry runs (subprocesses whose times no check reads)
    beside = {}
    by_path.update(data_parallel_phase(
        clock, lambda: beside.update(dispatch_beside_dryruns(dev, smi))))
    by_path.update(beside)
    clock.lap("18 (c, d) NCCL and tiny dry runs, 21 (e) and (c) beside "
              "them")

    # ---- 19. the host stream, the encoder zoo, grouped int8
    by_path.update(host_stream_phase(dev))
    clock.lap("19 (a) host stream")
    by_path.update(zoo_phase(dev))
    clock.lap("19 (b) encoder zoo")
    by_path.update(grouped_int8_phase(dev))
    clock.lap("19 (c) grouped int8")

    # ---- 20. the offline data prep and the shift workflow
    t20 = time.perf_counter()
    reports = shift_splits_phase()
    clock.lap("20 (a) shifted splits")
    by_path.update(shift_sweep_phase(reports))
    clock.lap("20 (b) shift sweep")
    shift_cli_phase()
    shutil.rmtree(SHIFT_DATA, ignore_errors=True)
    clock.lap("20 (c) kernel vs plain, the sweep script's command")
    by_path.update(tta_demo_phase())
    clock.lap("20 (d) TTA demo")
    log(f"[time] phase 20: {time.perf_counter() - t20:.1f} s")

    # ---- 21. steps_per_dispatch: replays of one captured train step
    by_path.update(dispatch_phase(dev, smi, clock))
    log(f"[time] launches by path {json.dumps(by_path)}")
    paths = {k: {p: n[k] for p, n in by_path.items() if k in n}
             for k in ("bn_stats", "bn_bwd_reduce")}

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "bn_stats", "route": "cuda",
        "source": "stil_tta_torch/csrc/bn_stats.cu",
        "replaces": "stil_tta_tpu/ops/batch_norm.py:61",
        "launches": launches["bn_stats"], "max_abs_err": max_abs,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": bound_by,
        "library_ms": tot["library_ms"],
        "launches_by_path": paths["bn_stats"]}, {
        "name": "bn_bwd_reduce", "route": "cuda",
        "source": "stil_tta_torch/csrc/bn_bwd_reduce.cu",
        "replaces": "stil_tta_tpu/ops/batch_norm.py:97",
        "launches": launches["bn_bwd_reduce"], "max_abs_err": max_abs_bwd,
        "ms": tot_b["ms"], "plain_ms": tot_b["plain_ms"],
        "bound_ms": tot_b["bound_ms"], "bound_by": bound_by_b,
        "library_ms": tot_b["library_ms"],
        "launches_by_path": paths["bn_bwd_reduce"]}] + probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
