"""TTA efficacy demo, the port of ``tools/tta_demo.py``: train a confident
base model, apply a controlled covariate shift, and score BN-adapt, Tent,
EATA and SAR on the shifted test set.

Entropy minimisation needs a confident base model, so the demo trains the
``Supervised`` algorithm (or ``STiL`` with ``--algorithm STiL``) on
synthetic class-conditional data first, then scores the best checkpoint
on the clean test set, on a gamma/brightness/channel-imbalance shifted
copy of it, and on that copy after each adaptation, each from the same
checkpoint. Writes ``<root>/tta_demo.json`` with the keys ``clean``,
``shift_no_tta``, ``shift_<strategy>`` and ``recovered_<strategy>``.

    python -m stil_tta_torch.tools.tta_demo --root runs/tta_demo --epochs 30

Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
from pathlib import Path

import numpy as np

STRATEGIES = ("bn_adapt", "tent", "eata", "sar")


def shift_images(imgs: np.ndarray) -> np.ndarray:
    """Covariate shift: gamma 0.55, brightness 0.75 and channel
    imbalance; it shifts the activation statistics without destroying
    the class evidence (BN-adaptable by construction)."""
    x = imgs.astype(np.float32) / 255.0
    x = x ** 0.55
    x = x * np.asarray([0.85, 0.70, 0.60], np.float32)
    return np.clip(x * 255.0, 0, 255).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--algorithm", default="Supervised",
                    help="Supervised (image-only demo) or STiL (the "
                         "multimodal model)")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--n-test", type=int, default=512)
    ap.add_argument("--tta-steps", type=int, default=2)
    ap.add_argument("--reuse-checkpoint", action="store_true",
                    help="skip base training if the checkpoint exists")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from stil_tta_torch.algorithms.registry import get_algorithm
    from stil_tta_torch.config import load_config
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.data.source import synthetic_source
    from stil_tta_torch.train.checkpoint import restore_checkpoint
    from stil_tta_torch.train.evaluate import evaluate, run_validation
    from stil_tta_torch.tta import adapt

    root = Path(args.root)
    logdir = root / "base"
    cfg = load_config("config_dvm_STiL", overrides=[
        "dataset=synthetic_dvm", "models=resnet18",
        f"algorithm_name={args.algorithm}",
        f"num_classes={args.classes}", f"img_size={args.img_size}",
        f"synthetic_image_size={args.img_size + 8}",
        f"batch_size={args.batch_size}", "unlabelled_ratio=1",
        f"synthetic_labelled={args.n_train}",
        f"synthetic_unlabelled={args.n_train}",
        f"synthetic_val={args.n_test}", f"synthetic_test={args.n_test}",
        f"max_epochs={args.epochs}", "start_epoch=0",
        "tabular_embedding_dim=64", "multimodal_embedding_dim=64",
        "tabular_transformer_num_layers=1", "projection_dim=16",
        "tta=false", "strict_prototypes=false", "test_and_eval=false",
        "enable_progress_bar=false", f"logdir={logdir}",
        f"tta_steps={args.tta_steps}",
    ])
    if args.reuse_checkpoint and (logdir / "checkpoint_best_acc").exists():
        print("reusing existing base checkpoint")
    else:
        results = evaluate(cfg, device=args.device)
        print("base training:", results)

    algo = get_algorithm(cfg.algorithm_name)(cfg, cfg.field_lengths,
                                             device=args.device)
    state = algo.init_state(0)
    restore_checkpoint(logdir, state, name="checkpoint_best_acc")
    base = copy.deepcopy(algo.net.state_dict())
    src_test = synthetic_source(
        args.n_test, num_classes=args.classes,
        field_lengths=list(cfg.field_lengths),
        image_size=args.img_size + 8, labelled_frac=1.0, seed=7)
    eval_step = algo.make_eval_step()
    num_classes = int(cfg.num_classes)
    bs = int(cfg.batch_size)

    def score(cache, tag):
        m = run_validation(eval_step, cache, bs, num_classes, prefix="test")
        print(f"{tag:22s} acc={m['test.acc']:.4f}")
        return m["test.acc"]

    clean_cache = DeviceCache(src_test, device=algo.device).as_dict()
    shifted = dataclasses.replace(
        src_test, images=shift_images(np.asarray(src_test.images)))
    shift_cache = DeviceCache(shifted, device=algo.device).as_dict()

    out = {"clean": score(clean_cache, "clean (no shift)"),
           "shift_no_tta": score(shift_cache, "shifted, no TTA")}

    for strategy in STRATEGIES:
        # every strategy adapts the base checkpoint, as the JAX demo
        # adapts the same restored state each time
        algo.net.load_state_dict(base)
        cfg.tta_strategy = strategy
        adapt(cfg, algo, shift_cache)
        out[f"shift_{strategy}"] = score(shift_cache, f"shifted, {strategy}")

    for strategy in STRATEGIES:
        out[f"recovered_{strategy}"] = (out[f"shift_{strategy}"]
                                        - out["shift_no_tta"])
    print(json.dumps(out, indent=2))
    (root / "tta_demo.json").write_text(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
