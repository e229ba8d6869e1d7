"""Batched inference / serving (the port of ``stil_tta_tpu/serve.py``).

The deployment shape is the multimodal-head forward:
``softmax(classifier_multimodal(...))``. :class:`Predictor` keeps the
weights on the card and scores numpy batches; the CLI scores a
native-format split into a CSV:

    python -m stil_tta_torch.serve --config-name config_dvm_STiL \
        --checkpoint model.ckpt --source data/test --out predictions.csv

Serves STiL and STiL_SAINT. The JAX package's data-parallel and int8
serving options are still to port (ROADMAP.md).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from stil_tta_torch.config import load_config
from stil_tta_torch.train.test import build_algo


class Predictor:
    """Scores (images, tabular) in batches of ``batch_size``. The tail
    batch is padded to ``batch_size`` by repeating its first row, as the
    JAX package's ``Predictor`` pads it: STiL_SAINT's intersample
    attention mixes the rows of a batch, so a prediction depends on its
    batch mates, and the padding is part of the result."""

    def __init__(self, algo, batch_size: int = 256):
        self.algo = algo
        self.batch_size = batch_size

    @classmethod
    def from_checkpoint(cls, cfg, checkpoint: str,
                        field_lengths: Optional[Sequence[int]] = None,
                        batch_size: int = 256, device="cuda",
                        dtype: torch.dtype = torch.bfloat16) -> "Predictor":
        """A predictor with the weights of a reference-layout ``.ckpt``."""
        cfg.checkpoint = checkpoint
        algo = build_algo(cfg, list(field_lengths or cfg.field_lengths),
                          device, dtype)
        return cls(algo, batch_size)

    @torch.no_grad()
    def predict(self, images: torch.Tensor,
                tabular: torch.Tensor) -> torch.Tensor:
        """One batch already on the card -> (B, C) float32 probabilities."""
        net = self.algo.net.eval()
        out = net(self.algo.aug_eval(images), tabular)["out_m"]
        return torch.softmax(out.float(), dim=1)

    def __call__(self, images: np.ndarray,
                 tabular: np.ndarray) -> np.ndarray:
        dev = self.algo.device
        outs = []
        bs = self.batch_size
        for start in range(0, len(images), bs):
            img = np.asarray(images[start:start + bs])
            tab = np.asarray(tabular[start:start + bs], np.float32)
            n = len(img)
            if n < bs:
                img = np.concatenate([img, np.repeat(img[:1], bs - n, 0)])
                tab = np.concatenate([tab, np.repeat(tab[:1], bs - n, 0)])
            outs.append(self.predict(torch.tensor(img, device=dev),
                                     torch.tensor(tab, device=dev))[:n])
        return torch.cat(outs).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config-name", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--source", required=True,
                    help="native-format split directory to score")
    ap.add_argument("--out", default="predictions.csv")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    from stil_tta_torch.data.source import ArraySource
    cfg = load_config(args.config_name, overrides=args.overrides)
    src = ArraySource.load(args.source)
    cfg.num_classes = cfg.num_classes or src.num_classes
    predictor = Predictor.from_checkpoint(
        cfg, args.checkpoint, src.field_lengths, args.batch_size,
        device=args.device)
    probs = predictor(np.asarray(src.images), src.tabular)
    pred = probs.argmax(1)
    acc = float((pred == src.labels).mean())
    with open(args.out, "w") as f:
        f.write("index,prediction,confidence\n")
        for i, (p, c) in enumerate(zip(pred, probs.max(1))):
            f.write(f"{i},{p},{c:.6f}\n")
    print(f"scored {len(pred)} samples, acc={acc:.4f} -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
