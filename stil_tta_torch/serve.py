"""Batched inference / serving (the port of ``stil_tta_tpu/serve.py``).

The deployment shape is the multimodal-head forward:
``softmax(classifier_multimodal(...))``. :class:`Predictor` keeps the
weights on the card and scores numpy batches; the CLI scores a
native-format split into a CSV:

    python -m stil_tta_torch.serve --config-name config_dvm_STiL \
        --checkpoint model.ckpt --source data/test --out predictions.csv

Serves every algorithm of the registry. ``--int8`` (``Predictor(int8=
True)``) runs the image tower's convolutions in int8
(``ops/quant_conv.py``) for the nets whose forward takes ``int8_image``
(STiL's); the activation scale is per batch, so a sample's int8 result
depends on its batch mates and on ``--batch-size``.

``--data-parallel`` (``Predictor(mesh=...)``) scores each batch over the
ranks of a ``torch.distributed.run`` job, each rank its share of the
rows, with the single process's results; rank 0 writes the CSV:

    python -m torch.distributed.run --nproc-per-node 2 \
        -m stil_tta_torch.serve --data-parallel --config-name ... \
        --checkpoint model.ckpt --source data/test --out predictions.csv
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
from typing import Optional, Sequence

import numpy as np
import torch

from stil_tta_torch.config import load_config
from stil_tta_torch.parallel import Mesh, sharded
from stil_tta_torch.parallel.collectives import rank_index
from stil_tta_torch.train.test import build_algo


class Predictor:
    """Scores (images, tabular) in batches of ``batch_size``. The tail
    batch is padded to ``batch_size`` by repeating its first row, as the
    JAX package's ``Predictor`` pads it: STiL_SAINT's intersample
    attention mixes the rows of a batch, so a prediction depends on its
    batch mates, and the padding is part of the result; so does int8's
    per-batch activation scale.

    ``int8``: the int8 image tower (``stil_tta_tpu/serve.py:41-80``),
    refused with ``ValueError`` for a net whose forward takes no
    ``int8_image`` and for a ViT encoder, as the JAX package refuses
    them.

    ``mesh``: data-parallel serving (``stil_tta_tpu/serve.py:41-61``).
    Every rank calls the predictor with the same arrays; ``batch_size`` is
    rounded up to a multiple of the mesh's size, each rank runs the net on
    its rows of each batch (the int8 scale and SAINT's attention still
    see the whole batch), and every rank returns all the
    probabilities."""

    def __init__(self, algo, batch_size: int = 256, int8: bool = False,
                 mesh: Optional[Mesh] = None):
        self.algo = algo
        self.mesh = mesh
        if mesh is not None:
            batch_size = -(-batch_size // mesh.size) * mesh.size
        self.batch_size = batch_size
        self.kw = {}
        if int8:
            net = algo.net
            if "int8_image" not in inspect.signature(
                    type(net).forward).parameters:
                raise ValueError(
                    f"int8 serving unsupported for {type(net).__name__}")
            if str(algo.cfg.model).startswith("vit"):
                raise ValueError("int8 serving unsupported for ViT "
                                 "image encoders")
            self.kw["int8_image"] = True

    @classmethod
    def from_checkpoint(cls, cfg, checkpoint: str,
                        field_lengths: Optional[Sequence[int]] = None,
                        batch_size: int = 256, device="cuda",
                        dtype: torch.dtype = torch.bfloat16,
                        int8: bool = False,
                        mesh: Optional[Mesh] = None) -> "Predictor":
        """A predictor with the weights of a reference-layout ``.ckpt``."""
        cfg.checkpoint = checkpoint
        algo = build_algo(cfg, list(field_lengths or cfg.field_lengths),
                          device, dtype)
        return cls(algo, batch_size, int8=int8, mesh=mesh)

    @torch.no_grad()
    def predict(self, images: torch.Tensor, tabular: torch.Tensor,
                rows: Optional[int] = None) -> torch.Tensor:
        """One batch already on the card -> (B, C) float32 probabilities.
        With ``rows``, the batch has that many rows and ``images`` and
        ``tabular`` hold this rank's share of them (``rank_index``)."""
        net = self.algo.net.eval()

        def forward(img: torch.Tensor, tab: torch.Tensor):
            return net(self.algo.aug_eval(img), tab, **self.kw)

        with self.mesh or contextlib.nullcontext():
            out = sharded(forward, (rows or images.shape[0],), images,
                          tabular, local=rows is not None)
        # STiL's nets return a dict of heads, the comparison families'
        # a tuple led by the multimodal head's logits, TabularNet the
        # logits alone (``serve.py:82-92``)
        if isinstance(out, dict):
            logits = out["out_m"]
        elif isinstance(out, tuple):
            logits = out[0]
        else:
            logits = out
        return torch.softmax(logits.float(), dim=1)

    def __call__(self, images: np.ndarray,
                 tabular: np.ndarray) -> np.ndarray:
        dev = self.algo.device
        outs = []
        bs = self.batch_size
        # under a mesh each rank uploads only its rows of each batch
        keep = (None if self.mesh is None
                else rank_index(self.mesh, (bs,)).numpy())
        for start in range(0, len(images), bs):
            img = np.asarray(images[start:start + bs])
            tab = np.asarray(tabular[start:start + bs], np.float32)
            n = len(img)
            if n < bs:
                img = np.concatenate([img, np.repeat(img[:1], bs - n, 0)])
                tab = np.concatenate([tab, np.repeat(tab[:1], bs - n, 0)])
            if keep is not None:
                img, tab = img[keep], tab[keep]
            outs.append(self.predict(torch.tensor(img, device=dev),
                                     torch.tensor(tab, device=dev),
                                     rows=None if keep is None else bs)[:n])
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
    ap.add_argument("--int8", action="store_true",
                    help="int8 image-tower convs (an inference numerics "
                         "change; STiL's nets only)")
    ap.add_argument("--data-parallel", action="store_true",
                    help="score over the ranks of a torch.distributed.run "
                         "job; rank 0 writes the CSV")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    device, mesh = args.device, None
    if args.data_parallel:
        from stil_tta_torch.parallel import create_mesh, init_process_group
        device = init_process_group(args.device)
        mesh = create_mesh()

    from stil_tta_torch.data.source import ArraySource
    cfg = load_config(args.config_name, overrides=args.overrides)
    src = ArraySource.load(args.source)
    cfg.num_classes = cfg.num_classes or src.num_classes
    predictor = Predictor.from_checkpoint(
        cfg, args.checkpoint, src.field_lengths, args.batch_size,
        device=device, int8=args.int8, mesh=mesh)
    probs = predictor(np.asarray(src.images), src.tabular)
    if mesh is not None:
        torch.distributed.destroy_process_group()
        if mesh.rank:
            return 0
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
