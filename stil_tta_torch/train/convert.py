"""JAX variable tree -> reference-layout torch ``state_dict``, and a JAX
``STiLState`` -> the port's train state.

The port's own copy of the non-SAINT path of
``stil_tta_tpu/train/convert.py:export_torch_state_dict`` and its key
mapping. The port's modules carry the reference's torch key names, so
the output loads into them with ``load_state_dict(strict=True)``, as a
reference checkpoint (``tools/export_torch_checkpoint.py``) does.

Value transforms: conv (kh, kw, I, O) -> (O, I, kh, kw); dense (I, O) ->
(O, I); BN/LN scale -> weight; ``batch_stats`` mean/var ->
``running_mean``/``running_var`` plus a zero ``num_batches_tracked``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _resnet_torch_name(parts) -> str:
    """``layer{s}_{b}`` -> ``layer{s}.{b}``, ``downsample_conv`` ->
    ``downsample.0``, ``downsample_bn`` -> ``downsample.1``."""
    out = []
    for p in parts:
        m = re.fullmatch(r"layer(\d)_(\d+)", p)
        if m:
            out.append(f"layer{m.group(1)}.{m.group(2)}")
        elif p == "downsample_conv":
            out.append("downsample.0")
        elif p == "downsample_bn":
            out.append("downsample.1")
        else:
            out.append(p)
    return ".".join(out)


# module-path fragment -> torch fragment
_RENAMES = [
    (re.compile(r"^backbone$"), "model"),
    (re.compile(r"^ResNet_0$"), "backbone"),
    (re.compile(r"^block_(\d+)$"), r"transformer_blocks.\1"),
    (re.compile(r"^fusion_(\d+)$"), r"transformer.\1"),
    (re.compile(r"^club_imaging$"), "CLUB_imaging"),
    (re.compile(r"^club_tabular$"), "CLUB_tabular"),
]

# sub-layer renames inside specific parents (``MLP``'s ``model``
# Sequential, Match ``head`` Sequential, lightly's SimCLR head, CLUB)
_MLP_HEAD_LEAF = {"fc1": "model.0", "fc2": "model.2"}
_SEQ_HEAD_LEAF = {"fc1": "0", "fc2": "2"}
_SIMCLR_LEAF = {"fc1": "layers.0", "fc2": "layers.2"}
_CLUB_LEAF = {"fc1": "p_mu.0", "fc2": "p_mu.2"}


def torch_module_name(path: Tuple[str, ...]) -> str:
    """Torch module path of a JAX module path."""
    parts = list(path)
    for i, p in enumerate(parts[:-1]):
        nxt = parts[i + 1]
        if p.startswith("projection_"):
            parts[i + 1] = _MLP_HEAD_LEAF.get(nxt, nxt)
        if p == "head":
            parts[i + 1] = _SEQ_HEAD_LEAF.get(nxt, nxt)
        if p in ("projector_multimodal", "projector_imaging",
                 "projector_tabular"):
            parts[i + 1] = _SIMCLR_LEAF.get(nxt, nxt)
        if p in ("club_imaging", "club_tabular"):
            parts[i + 1] = _CLUB_LEAF.get(nxt, nxt)
    renamed = []
    for p in parts:
        for pat, repl in _RENAMES:
            if pat.fullmatch(p):
                p = pat.sub(repl, p)
                break
        renamed.append(p)
    return _resnet_torch_name(renamed)


def flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(flatten(v, prefix + (str(k),)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def export_state_dict(params, batch_stats=None,
                      with_bn_counters: bool = True
                      ) -> Dict[str, np.ndarray]:
    """Reference-layout torch ``state_dict`` (numpy values) of a JAX
    ``params`` / ``batch_stats`` tree (nested mappings of arrays)."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in flatten(params).items():
        if "encoder_tabular" in path and any(
                p.startswith(("embeds", "pos_encodings", "con_mlp_"))
                or re.match(r"l\d+_", p) for p in path):
            raise NotImplementedError(
                "SAINT tabular encoders are not ported yet (ROADMAP.md)")
        *mods, leaf = path
        base = torch_module_name(tuple(mods))
        if leaf == "kernel":
            if v.ndim == 4:
                sd[base + ".weight"] = v.transpose(3, 2, 0, 1)
            elif v.ndim == 2:
                sd[base + ".weight"] = v.T
            else:
                sd[base + ".weight"] = v
        elif leaf == "bias":
            sd[base + ".bias"] = v
        elif leaf in ("scale", "embedding"):
            sd[base + ".weight"] = v
        else:  # tokens and other direct leaves share the torch name
            sd[(base + "." if base else "") + leaf] = v
    bn_bases = set()
    for path, v in flatten(batch_stats or {}).items():
        *mods, leaf = path
        base = torch_module_name(tuple(mods))
        sd[base + "." + {"mean": "running_mean",
                         "var": "running_var"}[leaf]] = v
        bn_bases.add(base)
    if with_bn_counters:
        for b in sorted(bn_bases):
            sd[b + ".num_batches_tracked"] = np.asarray(0, np.int64)
    return sd


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """``export_state_dict`` as torch tensors, ready for
    ``load_state_dict(strict=True)`` on the port's modules."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in export_state_dict(params, batch_stats).items()}


def train_state_from_jax(jax_state) -> Dict[str, object]:
    """The parts of a JAX ``STiLState`` a port train state holds, as
    torch tensors: ``net`` (params and batch_stats, ``state_dict`` of
    ``STiLNet``), ``ema`` (the EMA backbone's ``ema_params`` /
    ``ema_batch_stats``, ``state_dict`` of ``DisCoBackbone``, or None),
    ``prototypes``, ``prototypes_sum``, ``prototypes_count`` and ``da``
    (``(queue, ptr)`` or None). Optimizer moments are not carried."""
    def t(a):
        return torch.from_numpy(np.array(a))

    out = {"net": state_dict_from_jax(jax_state.params,
                                      jax_state.batch_stats), "ema": None}
    if jax_state.ema_params is not None:
        ema = state_dict_from_jax({"backbone": jax_state.ema_params},
                                  {"backbone": jax_state.ema_batch_stats})
        out["ema"] = {k[len("model."):]: v for k, v in ema.items()}
    for k in ("prototypes", "prototypes_sum", "prototypes_count"):
        out[k] = t(getattr(jax_state, k))
    da = jax_state.da
    out["da"] = None if da is None else (t(da.queue), int(np.asarray(da.ptr)))
    return out


def load_train_state(state, carried: Dict[str, object]) -> None:
    """Load :func:`train_state_from_jax`'s output into a port
    ``STiLState`` in place, strictly, keeping each tensor's dtype and
    device."""
    from stil_tta_torch.algorithms.base import DAState
    state.net.load_state_dict(carried["net"], strict=True)
    if state.ema is not None:
        state.ema.load_state_dict(carried["ema"], strict=True)
    for k in ("prototypes", "prototypes_sum", "prototypes_count"):
        old = getattr(state, k)
        setattr(state, k, carried[k].to(dtype=old.dtype, device=old.device))
    if state.da is not None:
        queue, ptr = carried["da"]
        state.da = DAState(queue.to(dtype=state.da.queue.dtype,
                                    device=state.da.queue.device), ptr)
