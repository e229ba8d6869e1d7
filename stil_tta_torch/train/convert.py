"""JAX variable tree -> reference-layout torch ``state_dict``, and a JAX
``STiLState`` -> the port's train state.

The port's own copy of
``stil_tta_tpu/train/convert.py:export_torch_state_dict`` (the SAINT
encoder's paths included: its leaves go to the somepago/saint layout,
the vectorised per-column MLPs split into ``simple_MLP.{i}.layers.{0,
2}.*``), ``export_saint_state_dict`` and the key mapping. The port's
modules carry the reference's torch key names, so the output loads into
them with ``load_state_dict(strict=True)``, as a reference checkpoint
(``tools/export_torch_checkpoint.py``) does. ``load_saint_state_dict``
loads a somepago/saint-layout ``.pth`` (the reference's
``checkpoint_SAINT``) into the port's SAINT encoder.

Value transforms: conv (kh, kw, I, O) -> (O, I, kh, kw); dense (I, O) ->
(O, I); BN/LN scale -> weight; ``batch_stats`` mean/var ->
``running_mean``/``running_var`` plus a zero ``num_batches_tracked``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

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


_SAINT_HEADS = ("embeds", "pos_encodings")

# SAINT state entries that never take part in the backbone's forward (the
# JAX package's ``_SAINT_INERT``): SAINT's pretraining heads and mask
# embeddings, its offset buffers (recomputed from the field lengths), and
# the wrapper's ``cls_token``, a float cast ``.long()`` as category 0
_SAINT_INERT = re.compile(
    r"(^(model\.)?cls_token$"
    r"|(^|\.)encoder_tabular\.(mask_embeds_cat|mask_embeds_cont"
    r"|single_mask|mlp|mlp1|mlp2|mlpfory|pt_mlp|pt_mlp2|norm"
    r"|categories_offset|cat_mask_offset|con_mask_offset"
    r"|transformer\.embeds|transformer\.mask_embed)(\.|$))")


def saint_inert_key(key: str) -> bool:
    """True for a key of a reference checkpoint that is SAINT state the
    forward never reads."""
    return bool(_SAINT_INERT.search(key))


def _saint_torch_key(path) -> Tuple[str, bool]:
    """A SAINT transformer leaf's somepago/saint key and whether its value
    is transposed: ``l{d}_{norm,attn,ff}{,_ff}_{col,row}`` -> slot 0-3 of
    ``transformer.layers.{d}``, each ``PreNorm(norm, Residual(fn))``."""
    mm = re.match(r"l(\d+)_(.+)", path[0]) or re.match(
        r"l(\d+)_(.+)", path[-2] if len(path) >= 2 else path[-1])
    if mm is None:
        raise KeyError(f"unmapped SAINT leaf {'/'.join(path)}")
    kind = mm.group(2)
    slot = {"norm_col": 0, "attn_col": 0, "ff_col": 1, "norm_ff_col": 1,
            "norm_row": 2, "attn_row": 2, "ff_row": 3,
            "norm_ff_row": 3}[kind]
    base = f"transformer.layers.{int(mm.group(1))}.{slot}"
    leaf = path[-1]
    if kind.startswith("norm"):
        return base + ".norm." + ("weight" if leaf == "scale"
                                  else "bias"), False
    sub = path[-2] if kind.startswith("attn") else {
        "fc1": "net.0", "fc2": "net.3"}[path[-2]]
    return (f"{base}.fn.fn.{sub}." + ("weight" if leaf == "kernel"
                                      else "bias"), leaf == "kernel")


def _saint_export_leaf(path, v):
    """(torch key, value) pairs of one SAINT encoder leaf."""
    if path[-2:] == ("embeds", "embedding"):
        yield "embeds.weight", v
    elif path[-2:] == ("pos_encodings", "embedding"):
        yield "pos_encodings.weight", v
    elif path[-1].startswith("con_mlp_"):
        leaf = {"con_mlp_w1": "layers.0.weight", "con_mlp_b1":
                "layers.0.bias", "con_mlp_w2": "layers.2.weight",
                "con_mlp_b2": "layers.2.bias"}[path[-1]]
        for i in range(v.shape[0]):
            yield (f"simple_MLP.{i}.{leaf}",
                   v[i].T if leaf.endswith("weight") else v[i])
    else:
        key, transpose = _saint_torch_key(path)
        yield key, (v.T if transpose else v)


def _saint_subpath(path) -> Tuple[Optional[str], Optional[tuple]]:
    """(torch prefix, path inside the encoder) of a leaf of a SAINT
    encoder under ``encoder_tabular``, else (None, None). SAINT's leaf
    names are disjoint from the tabular transformer's."""
    if "encoder_tabular" not in path:
        return None, None
    i = list(path).index("encoder_tabular")
    rel = tuple(path[i + 1:])
    if rel and (rel[0] in _SAINT_HEADS or rel[0].startswith("con_mlp_")
                or re.match(r"l\d+_", rel[0])):
        return torch_module_name(tuple(path[:i + 1])) + ".", rel
    return None, None


def export_saint_state_dict(params) -> Dict[str, np.ndarray]:
    """The somepago/saint-layout ``state_dict`` (numpy values) of a JAX
    SAINT encoder's ``params``."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in flatten(params).items():
        sd.update(_saint_export_leaf(path, v))
    return sd


def export_state_dict(params, batch_stats=None,
                      with_bn_counters: bool = True
                      ) -> Dict[str, np.ndarray]:
    """Reference-layout torch ``state_dict`` (numpy values) of a JAX
    ``params`` / ``batch_stats`` tree (nested mappings of arrays)."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in flatten(params).items():
        saint_prefix, saint_rel = _saint_subpath(path)
        if saint_prefix is not None:
            for k, sv in _saint_export_leaf(saint_rel, v):
                sd[saint_prefix + k] = sv
            continue
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


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.pth`` / ``.ckpt`` (its ``state_dict`` entry,
    or the file itself), on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_saint_state_dict(encoder: torch.nn.Module,
                          state_dict: Mapping[str, object]) -> int:
    """Load a somepago/saint-layout ``state_dict`` (the reference's
    ``checkpoint_SAINT`` file) into the port's SAINT encoder, strictly
    over the keys the encoder has; SAINT's other entries (pretraining
    heads, mask embeddings) are left out, as the JAX package's
    ``load_saint_state_dict`` leaves them. Returns the number of tensors
    used."""
    from stil_tta_torch.models.saint import SAINTEncoder
    if not isinstance(encoder, SAINTEncoder):
        raise ValueError("checkpoint_SAINT needs a SAINT tabular encoder "
                         "(algorithm_name=STiL_SAINT)")
    keys = list(encoder.state_dict())
    missing = [k for k in keys if k not in state_dict]
    if missing:
        raise KeyError(f"SAINT state_dict lacks {missing[:5]}")
    encoder.load_state_dict({k: torch.as_tensor(np.asarray(state_dict[k]))
                             for k in keys}, strict=True)
    return len(keys)


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
