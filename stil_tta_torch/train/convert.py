"""JAX variable tree -> reference-layout torch ``state_dict``, and a JAX
train state (``STiLState``, ``MatchState``) -> the port's train state.

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
``load_pretrained_encoders`` is the port's copy of the JAX package's
warm start of the encoders from a pretraining checkpoint, and
``save_encoder_checkpoint`` writes such a checkpoint from a backbone.

Value transforms: conv (kh, kw, I, O) -> (O, I, kh, kw); dense (I, O) ->
(O, I); BN/LN scale -> weight; ``batch_stats`` mean/var ->
``running_mean``/``running_var`` plus a zero ``num_batches_tracked``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from stil_tta_torch.train.optim import ENCODERS


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
                         "(algorithm_name=STiL_SAINT or "
                         "CoTrain_Pseudo_SAINT)")
    keys = list(encoder.state_dict())
    missing = [k for k in keys if k not in state_dict]
    if missing:
        raise KeyError(f"SAINT state_dict lacks {missing[:5]}")
    encoder.load_state_dict({k: torch.as_tensor(np.asarray(state_dict[k]))
                             for k in keys}, strict=True)
    return len(keys)


def save_encoder_checkpoint(backbone: torch.nn.Module, path) -> Path:
    """Write the ``encoder_imaging`` and ``encoder_tabular`` of
    ``backbone`` as a pretraining checkpoint in the TIP layout
    (``{"state_dict": {"encoder_imaging.*": ..., "encoder_tabular.*":
    ...}}``), the file that :func:`load_pretrained_encoders` reads;
    returns its path."""
    sd = {f"{sub}.{k}": v.detach().cpu().clone()
          for sub in ENCODERS
          for k, v in getattr(backbone, sub).state_dict().items()}
    path = Path(path)
    torch.save({"state_dict": sd}, path)
    return path


def load_pretrained_encoders(net: torch.nn.Module, ckpt_path) -> None:
    """The warm start of ``stil_tta_tpu/train/convert.py:206-241``: fill
    the backbone's (``net.model``) image and tabular encoders from a torch
    checkpoint by key prefix, leaving out ``projection_head`` and
    ``prototypes`` keys. Every parameter and BN running statistic of the
    two encoders must be in the file (``KeyError`` otherwise, a shape
    mismatch is a ``ValueError``); other keys are left over, as under
    ``strict=False``. The BN counters ``num_batches_tracked`` are not
    read (the JAX state has none). Prints ``Loaded n/N torch keys for
    <prefix>`` for each encoder, N the file's keys under the prefix and
    n those used or not counted as left over, as the JAX package does.
    Only the student is filled: an EMA teacher keeps its weights.
    ``ValueError`` where the JAX package fails: a net with no backbone
    (``ImagingNet``, ``TabularNet``: no ``backbone`` subtree) and a SAINT
    tabular encoder (its generic key walk looks for keys that no SAINT
    checkpoint has; ``checkpoint_SAINT`` loads SAINT weights)."""
    from stil_tta_torch.models.saint import SAINTEncoder
    backbone = getattr(net, "model", None)
    if backbone is None or not all(isinstance(getattr(backbone, s, None),
                                              torch.nn.Module)
                                   for s in ENCODERS):
        raise ValueError(
            f"a .ckpt/.pth warm start fills net.model.encoder_imaging and "
            f".encoder_tabular; {type(net).__name__} has no such backbone")
    if isinstance(backbone.encoder_tabular, SAINTEncoder):
        raise ValueError("a .ckpt/.pth warm start of a SAINT tabular "
                         "encoder is not supported; use checkpoint_SAINT")
    sd = {k: v for k, v in load_torch_state_dict(ckpt_path).items()
          if "projection_head" not in k and "prototypes" not in k}
    for sub in ENCODERS:
        prefix = sub + "."
        part = {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
        module = getattr(backbone, sub)
        new = {}
        for key, own in module.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            if key not in part:
                raise KeyError(f"torch checkpoint missing key: {prefix}{key}")
            if part[key].shape != own.shape:
                raise ValueError(
                    f"shape mismatch at {prefix}{key}: torch "
                    f"{tuple(part[key].shape)} vs {tuple(own.shape)}")
            new[key] = part[key]
        module.load_state_dict(new, strict=False)
        leftovers = [k for k in part if k not in new
                     and "num_batches_tracked" not in k
                     and not saint_inert_key(k)]
        print(f"Loaded {len(part) - len(leftovers)}/{len(part)} torch keys "
              f"for {prefix}")


def _is_position(v) -> bool:
    """An integer scalar of a JAX ``extra``: a write position or a
    length, an int in the port (FreeMatch's float scalar ``time_p`` stays
    a tensor)."""
    a = np.asarray(v)
    return a.ndim == 0 and np.issubdtype(a.dtype, np.integer)


def train_state_from_jax(jax_state) -> Dict[str, object]:
    """The parts of a JAX train state a port train state holds, as torch
    tensors: ``net`` (params and batch_stats, ``state_dict`` of the net),
    ``ema`` (the EMA backbone's ``ema_params`` / ``ema_batch_stats`` as
    the ``state_dict`` of the backbone, or None) and ``da`` (``(queue,
    ptr)`` or None); of a ``STiLState`` also ``prototypes``,
    ``prototypes_sum`` and ``prototypes_count``; of a ``MatchState``
    ``extra`` (its buffers; write positions and lengths as ints). STiL's
    EMA tree is the backbone's; a ``MatchState``'s mirrors the whole net,
    ``{"backbone": ...}`` for the backbone nets and top-level for
    ``ImagingNet``, which is wrapped the same way here, so either loads
    into the port's teacher (``match_common.ema_source``). Optimizer
    moments are not carried."""
    def t(a):
        return torch.from_numpy(np.array(a))

    out = {"net": state_dict_from_jax(jax_state.params,
                                      jax_state.batch_stats), "ema": None}
    if jax_state.ema_params is not None:
        ema_p, ema_bs = jax_state.ema_params, jax_state.ema_batch_stats
        if "backbone" not in ema_p:
            ema_p, ema_bs = {"backbone": ema_p}, {"backbone": ema_bs}
        ema = state_dict_from_jax(ema_p, ema_bs)
        out["ema"] = {k[len("model."):]: v for k, v in ema.items()}
    if hasattr(jax_state, "extra"):
        out["extra"] = {k: (int(np.asarray(v)) if _is_position(v)
                            else t(v))
                        for k, v in (jax_state.extra or {}).items()}
    else:
        for k in ("prototypes", "prototypes_sum", "prototypes_count"):
            out[k] = t(getattr(jax_state, k))
    da = jax_state.da
    out["da"] = None if da is None else (t(da.queue), int(np.asarray(da.ptr)))
    return out


def load_train_state(state, carried: Dict[str, object]) -> None:
    """Load :func:`train_state_from_jax`'s output into a port train state
    (``STiLState`` or ``MatchState``) in place, strictly, keeping each
    tensor's dtype and device; the state's buffers are copies, so one
    ``carried`` can start several states."""
    from stil_tta_torch.algorithms.base import DAState

    def like(new, old):   # a copy: the steps update buffers in place
        return new.to(dtype=old.dtype, device=old.device, copy=True)

    state.net.load_state_dict(carried["net"], strict=True)
    if state.ema is not None:
        state.ema.load_state_dict(carried["ema"], strict=True)
    if "extra" in carried:
        if set(carried["extra"]) != set(state.extra):
            raise KeyError(f"extra buffers {sorted(carried['extra'])} do "
                           f"not match the state's {sorted(state.extra)}")
        # a position carried as an int becomes the state's 0-dim int64
        # tensor on its device, which the steps advance in place
        state.extra = {k: (torch.tensor(v, dtype=torch.long,
                                        device=state.extra[k].device)
                           if isinstance(v, int) else like(v, state.extra[k]))
                       for k, v in carried["extra"].items()}
    else:
        for k in ("prototypes", "prototypes_sum", "prototypes_count"):
            setattr(state, k, like(carried[k], getattr(state, k)))
    if state.da is not None:
        queue, ptr = carried["da"]
        state.da = DAState(like(queue, state.da.queue),
                           torch.tensor(int(ptr), dtype=torch.long,
                                        device=state.da.ptr.device))
