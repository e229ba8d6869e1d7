"""Multi-step dispatch (``steps_per_dispatch``): K train steps for one host
dispatch, the port of ``stil_tta_tpu/train/multistep.py``.

The JAX package scans K steps in one jitted program (``lax.scan``), so the
host ships one (K, B) index block and makes one call for K steps. On the
card the port does the same with a CUDA graph: :class:`GraphedStep`
captures one train step (the views, the forward and backward with both BN
kernels, Adam, the EMA teacher and every buffer) and replays it K times a
dispatch. One step is captured rather than K unrolled: the graph's memory
pool then holds one step's tensors, and one graph serves blocks and epochs
of any length. Each replay's inputs reach the graph's static buffers by a
device-to-device copy from the block, which comes to the card once a
dispatch. Every family of the registry is captured, single-batch or
micro-batched (``micro_batches > 1``: the chunk loop is a fixed Python
loop, so one capture holds all m chunks). Everywhere else (the CPU,
STiL's ``teacher_int8``, a data-parallel mesh) :class:`EagerSteps` runs
a dispatch's K steps one by one.
:func:`choose_route` picks the route from the config before anything is
captured. Either way a dispatch leaves the state of K single steps: the
captured step is the eager step, and its replays read the learning rate,
the epoch's gates (``set_epoch``), the generators and every buffer and
write position where the eager step keeps them. A run on the graph route builds its optimizer
``capturable`` from the start (``train/optim.py``), so its eager steps
(the warm-up, the tail) do the replays' arithmetic; every other run keeps
the optimizer it always had.

Capture needs a step that ran eagerly first (lazy optimizer state, cuBLAS
workspaces, the plans of the BN kernels): that warm-up is the first step
of the first dispatch, a real step of the run, and the capture then
replays the dispatch's other K - 1 steps. A failure to capture or to
replay raises; nothing falls back to eager steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from stil_tta_torch.ops.batch_norm import BNTrain, bn_bwd_reduce, bn_stats
from stil_tta_torch.parallel import collectives

Tensor = torch.Tensor

# host-side counters that a step advances where it launches: a replay
# launches without Python, so each replay adds what the captured step
# added
COUNTERS = ((bn_stats, "launches"), (bn_bwd_reduce, "launches"),
            (BNTrain, "dy_copies"))


def chunk_indices(pairs, k: int):
    """Group an iterable of (idx_l, idx_u) into ((K, Bl), (K, Bu)) blocks
    and a list of the leftover single pairs (the JAX package's
    ``chunk_indices``)."""
    pairs = list(pairs)
    blocks = []
    n_full = len(pairs) // k
    for i in range(n_full):
        chunk = pairs[i * k:(i + 1) * k]
        blocks.append((np.stack([c[0] for c in chunk]),
                       np.stack([c[1] for c in chunk])))
    return blocks, pairs[n_full * k:]


def choose_route(algo_cls, cfg, device) -> Tuple[str, str]:
    """``("graph", why)`` when a dispatch of ``algo_cls`` (an algorithm
    class) under ``cfg`` replays a captured step, else ``("eager",
    why)``. The class says whether its step can be captured under
    ``cfg`` (``graph_unsafe(cfg)``: None, or the reason it cannot; a class
    without it is never captured); the route also needs a card and no
    data-parallel mesh."""
    name = str(cfg.algorithm_name)
    if torch.device(device).type != "cuda":
        return "eager", "not on a CUDA card"
    graph_unsafe = getattr(algo_cls, "graph_unsafe", None)
    if graph_unsafe is None:
        return "eager", f"{name}'s step is not captured"
    why = graph_unsafe(cfg)
    if why is not None:
        return "eager", why
    if collectives.active_mesh() is not None:
        return "eager", "a data-parallel mesh (its collectives are host calls)"
    kind = "micro-batched" if int(cfg.micro_batches or 1) > 1 \
        else "single-batch"
    return "graph", f"{name}'s {kind} step, one CUDA graph replayed"


class EagerSteps:
    """A dispatch of K steps as K calls of ``step``."""

    route = "eager"

    def __init__(self, step):
        self.step = step

    def __call__(self, state, rows: Sequence[tuple], epoch: int):
        """``rows``: the K steps' ``(cache_l, cache_u, idx_l, idx_u)``."""
        for args in rows:
            self.step(state, *args, epoch)
        return state


def state_tensors(state) -> Dict[str, Tensor]:
    """Every tensor a train state holds by name: the nets' parameters and
    buffers, the optimizer's state and tensor learning rates, the buffers
    and metric states (the gradients are the step's own)."""
    out: Dict[str, Tensor] = {}

    def visit(name: str, obj) -> None:
        if isinstance(obj, Tensor):
            out[name] = obj
        elif isinstance(obj, nn.Module):
            for k, t in obj.named_parameters():
                out[f"{name}.{k}"] = t
            for k, t in obj.named_buffers():
                out[f"{name}.{k}"] = t
        elif isinstance(obj, torch.optim.Optimizer):
            for i, st in enumerate(obj.state.values()):
                visit(f"{name}.state{i}", st)
            for i, group in enumerate(obj.param_groups):
                visit(f"{name}.group{i}.lr", group["lr"])
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                visit(f"{name}.{f.name}", getattr(obj, f.name))
        elif isinstance(obj, dict):
            for k, v in obj.items():
                visit(f"{name}.{k}", v)

    visit("state", state)
    return out


def _host_values(state) -> Dict[str, object]:
    """The numbers a train state holds on the host by name (ints and
    floats in its fields and dicts; ``step`` aside, which the dispatcher
    advances)."""
    out: Dict[str, object] = {}

    def visit(name: str, obj) -> None:
        if isinstance(obj, (bool, int, float)):
            out[name] = obj
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                if f.name != "step":
                    visit(f"{name}.{f.name}", getattr(obj, f.name))
        elif isinstance(obj, dict):
            for k, v in obj.items():
                visit(f"{name}.{k}", v)

    visit("state", state)
    return out


def _addresses(state) -> Dict[str, int]:
    return {k: t.data_ptr() for k, t in state_tensors(state).items()}


class GraphedStep:
    """A dispatch of K steps as K replays of one captured ``step`` of
    ``algo`` (an algorithm with ``set_epoch``, whose step is graph-safe:
    ``algorithms/stil.py``, ``algorithms/match_common.py``).

    The first call runs its first row eagerly (the warm-up), captures the
    step on a side stream and replays the rest. ``rows`` are the K steps'
    ``(cache_l, cache_u, idx_l, idx_u)``; a tensor that is the same object
    in every row (a device cache, a corruption marginal, an ``arange``) is
    read where it lies, and the graph keeps a static buffer for each of
    the others, filled by a device-to-device copy before each replay.
    Before each dispatch the algorithm's ``set_epoch`` writes the epoch's
    gates (STiL's pseudo-label gate, a family's loss gate); ``state.step``
    advances by one a replay, and so do the counters of :data:`COUNTERS`
    by what the captured step added (``per_replay``). The state's
    generator is registered with the graph, so each replay draws the
    numbers an eager step would; the default generator (dropout) is
    registered by the capture itself.

    Raises ``RuntimeError`` when the optimizer is not capturable or holds
    a number for a learning rate that the schedule moves (a capture would
    bake it in), when the capture fails, when the captured step rebinds a
    state tensor (the graph would then read a stale one) or changes a
    number the state holds on the host (a replay would not), and when a
    later
    dispatch's state, fixed inputs or input shapes differ from the
    captured ones. ``capture_s`` and ``pool_bytes`` (device
    memory the capture reserved) are set by the capture."""

    route = "graph"

    def __init__(self, algo, step):
        self.algo, self.step = algo, step
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.treedef = None
        self.leaves: List[Optional[Tensor]] = []   # fixed inputs, by slot
        self.static: List[Optional[Tensor]] = []   # buffers of the others
        self.addresses: Dict[str, int] = {}
        self.per_replay: Dict[Tuple[object, str], int] = {}
        self.capture_s = 0.0
        self.pool_bytes = 0

    @property
    def launches_per_replay(self) -> Dict[str, int]:
        return {getattr(owner, "__name__", str(owner)) + "." + attr: n
                for (owner, attr), n in self.per_replay.items()}

    def __call__(self, state, rows: Sequence[tuple], epoch: int):
        flat = [pytree.tree_flatten(tuple(args)) for args in rows]
        if any(spec != flat[0][1] for _, spec in flat):
            raise ValueError("GraphedStep: the rows of a dispatch differ in "
                             "structure")
        self.algo.set_epoch(epoch)
        if self.graph is None:
            self.step(state, *rows[0], epoch)   # the warm-up: a real step
            self._capture(state, flat, epoch)
            flat = flat[1:]
        else:
            self._check(state, flat)
        for leaves, _ in flat:
            for buf, leaf in zip(self.static, leaves):
                if buf is not None:
                    buf.copy_(leaf, non_blocking=True)
            self.graph.replay()
            state.step += 1
            for (owner, attr), n in self.per_replay.items():
                setattr(owner, attr, getattr(owner, attr) + n)
        return state

    def _capture(self, state, flat, epoch: int) -> None:
        require_capturable(state.optimizer)
        leaves0, self.treedef = flat[0]
        fixed = [all(leaves[i] is leaf for leaves, _ in flat)
                 for i, leaf in enumerate(leaves0)]
        self.leaves = [leaf if f else None for leaf, f in zip(leaves0, fixed)]
        self.static = [None if f or not isinstance(leaf, Tensor)
                       else torch.empty_like(leaf)
                       for leaf, f in zip(leaves0, fixed)]
        for i, (leaf, buf) in enumerate(zip(leaves0, self.static)):
            if buf is None and not fixed[i]:
                raise ValueError(f"GraphedStep: input {i} ({type(leaf)}) "
                                 "changes from step to step but is not a "
                                 "tensor")
        args = pytree.tree_unflatten(
            [buf if buf is not None else leaf
             for buf, leaf in zip(self.static, self.leaves)], self.treedef)
        device = self.algo.device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        if state.generator.device.type == "cuda":
            graph.register_generator_state(state.generator)
        counts = {c: getattr(*c) for c in COUNTERS}
        step0 = state.step
        before = _addresses(state)
        host_before = _host_values(state)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self.step(state, *args, epoch)
        except BaseException:
            _end_generator_capture(state.generator, stream)
            raise
        finally:
            state.step = step0
            for c, n in counts.items():   # the capture launched nothing
                self.per_replay[c] = getattr(*c) - n
                setattr(*c, n)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        after = _addresses(state)
        moved = [k for k in before if after.get(k) != before[k]]
        if moved or set(after) != set(before):
            raise RuntimeError(
                "GraphedStep: the captured step rebinds state tensors "
                f"{(moved or sorted(set(after) ^ set(before)))[:5]}; a "
                "replay would read stale ones")
        host_after = _host_values(state)
        changed = [k for k in host_before
                   if host_after.get(k) != host_before[k]]
        if changed:
            raise RuntimeError(
                f"GraphedStep: the captured step changes host values "
                f"{changed[:5]}; a replay would not")
        self.addresses = after
        self.graph = graph

    def _check(self, state, flat) -> None:
        """The state and the fixed inputs the graph reads, and the shapes
        of the copied ones, are those of the capture."""
        require_capturable(state.optimizer)
        if _addresses(state) != self.addresses:
            raise RuntimeError("GraphedStep: a state tensor was replaced "
                               "since the capture")
        for leaves, spec in flat:
            if spec != self.treedef:
                raise ValueError("GraphedStep: the inputs' structure "
                                 "differs from the captured step's")
            for i, leaf in enumerate(leaves):
                buf = self.static[i]
                if buf is None:
                    if leaf is not self.leaves[i]:
                        raise ValueError(f"GraphedStep: input {i} is not the "
                                         "one the graph was captured with")
                elif leaf.shape != buf.shape or leaf.dtype != buf.dtype:
                    raise ValueError(
                        f"GraphedStep: input {i} is {tuple(leaf.shape)} "
                        f"{leaf.dtype}, captured {tuple(buf.shape)} "
                        f"{buf.dtype}")


def require_capturable(opt: torch.optim.Optimizer) -> None:
    """Raise unless every param group of ``opt`` is ``capturable`` and
    every group but a ``frozen`` one (whose learning rate stays 0) holds
    its learning rate in a tensor, which a replay reads."""
    for i, group in enumerate(opt.param_groups):
        if not group.get("capturable"):
            raise RuntimeError(f"GraphedStep: param group {i} of the "
                               "optimizer is not capturable")
        if not group.get("frozen") and not isinstance(group["lr"], Tensor):
            raise RuntimeError(
                f"GraphedStep: param group {i}'s learning rate is the number "
                f"{group['lr']!r}, which a capture would bake in")


def _end_generator_capture(generator: torch.Generator,
                           stream: torch.cuda.Stream) -> None:
    """A capture that fails leaves the generators it registered (the
    state's and the default one) in capture mode, and every later draw
    then raises: one more capture that succeeds, of a fill, ends it. The
    generators' offsets stay as they were; the graph is dropped."""
    buf = torch.empty(1, device=stream.device)
    graph = torch.cuda.CUDAGraph()
    if generator.device.type == "cuda":
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=stream):
        buf.zero_()


def make_dispatcher(cfg, algo, step):
    """The dispatcher of ``choose_route``'s route for ``algo``'s ``step``,
    and the reason for the route."""
    route, why = choose_route(type(algo), cfg, algo.device)
    if route == "graph":
        return GraphedStep(algo, step), why
    return EagerSteps(step), why
