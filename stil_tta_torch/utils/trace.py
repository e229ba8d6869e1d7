"""Program spans: named host-time ranges at the port's layer boundaries,
kept while a ``torch.profiler`` session is active.

``with span("train.step"):`` keeps ``(name, start_ns, end_ns, parent)``
in a bounded buffer (:func:`spans`), where ``parent`` is the index of the
enclosing span, or -1, and enters ``torch.profiler.record_function(name)``
inside it, so a profile with CPU activity shows the span as a range by
its name (a profile of CUDA activity alone, as the benchmark's traced
window, shows none). Start and end are ``time.time_ns()``, the clock of
the profiler's Kineto events. Outside a profiler session a span reads
one flag and does nothing; there is no other switch. Nothing here calls
the CUDA runtime.

The spans, each at one layer boundary:

- ``train.step``: one eager train step of any family
  (:func:`traced` around what ``make_train_step`` returns); a replayed
  CUDA graph runs no Python and records nothing;
- ``tta.step``: one Tent, EATA or SAR step (``tta/tent.py``,
  ``tta/methods.py``);
- ``eval.batch``: one eval step call of ``run_validation``'s enqueue loop;
- ``eval.metrics``: ``run_validation``'s host reduction after its
  read-back (concatenation, accuracy, AUROC, loss means);
- ``dp.all_reduce``, ``dp.all_gather``: the data-parallel collectives.

No name starts with ``cuda`` or ``cuLaunch`` or holds ``Launch``: the
benchmark's trace reduction counts such names as CUDA runtime calls.
``GraphedStep`` captures inside :func:`suspended`: a capture records
nothing. The spans nest on the calling thread; the buffer is the
process's, emptied by :func:`clear`.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, List, Tuple

import torch
import torch.autograd.profiler as _profiler

LIMIT = 1 << 20            # records kept; later spans are counted in dropped

_records: List[list] = []  # [name, start_ns, end_ns, parent]
_open: List[int] = []      # indices of the spans entered and not left
_suspended = 0
dropped = 0


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("record", "rf")

    def __init__(self, name: str):
        self.record = [name, 0, None, _open[-1] if _open else -1]
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        _open.append(len(_records))
        _records.append(self.record)
        self.record[1] = time.time_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.record[2] = time.time_ns()
        if _open:
            _open.pop()
        return False


def span(name: str):
    """A context manager that records ``name``'s host time while a
    profiler session is active; a shared no-op otherwise, and while
    :func:`suspended` or the buffer is full (counted in ``dropped``)."""
    global dropped
    if _suspended or not _profiler._is_profiler_enabled:
        return _NULL
    if len(_records) >= LIMIT:
        dropped += 1
        return _NULL
    return _Span(name)


def traced(name: str, fn: Callable) -> Callable:
    """``fn`` with each call inside ``span(name)``."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def suspended():
    """Inside, no span records (a CUDA graph capture)."""
    global _suspended
    _suspended += 1
    try:
        yield
    finally:
        _suspended -= 1


def spans() -> List[Tuple[str, int, int, int]]:
    """A copy of the kept records, ``(name, start_ns, end_ns, parent)``
    in the order the spans were entered (``end_ns`` None while open)."""
    return [tuple(r) for r in _records]


def clear() -> None:
    """Empty the buffer and the ``dropped`` count (outside any span)."""
    global dropped
    _records.clear()
    _open.clear()
    dropped = 0
