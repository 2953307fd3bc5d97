"""Spans and counters: the port's one tracing and counting mechanism.

``with span(name, **attrs):`` marks a layer boundary of the program
(prefill's ``embed``, ``layer``, ``attention``, ``ssm``, ``ssm.scan``,
``cache``, ``mlp`` or ``moe`` and ``head`` under the root ``prefill``; the
train step's ``train.forward``, ``train.backward`` and ``train.optimizer``
under the root ``train.step``).  A span records only while a torch
profiler records, of any activity (``torch.autograd._profiler_enabled``);
otherwise it is one shared null context and costs that check.  While
recording, a span

* opens a ``torch.profiler.record_function`` of its name, so that the
  profiler's own trace shows it over the kernels it launched;
* on closing, appends a ``Span`` to a ring of the last ``RING`` spans,
  which ``spans()`` returns: its name, id, parent's id, root's id, thread,
  start and end on ``time.time_ns()``'s clock (the clock on which the
  profiler stamps host and device events), and its attributes.

A span opened with no span open on its thread and no root open is a root:
every span of one request or one train step carries its root's id.  A
span opened on a thread with no open span while a root is open (remat's
recompute, which runs on autograd's device thread) takes that root's id,
and the innermost span open on the root's thread as its parent.

Span names are dotted lower case and never a function's name, so that a
profiler range named after a function is never confused with a span.

``count(name)`` adds to a counter, always, and ``counter(name)`` reads it:
``launches.matmul``, ``launches.causal_attention``,
``launches.causal_attention_bwd``, ``launches.wkv6``,
``launches.wkv6_bwd`` and ``launches.selective_scan`` count the
hand-written kernels' launches (``selective_scan``: a call of its three).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, NamedTuple

import torch
from torch.autograd import _profiler_enabled

RING = 1 << 16        # spans kept, the newest


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None          # the enclosing span's id; None for a root
    root: int                   # the root's id (its own for a root)
    thread: int                 # threading.get_ident() of the thread it ran on
    start_ns: int               # time.time_ns() before its profiler range opened
    end_ns: int                 # time.time_ns() after its profiler range closed
    attrs: dict[str, Any]


_ring: collections.deque[Span] = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_open: dict[int, list[_Recording]] = {}     # thread -> its open spans, innermost last
_roots: list[_Recording] = []               # open roots, newest last
_counts: collections.Counter[str] = collections.Counter()
_lock = threading.Lock()
_NULL = contextlib.nullcontext()


class _Recording:
    """One span while it is open."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "thread", "start", "range")

    def __init__(self, name: str, attrs: dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.thread = threading.get_ident()
        self.id = next(_ids)
        with _lock:
            stack = _open.setdefault(self.thread, [])
            if stack:
                self.parent, self.root = stack[-1].id, stack[-1].root
            elif _roots:
                outer = _roots[-1]
                self.parent, self.root = _open[outer.thread][-1].id, outer.id
            else:
                self.parent, self.root = None, self.id
                _roots.append(self)
            stack.append(self)
        self.start = time.time_ns()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.time_ns()
        with _lock:
            stack = _open[self.thread]
            stack.pop()
            if not stack:
                del _open[self.thread]
            if self.root == self.id:
                _roots.remove(self)
        _ring.append(Span(self.name, self.id, self.parent, self.root, self.thread, self.start, end, self.attrs))
        return False


def span(name: str, **attrs):
    """A context that records a span named ``name`` with ``attrs`` while a
    torch profiler records, and does nothing otherwise."""
    if not _profiler_enabled():
        return _NULL
    return _Recording(name, attrs)


def spans() -> list[Span]:
    """The ring's spans, oldest first (by when they closed); the ring is
    left as it is."""
    return list(_ring)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] += n


def counter(name: str) -> int:
    return _counts[name]
