"""Spans, counters and device traces of the port.

`span(name)` names a block of host work; it is a context manager and a
decorator for functions and methods.  While recording is off it costs one
flag check.  Recording is on while a torch profiler records in this
process, and inside `recording()`.  While it is on, a span opens a profiler
range of its name when a profiler records, so it lands in any device trace
(Chrome trace, Perfetto), and on closing appends one `Span` to a bounded
in-memory buffer (`spans()`; the oldest go first once it is full, and
readers select spans by time, so nothing resets it).  A `Span` holds:
  id, call   its own id, and the id shared by every span of one public call:
             a span opened with no span open (on its thread) is a root and
             starts a call;
  parent     the id of the span it was opened in, or None;
  name;
  t0_ns, t1_ns  `time.time_ns()` read outside the profiler range: Unix-
             epoch nanoseconds, the clock of the profiler's events;
  counts     the counters added while it was the innermost open span.
Self time is a span's duration less its children's (`self_ns`).

The profiler range is a function-scope range (`_RecordFunctionFast`, the
trace's `cpu_op` category), not a user annotation (`record_function`, the
`user_annotation` category).  The profiler mirrors each user annotation that
holds a kernel's launch onto the device's timeline; the port's ranges add
none there, so the innermost user annotation holding a launch stays the
caller's, and a caller's device trace reads as it would without the port's
spans.

`recording(sync=True)` is the blocking protocol: a device sync at both ends
of each span, so that a span's time covers the device work it queued.

`count(name, n)` adds n to a process-wide total always (`total`,
`totals`): plain integers, no device work.  While recording is on it also
adds n to the innermost open span.

Names in use: `codec:<call>` the codec's public calls, `frag:<fragment>`
the model fragments, `coder:<phase>` the coder's phases, `glue:<step>` the
codec's own steps between them, `sync:<where>` the points where the host
waits on the card, `mask:rank` and `rem:refine`; the counters
`launch:<kernel or route>`, `words:payload` and `words:escape`.

`device_trace` records a `torch.profiler` trace (CPU activity, and CUDA
activity when a card is present) and writes it to `log_dir` as a Chrome
trace.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time

import torch

TRACE_FILE = "trace.json"
BUFFER_SPANS = 1 << 20

_profiler_enabled = torch._C._autograd._profiler_enabled
_depth = 0  # open recording() blocks
_sync = 0  # open recording(sync=True) blocks
_buffer: collections.deque = collections.deque(maxlen=BUFFER_SPANS)
_totals: collections.Counter = collections.Counter()
_ids = itertools.count(1)


class _Open(threading.local):
    def __init__(self):
        self.stack: list = []


_open = _Open()


class Span:
    """One closed span (see the module's docstring)."""

    __slots__ = ("id", "call", "parent", "name", "t0_ns", "t1_ns", "counts")

    def __init__(self, id_: int, call: int, parent: int | None, name: str):
        self.id, self.call, self.parent, self.name = id_, call, parent, name
        self.t0_ns = self.t1_ns = 0
        self.counts: dict = {}


def on() -> bool:
    """Whether spans and per-span counts are being recorded."""
    return bool(_depth) or _profiler_enabled()


def _device_sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class span:
    """A named span: `with span("glue:cat"): ...`, or `@span("frag:analyze")`
    on a function or method."""

    __slots__ = ("name", "_rec", "_range")

    def __init__(self, name: str):
        self.name = name
        self._rec = None

    def __enter__(self):
        if _depth or _profiler_enabled():
            stack = _open.stack
            parent = stack[-1] if stack else None
            i = next(_ids)
            rec = Span(i, parent.call if parent else i, parent.id if parent else None, self.name)
            if _sync:
                _device_sync()
            rec.t0_ns = time.time_ns()
            self._range = None
            if _profiler_enabled():
                self._range = torch._C._profiler._RecordFunctionFast(self.name)
                self._range.__enter__()
            stack.append(rec)
            self._rec = rec
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            _open.stack.pop()
            if self._range is not None:
                self._range.__exit__(None, None, None)
            if _sync:
                _device_sync()
            rec.t1_ns = time.time_ns()
            _buffer.append(rec)
            self._rec = None
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not (_depth or _profiler_enabled()):
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)

        return run


@contextlib.contextmanager
def recording(sync: bool = False):
    """Record spans while the block runs, without a profiler; with `sync`, a
    device sync at both ends of each span (the blocking protocol)."""
    global _depth, _sync
    _depth += 1
    _sync += bool(sync)
    try:
        yield
    finally:
        _depth -= 1
        _sync -= bool(sync)


def count(name: str, n: int = 1) -> None:
    """Add n to the total of `name`, and to the innermost open span while
    recording."""
    _totals[name] += n
    if _depth or _profiler_enabled():
        stack = _open.stack
        if stack:
            c = stack[-1].counts
            c[name] = c.get(name, 0) + n


def total(name: str) -> int:
    """The process-wide total of a counter."""
    return _totals[name]


def totals() -> dict:
    """Every counter's process-wide total."""
    return dict(_totals)


def spans() -> list:
    """The buffered spans, oldest first."""
    return list(_buffer)


def open_spans() -> list:
    """The names of this thread's open spans, outermost first."""
    return [s.name for s in _open.stack]


def self_ns(recs) -> dict:
    """{span id: its duration less its children's among `recs`}."""
    out = {s.id: s.t1_ns - s.t0_ns for s in recs}
    for s in recs:
        if s.parent in out:
            out[s.parent] -= s.t1_ns - s.t0_ns
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block and write `log_dir/trace.json` (Chrome trace
    format; open it in chrome://tracing or Perfetto).  Yields the profiler,
    whose `key_averages()` sums the time by operation and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
