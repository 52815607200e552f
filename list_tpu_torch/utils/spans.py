"""Spans and counters of the program's phases, on the profiler's clock.

A span names one phase of a training step or of a mesh request
(``step.forward``, ``decode.percep``, ...).  ``with span(name, device):``
records, while recording is on:

- a ``torch.profiler.record_function(name)``, so that the phase sits on
  the profiler's timeline beside the device trace;
- its host start and end (``time.perf_counter``);
- its parent (the enclosing span on this thread, or ``parent=``, a span
  another thread opened) and its id: the parent's, or a new one for a
  span without a parent.  So the spans of one step or one request share
  an id, across threads too;
- with a card ``device``, CUDA events on that card's current stream at
  its entry and exit, resolved only by ``snapshot()``.

``count(name, n)`` adds to a counter.  ``snapshot()`` returns the recorded
spans (name, id, parent, host ms, device ms or None) and the counters.

Recording is on while a ``torch.profiler`` runs (the process-wide
``torch.autograd.profiler._is_profiler_enabled``) or inside
``recording(True)``; ``recording(False)`` turns it off.  Off, a span costs
one flag check: no ``record_function``, no event, no allocation.  The
store holds the newest recorded stretch only: the first span or count
recorded after one that found recording off clears it, so a reader sees
exactly the traced sub-window.  The store is bounded (``MAX_SPANS``) and
takes a lock, since the mesh requests' fetch and mesh workers record from
their own threads.  The recorder is process-wide, as the profiler is: a
span is opened deep inside the program, far from any caller that could
pass a recorder down.

``DeviceSpans`` is the always-on form of one predict call's device
times (``encode_s``, ``decode_s``), from the same events.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 16

_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_serials = itertools.count(1)
_store: collections.deque = collections.deque(maxlen=MAX_SPANS)
_counters: collections.Counter = collections.Counter()
_forced: Optional[bool] = None  # recording(on), else the profiler's flag
_stale = False  # a span or count found recording off since the last clear
_generation = 0  # bumped at each clear; a span open across one is dropped


def device_event(device: torch.device) -> torch.cuda.Event:
    """A timing event recorded on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def elapsed_ms(start: torch.cuda.Event, end: torch.cuda.Event) -> float:
    """Milliseconds between two events, once ``end`` has completed."""
    end.synchronize()
    return start.elapsed_time(end)


def _enabled() -> bool:
    return _profiler._is_profiler_enabled if _forced is None else _forced


def _on() -> bool:
    """Whether recording is on; off, marks the store stale."""
    global _stale
    if _enabled():
        return True
    _stale = True
    return False


def _begin() -> int:
    """The store's generation, cleared first if recording was off since."""
    global _stale, _generation
    if _stale:
        with _lock:
            if _stale:
                _store.clear()
                _counters.clear()
                _generation += 1
                _stale = False
    return _generation


def _stack() -> List['_Span']:
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ('name', 'id', 'parent', 'serial', 'device', 'generation',
                 'fn', 't0', 't1', 'ev0', 'ev1', '_device_ms')

    def __init__(self, name: str, device, parent: Optional['_Span']):
        self.name, self.parent = name, parent
        self.device = (device if device is not None
                       and torch.device(device).type == 'cuda' else None)
        self.ev0 = self.ev1 = self._device_ms = None

    def __enter__(self) -> '_Span':
        self.generation = _begin()
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        self.id = next(_ids) if self.parent is None else self.parent.id
        self.serial = next(_serials)
        stack.append(self)
        self.fn = _profiler.record_function(self.name)
        self.fn.__enter__()
        if self.device is not None:
            self.ev0 = device_event(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self.device is not None:
            self.ev1 = device_event(self.device)
        self.fn.__exit__(*exc)
        _stack().pop()
        with _lock:
            if self.generation == _generation:
                _store.append(self)

    def row(self) -> Dict:
        if self.ev1 is not None and self._device_ms is None:
            self._device_ms = elapsed_ms(self.ev0, self.ev1)
        return dict(name=self.name, id=self.id, serial=self.serial,
                    parent=None if self.parent is None
                    else self.parent.serial,
                    host_ms=1e3 * (self.t1 - self.t0),
                    device_ms=self._device_ms)


_OFF = contextlib.nullcontext()


def span(name: str, device=None, parent: Optional[_Span] = None):
    """A context manager that records the phase ``name`` while recording
    is on (module docstring) and gives its span, else does nothing and
    gives None.  ``device``: events on that card around the phase (none
    on the CPU); ``parent``: the span that caused this one, where it is
    not the enclosing span on this thread."""
    if not _on():
        return _OFF
    return _Span(name, device, parent)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if _on():
        _begin()
        with _lock:
            _counters[name] += n


def snapshot() -> Dict:
    """{'spans': [{'name', 'id', 'serial', 'parent', 'host_ms',
    'device_ms'}], 'counters': {name: n}} of the newest recorded stretch,
    spans in the order they ended; ``parent`` is the parent's ``serial``.
    Device times wait for their events."""
    with _lock:
        spans, counters = list(_store), dict(_counters)
    return {'spans': [s.row() for s in spans], 'counters': counters}


@contextlib.contextmanager
def recording(on: bool = True):
    """Force recording on or off inside the block (process-wide); a
    forced stretch that follows an off one starts a new store."""
    global _forced, _stale
    if not (on and _enabled()):
        _stale = True
    prev, _forced = _forced, bool(on)
    try:
        yield
    finally:
        _forced = prev
        if not _enabled():
            _stale = True


class DeviceSpans:
    """CUDA events of one predict call on the card: its start, the end of
    its encode, and the end of each image's decode (``mark``), always
    recorded.  ``resolve`` gives ``encode_s`` (start to the encode's end)
    and ``decode_s`` (the encode's end to the last decode's end: the sum
    of the call's decodes) in seconds, once the last event has completed,
    and writes them into ``timings`` (the executor's)."""

    def __init__(self, device: torch.device, timings: Dict[str, float]):
        self.device = device
        self.timings = timings
        self.events: List[torch.cuda.Event] = []
        self._times: Optional[Dict[str, float]] = None

    def mark(self) -> torch.cuda.Event:
        ev = device_event(self.device)
        self.events.append(ev)
        return ev

    def resolve(self, wait: bool = True) -> Optional[Dict[str, float]]:
        """The call's times (None when ``wait`` is False and its last
        decode is still running)."""
        if self._times is None:
            last = self.events[-1]
            if not wait and not last.query():
                return None
            start, encoded = self.events[:2]
            self._times = dict(encode_s=elapsed_ms(start, encoded) / 1e3,
                               decode_s=elapsed_ms(encoded, last) / 1e3)
            self.timings.update(self._times)
        return self._times
