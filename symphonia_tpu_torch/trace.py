"""Spans and counters of the served path, recorded while ``torch.profiler``
records.

``batch.decode_many`` and the batch decoders under it open a span at each
layer boundary (``span(name)``) and count the bytes of their copies
(``count(name, n)``, through :func:`to_device` and :func:`to_host`). The
switch is the profiler itself: outside a ``torch.profiler.profile`` block
``span`` returns one shared no-op context and ``count`` returns at once, so
untraced calls pay one flag read per span. Inside one, each span is also a
profiler range named ``span:<name>`` (a CPU event of the trace), so it sits
beside the device's kernel and copy rows, on their clock.

The root span ``decode_many`` opens a request with the next request id; a
span opened with no open span above it (a direct call of a batch decoder)
is a root of its own. A request is stored when its root closes;
:func:`requests` returns the stored ones, :func:`reset` empties the store.
The stored ``perf_counter_ns`` times give durations only.

Span names: ``decode_many``, ``setup``, ``probe``, ``open`` (facade /
routing; ``open``: a batch decoder called directly opening a stream, which
``decode_many`` leaves to the probe); ``scan`` (demux: an MPEG audio
reader built, its frame-table walk, once a stream: in the probe, or in
``open``); ``extract``
(host entropy); ``pack``, ``h2d``, ``d2h`` (lane packing + copies);
``enqueue`` (dense kernels); ``tables`` (dense kernels: an MPEG audio
decoder's constant operators, Layer III's ``Mp3Dense`` or Layer I/II's
``L12Dense``, built and uploaded at their first use in a call, their
copies in ``h2d`` under it); ``stitch``, ``verify`` (stitch / verify).
Counters: ``h2d_bytes``, ``d2h_bytes`` (lane packing + copies);
``md5_card_streams``, ``md5_host_streams`` (stitch / verify: one a
verified FLAC stream, by where its STREAMINFO MD5 was computed, F3 on the
card or ``batch._flac_md5_ok`` on the host), ``md5_card_bytes`` and
``md5_chain_bytes`` (stitch / verify: the bytes each F3 ``flac_md5``
launch hashes, summed over its table's rows, and its largest row's, the
one stream's chain that the launch lasts for; counted from the tables in
``flac_dense.LaneMd5.update``); ``flac_lanes`` and
``flac_lane_samples`` (dense kernels: the subframe lanes of each chunk
sent to F1 ``flac_lpc`` and their samples, L x n_max, counted from the
packed chunks' shapes in ``flac_dense.decode_packed``, not from the
launches), ``flac_stereo_frames`` and ``flac_stereo_samples`` (the stereo
frames of each chunk sent to F2 ``flac_decorrelate`` and their samples
a channel, F x n_max); ``mp3_frames`` (Layer III
frames extracted), ``mp3_lanes`` and ``mp3_short_lanes`` (the granule x
channel lanes sent to M1 and M2, and those of short blocks, counted from
the extraction's output, not from the launches); ``mp3_card_streams``,
``mp3_host_streams`` (host entropy: one a Layer III clip, by where its
entropy ran, M0 on the card or the host's extraction), ``mp3_card_bytes``
and ``mp3_card_lanes`` (the frame bytes M0 read and the lanes it wrote);
``mp3_placed_streams`` and ``mp3_placed_bytes`` (stitch / verify: one a
Layer III clip whose trimmed planar PCM M3 ``mp3_place`` laid out on the
device, and the bytes it wrote); ``mp3_table_bytes`` (dense kernels: the
bytes of the constant operators uploaded in span ``tables``, also counted
in ``h2d_bytes``); ``mpa_walk_native_streams``, ``mpa_walk_host_streams``
(demux: one a seekable MPEG audio reader built, by whether its frame
table came from the compiled walk of :mod:`.mpa_walk` or the verbatim
Python walk).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import Counter, deque
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

# Requests kept: a 50 s window of the online cell stores ~13K.
MAX_REQUESTS = 1 << 16

_OFF = nullcontext()
# The profiler range of a span: the C++ form of ``record_function``, the
# same range recorded as a CPU op, 1.7 us a range against 10.9 us on an
# H100 machine's host (PERF.md).
_range = torch._C._profiler._RecordFunctionFast
_ids = itertools.count()
_store: deque = deque(maxlen=MAX_REQUESTS)
_local = threading.local()


def enabled() -> bool:
    """Whether a ``torch.profiler`` session records in this process: the
    profiler's own process-wide flag (``torch._C._autograd.
    _profiler_enabled()`` reads only the calling thread's state)."""
    return _profiler._is_profiler_enabled


class Span(NamedTuple):
    name: str
    request: int
    parent: Optional[int]  # index of the parent in the request's spans
    start_ns: int
    end_ns: int


class Request:
    """One stored request: its spans in the order they opened (the root
    first), and its counters."""

    def __init__(self, rid: int, flat: tuple, counters: Dict[str, int]):
        self.id = rid
        self.spans = [Span(flat[i], rid, *flat[i + 1 : i + 4])
                      for i in range(0, len(flat), 4)]
        self.counters = counters

    @property
    def root(self) -> Span:
        return self.spans[0]

    @functools.cached_property
    def self_ns(self) -> Dict[str, int]:
        """Per span name: the summed durations less those of the direct
        children."""
        out: Dict[str, int] = {}
        for s in self.spans:
            d = s.end_ns - s.start_ns
            out[s.name] = out.get(s.name, 0) + d
            if s.parent is not None:
                p = self.spans[s.parent].name
                out[p] -= d
        return out

    @functools.cached_property
    def calls(self) -> Dict[str, int]:
        return dict(Counter(s.name for s in self.spans))


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Open:
    """A recording span; see :func:`span`."""

    __slots__ = ("name", "req", "idx", "parent", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # The clock reads come first and last, so that a child's interval,
        # its own bookkeeping included, lies inside its parent's; the
        # bookkeeping lies inside the profiler range too.
        self.t0 = time.perf_counter_ns()
        self.rf = _range("span:" + self.name)
        self.rf.__enter__()
        stack = _stack()
        if stack:
            top = stack[-1]
            self.req, self.parent = top.req, top.idx
        else:
            # An open request: [id, spans, counters], the spans flat, four
            # slots each (name, parent index, start, end).
            self.req, self.parent = [next(_ids), [], {}], None
        flat = self.req[1]
        self.idx = len(flat) // 4
        flat += (self.name, self.parent, self.t0, 0)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        self.rf.__exit__(*exc)
        rid, flat, counters = self.req
        flat[4 * self.idx + 3] = time.perf_counter_ns()
        if self.parent is None:
            # Stored as one tuple of strings and integers, which the
            # garbage collector stops tracking: a window's ~10^5 spans add
            # no work to its passes.
            _store.append((rid, tuple(flat), counters))
        return False


def span(name: str):
    """A context that records span ``name`` while the profiler records,
    else the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the open request, while the
    profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    if stack:
        c = stack[-1].req[2]
        c[name] = c.get(name, 0) + int(n)


def requests(last: Optional[int] = None) -> List[Request]:
    """The stored requests in the order their roots closed; the last
    ``last`` of them when given."""
    out = list(_store)
    if last is not None:
        out = out[len(out) - last:] if last > 0 else []
    return [Request(*r) for r in out]


def reset() -> None:
    """Empty the store."""
    _store.clear()


def to_device(device, *arrays) -> List[torch.Tensor]:
    """Host arrays -> tensors on ``device``, one copy each, in one ``h2d``
    span; their bytes are counted as ``h2d_bytes``."""
    with span("h2d"):
        arrays = [np.ascontiguousarray(a) for a in arrays]
        count("h2d_bytes", sum(a.nbytes for a in arrays))
        return [torch.from_numpy(a).to(device) for a in arrays]


def to_host(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array on the host (on the card, this waits for the
    work queued before it), in one ``d2h`` span; its bytes are counted as
    ``d2h_bytes``."""
    with span("d2h"):
        count("d2h_bytes", x.nbytes)
        return x.cpu().numpy()
