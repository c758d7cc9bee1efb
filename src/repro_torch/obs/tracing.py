"""Tracing spans: a lightweight, zero-cost-when-disabled span API.

One global switch (:func:`enabled`) gates everything. Disabled (the
default), :func:`span` returns a shared no-op singleton — no allocation,
no clock read, no lock — so instrumented hot paths (the serve decode loop,
``resolve_call``) pay a single module-global bool check. Enabled, spans
time themselves on the monotonic clock, nest through a thread-local stack
(children record their parent's span id), and emit one JSONL record per
close to the configured sink:

* ``REPRO_TORCH_TRACE=/path/trace.jsonl`` enables tracing at import and appends
  records there;
* ``tuning_config(trace_path=...)`` enables it for a scope (the autotune
  config stack restores the previous state on exit);
* :func:`enable` with no path keeps records in a bounded in-memory ring
  (:func:`drain` reads and clears it — the test/bench hook).

Record schema (one JSON object per line)::

    {"name": "resolve_call", "id": 7, "parent": 3, "ts": <epoch s>,
     "dur_s": 0.0012, "thread": 140, "status": "ok"|"error",
     "attrs": {...}, ["error": "ValueError"]}

File-mode records are handed to a daemon writer thread that serializes
and writes in batches (span close is one list append; json encoding and
the flush syscall overlap kernel execution, which releases the GIL).
``disable``/``restore`` drain the writer synchronously, so a reader that
follows the restore contract always sees every record.

A failing sink disables tracing with a ``RuntimeWarning`` instead of
failing the traced workload (mirroring ``core.profiling``'s recorder
contract): telemetry must never take the job down.
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

TRACE_ENV = "REPRO_TORCH_TRACE"

_BUFFER_MAX = 16384     # in-memory ring bound (records), no-path mode
_FLUSH_EVERY = 64       # pending records that wake the writer early
_WRITER_POLL_S = 0.5    # writer wakes at least this often for small tails

_enabled = False
_path: Optional[str] = None
_file = None
_lock = threading.Lock()
_ids = itertools.count(1)
_buffer: "collections.deque[dict]" = collections.deque(maxlen=_BUFFER_MAX)


class _Local(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []


_local = _Local()


def enabled() -> bool:
    """The one gate every instrumentation site checks."""
    return _enabled


def trace_path() -> Optional[str]:
    """The active JSONL sink path (None = disabled or in-memory)."""
    return _path if _enabled else None


def enable(path: Optional[str] = None) -> Tuple[bool, Optional[str]]:
    """Turn tracing on. ``path`` appends JSONL records there; ``None``
    collects into the in-memory ring (:func:`drain`). Returns the previous
    ``(enabled, path)`` state for :func:`restore`."""
    global _enabled, _path
    prev = (_enabled, _path)
    if path != _path:
        _shutdown_writer()           # drain + close the old sink first
    with _lock:
        _path = path
    _enabled = True
    return prev


def disable() -> Tuple[bool, Optional[str]]:
    """Turn tracing off, drain pending records, and close the sink.
    Returns the previous state."""
    global _enabled, _path
    prev = (_enabled, _path)
    _enabled = False
    _shutdown_writer()
    with _lock:
        _path = None
    return prev


def restore(state: Tuple[bool, Optional[str]]) -> None:
    """Re-apply a state returned by :func:`enable`/:func:`disable` (the
    scope-exit half of ``tuning_config(trace_path=...)``)."""
    was_enabled, path = state
    if was_enabled:
        enable(path)
    else:
        disable()


def drain() -> List[dict]:
    """Read and clear the in-memory record ring (no-path mode)."""
    out = []
    with _lock:
        while _buffer:
            out.append(_buffer.popleft())
    return out


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if type(v).__module__ == "torch" and hasattr(v, "tolist"):
        # a torch tensor (torch is never imported here): its values, as the
        # reference's jnp arrays would stringify
        return v.tolist() if v.numel() <= 64 else str(tuple(v.shape))
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    return str(v)


# -- batched background sink -------------------------------------------------
#
# File-mode emits only append the raw record to ``_pending``; a daemon
# writer thread serializes and writes in batches (the OTel
# BatchSpanProcessor shape). json.dumps and the flush syscall are the two
# biggest per-span costs, and moving them off-thread lets them overlap
# kernel execution (which releases the GIL), so a traced hot path pays one
# list append. disable()/enable(new path) drain synchronously, so readers
# that follow the restore contract always see every record.

_pending: List[dict] = []
_wake = threading.Condition(_lock)
_writer: Optional[threading.Thread] = None
_writer_stop = False


def _serialize(rec: dict) -> str:
    try:
        return json.dumps(rec, default=str)
    except TypeError:       # e.g. non-str dict keys in attrs
        return json.dumps(_jsonable(rec))


def _writer_loop() -> None:
    global _enabled, _file
    while True:
        with _wake:
            # sleep until a full batch accumulates (threshold notify), a
            # stop request, or a poll period passes with a small tail —
            # never spin on a trickle, which would contend for the GIL
            # with the traced workload the whole time it runs
            if not _writer_stop and len(_pending) < _FLUSH_EVERY:
                _wake.wait(_WRITER_POLL_S)
            if not _writer_stop and len(_pending) < _FLUSH_EVERY:
                _wake.wait(_WRITER_POLL_S)
            if not _pending and not _writer_stop:
                continue
            batch = _pending[:]
            del _pending[:]
            stop = _writer_stop
            path = _path
        if batch and path is not None:
            try:
                if _file is None:
                    d = os.path.dirname(path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    _file = open(path, "a")
                lines = []
                for i, r in enumerate(batch):
                    lines.append(_serialize(r) + "\n")
                    if i % 8 == 7:
                        # yield the GIL each few records: a GIL-bound
                        # traced workload (the CPU's plain versions) must
                        # never stall a full switch quantum behind a
                        # batch encode
                        time.sleep(0)
                _file.write("".join(lines))
                _file.flush()
            except Exception as e:   # noqa: BLE001 — sink failure must
                _enabled = False     # not take the traced workload down
                warnings.warn(
                    f"trace sink failed ({type(e).__name__}: {e}); "
                    f"tracing disabled", RuntimeWarning, stacklevel=2)
        if stop:
            return


def _shutdown_writer() -> None:
    """Stop the writer thread (draining pending records) and close the
    sink file. Only the writer touches ``_file`` while it runs, so the
    close after join is race-free."""
    global _writer, _writer_stop, _file
    with _wake:
        w = _writer
        _writer = None
        _writer_stop = True
        _wake.notify()
    if w is not None:
        w.join(timeout=10.0)
    with _lock:
        _writer_stop = False
        del _pending[:]
        if _file is not None:
            _file.close()
            _file = None


def _emit(rec: dict) -> None:
    global _enabled, _writer
    try:
        with _wake:
            if _path is None:
                _buffer.append(rec)
                return
            _pending.append(rec)
            if _writer is None or not _writer.is_alive():
                _writer = threading.Thread(
                    target=_writer_loop, name="repro-torch-trace-writer",
                    daemon=True)
                _writer.start()
            if len(_pending) >= _FLUSH_EVERY:
                _wake.notify()
    except Exception as e:   # noqa: BLE001 — sink failure must not propagate
        _enabled = False
        warnings.warn(f"trace sink failed ({type(e).__name__}: {e}); "
                      f"tracing disabled", RuntimeWarning, stacklevel=2)


class _NoopSpan:
    """Shared do-nothing span (the disabled path). ``set`` chains so call
    sites never branch on the enabled state themselves."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed span. Use as a context manager; :meth:`set` attaches
    attributes any time before close (e.g. a plan source known only after
    resolution). Closing under an exception records ``status="error"`` and
    the exception type, then re-raises (``__exit__`` returns False)."""

    __slots__ = ("name", "attrs", "id", "parent", "t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self.t0 = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = _local.stack
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        dur = time.monotonic() - self.t0
        stack = _local.stack
        # unwind any child frames a non-context-manager misuse left open,
        # so one leak cannot mis-parent every later span on this thread
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        rec: Dict[str, Any] = {
            "name": self.name, "id": self.id, "parent": self.parent,
            "ts": time.time(), "dur_s": dur,
            "thread": threading.get_ident(),
            "status": "ok" if etype is None else "error",
        }
        if etype is not None:
            rec["error"] = etype.__name__
        if self.attrs:
            # raw reference, not a _jsonable copy: stringification happens
            # in the writer thread (file mode) or not at all (memory ring)
            rec["attrs"] = self.attrs
        _emit(rec)
        return False


def span(name: str, **attrs):
    """Open a span named ``name`` with initial attributes. Returns the
    no-op singleton when tracing is disabled."""
    if not _enabled:
        return NOOP_SPAN
    return Span(name, dict(attrs))


def current_span():
    """The innermost open span on this thread (for attaching attributes
    from nested code), or the no-op singleton."""
    if not _enabled:
        return NOOP_SPAN
    stack = _local.stack
    return stack[-1] if stack else NOOP_SPAN


# REPRO_TORCH_TRACE in the environment enables tracing for the whole process —
# the zero-code-change way to trace a launch driver or bench run
if os.environ.get(TRACE_ENV):
    enable(os.path.expanduser(os.environ[TRACE_ENV]))

# drain the batched sink at interpreter exit: a process that never calls
# disable() (REPRO_TORCH_TRACE mode) would otherwise lose the writer's tail
atexit.register(_shutdown_writer)
