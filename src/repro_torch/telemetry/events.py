"""The no-op recorder of ``repro.telemetry.events``: library code threads
``recorder.span(...)`` / ``recorder.event(...)`` / ``recorder.count(...)``
unconditionally and pays one attribute lookup when nothing records.  A
caller that wants them passes any object with the same methods (the serving
engine calls ``span`` and ``event``, the trainer ``span`` and ``count``)."""
from __future__ import annotations


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The do-nothing recorder."""
    __slots__ = ()

    def span(self, kind: str, **attrs):
        return _NULL_SPAN

    def event(self, kind: str, **attrs) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass


NULL_RECORDER = NullRecorder()
