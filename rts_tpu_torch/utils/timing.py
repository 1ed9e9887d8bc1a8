"""Spans and counters of the port's layers (counterpart of
``rts_tpu.utils.timing``).

``trace_annotation(name)`` is the one span.  While ``torch.profiler``
records, it is a RecordFunction region (``_REGION``): a host event on the
profiler's clock, inside which the operators and the device work launched
under it can be found.  Otherwise it costs one check of
``torch.autograd._profiler_enabled()`` and returns a shared no-op context:
no region, no allocation.

``count(name, value)`` adds to a registry read by ``counters()`` and
cleared by ``reset()``.  A Python int, a value the host already holds, is
added always.  A 0-d tensor, a value that lives on the device, is kept
unread and only while a profiler records; ``counters()`` reads it, once,
so that counting adds no host read inside the pulse loop.  Callers compute
such a tensor only when ``profiling()`` is true.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
# PyTorch's light RecordFunction context, not ``record_function``: under a
# profiler with CUDA activity a ``record_function`` region (a user
# annotation) made a traced pulse ~20% longer on an H100, this one ~5%
_REGION = torch._C._profiler._RecordFunctionFast
_host: dict[str, int] = {}
_device: dict[str, list] = {}


def profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process."""
    return torch.autograd._profiler_enabled()


def trace_annotation(name: str):
    """A named region of the profiler's trace while one records; else a
    shared no-op context.  Give it a fixed name: it runs in the pulse loop."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _REGION(name)


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d tensor kept while profiling) to the
    counter ``name``."""
    if isinstance(value, torch.Tensor):
        if torch.autograd._profiler_enabled():
            _device.setdefault(name, []).append(value)
        return
    _host[name] = _host.get(name, 0) + value


def counters() -> dict[str, int]:
    """Every counter since the last ``reset()``, by name; the device values
    are read here (one host read a counter) and folded into the host's."""
    for name, values in _device.items():
        _host[name] = _host.get(name, 0) + int(torch.stack([v.to(torch.int64) for v in values]).sum())
    _device.clear()
    return dict(sorted(_host.items()))


def reset() -> None:
    """Clear every counter."""
    _host.clear()
    _device.clear()
