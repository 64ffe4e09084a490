"""Spans of the port's layers, on the profiler's clock.

``span(name)`` marks a stretch of the host's work. While a ``torch.profiler``
session records (the benchmark's traced window, ``trainer.profiler=jax``, or an
operator's own session), it enters ``torch.profiler.record_function(name)``: the
span lands in that session beside the kernels and copies it caused, on the same
clock. Otherwise it returns a shared no-op context after one check of the
profiler's state (a fraction of a microsecond; an unconditional
``record_function`` costs some ten microseconds even with no session).

Names are ``anomalyclip.<layer>.<what>``, the layer one of ``predict``,
``evaluator``, ``model`` or ``trainer``; the dot keeps them apart from the custom
operators (``anomalyclip::fused_mha_*``). Spans nest by time: every span of one
video lies inside its ``anomalyclip.predict.video``, every span of one training
step inside its ``anomalyclip.trainer.step``.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """A context that records ``name`` as a span while a profiler session records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
