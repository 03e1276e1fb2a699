"""Named spans of the port's work, on the profiler's clock.

``span(name)`` marks a stretch of host code: while a ``torch.profiler``
records, it enters ``torch.profiler.record_function(name)``, so the span
lands in the profiler's trace as a ``user_annotation`` on the clock of the
device's kernels, and an idle stretch of the device can be put down to what
the host was doing then; while none records, it returns a shared no-op
context, one C call's check. Nothing else turns spans on: profile the
program (``python -m tike_tpu_torch.profile_epoch``, or any
``torch.profiler.profile`` around a call) and they are there.

Spans nest by the order of the thread that opens them, and none stays open
across a ``yield`` of the solvers' generators (:func:`spanned`), which
``parallel.run_shards`` interleaves on a mesh. The ptychography path opens:

- ``tike.iterate``: a call of ``Reconstruction.iterate``, the root of the
  others;
- ``tike.epoch``: one epoch's enqueue (``solvers.epoch._epoch_math``, a
  striped epoch in ``parallel.striped.striped_iterate``);
- ``tike.epoch.begin``: the probe constraints and the preconditioners;
- ``tike.batch``: one mini-batch's math and its write into the state;
- ``tike.epoch.end``: the object, probe and position updates of the
  epoch's end, a span a stretch between the stripes' requests;
- ``tike.position.affine_fit``: the affine position fit on the host;
- ``tike.host_read`` (:func:`host_read`): a read that makes the host wait
  for the device, also counted in ``opt.HOST_READS`` by what it reads.

The patch kernels and cuFFT carry no span: their kernels carry their names
in the device's trace.

To see them: ``python -m tike_tpu_torch.profile_epoch`` prints a table of
the spans of one traced epoch (calls, host and device milliseconds) and
writes the chrome trace (``--trace PATH``), where they are the
``user_annotation`` events named ``tike.*``, open in Perfetto or
``chrome://tracing``; without a profiler, ``opt.HOST_READS`` still counts
the host reads.
"""

from __future__ import annotations

import contextlib
import functools
import inspect

import torch

from .opt import HOST_READS

_recording = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()

HOST_READ = "tike.host_read"


def span(name: str):
    """A context that marks its body as ``name`` while a profiler records,
    and does nothing otherwise."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)


def host_read(key: str):
    """A ``tike.host_read`` span around a read of the device's values to
    the host, counted in ``opt.HOST_READS[key]`` whether or not a profiler
    records."""
    HOST_READS[key] += 1
    return span(HOST_READ)


def spanned(name: str):
    """Decorate a function so that its body runs inside ``span(name)``.

    A generator function's body runs in a span a stretch between two
    ``yield``s: one that never yields is one span, and no span stays open
    while another shard's generator runs."""

    def wrap(fn):
        if not inspect.isgeneratorfunction(fn):

            @functools.wraps(fn)
            def call(*args, **kwargs):
                with span(name):
                    return fn(*args, **kwargs)

            return call

        @functools.wraps(fn)
        def steps(*args, **kwargs):
            inner = fn(*args, **kwargs)
            answer = None
            while True:
                with span(name):
                    try:
                        request = inner.send(answer)
                    except StopIteration as stop:
                        return stop.value
                answer = yield request

        return steps

    return wrap
