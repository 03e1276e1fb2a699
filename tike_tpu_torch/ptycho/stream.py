"""Host-streamed diffraction data: double-buffered batches on a copy stream.

Counterpart of the host-resident mode of :mod:`tike_tpu.ptycho`
(``store_data_on_device=False``), whose solvers prefetch batch k+1 with an
asynchronous ``device_put`` while batch k computes. Here the batch-major
data ``(num_batch, L, DET, DET)`` stays in pinned host memory and two
device buffers of one batch each take turns: batch k+1 is copied with
``non_blocking=True`` on a copy stream while the compute stream works on
batch k. One CUDA event per buffer and direction orders the two streams:
the compute stream waits for a buffer's copy, and the next copy into that
buffer waits until the last kernel that read it was enqueued and has run.
Nothing synchronizes the host.

The kernels, their order and their inputs are those of a resident run, so
both give the same bits; a difference means a race between the streams.
On the CPU the same class hands out views of the host array, without
streams or pinning.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

__all__ = ["StreamedBatches", "pinned_batches", "iter_batches"]


def pinned_batches(data, perm, batch_shape, device) -> torch.Tensor:
    """Return ``data[perm]`` as a float32 host tensor of shape
    ``(*batch_shape, DET, DET)``, filled one batch at a time.

    ``data`` is a host array or CPU tensor (N, DET, DET) and ``perm`` the
    ``num_batch * L`` pattern numbers in batch-major order. For a CUDA
    ``device`` the tensor is page-locked, so that copies from it run
    asynchronously at the full rate of the bus; a host that cannot
    page-lock that much raises ``MemoryError``, and nothing falls back to
    pageable memory. Filling batch by batch keeps the
    host at one extra batch instead of two more copies of the data.
    """
    nb, length = batch_shape
    device = torch.device(device)
    shape = (nb, length, *data.shape[-2:])
    try:
        out = torch.empty(shape, dtype=torch.float32, pin_memory=device.type == "cuda")
    except RuntimeError as error:
        raise MemoryError(
            f"cannot page-lock {4 * int(np.prod(shape))} bytes of host memory for "
            f"the streamed data {shape}; stream fewer patterns"
        ) from error
    perm = np.asarray(perm).reshape(nb, length)
    for b in range(nb):
        if isinstance(data, torch.Tensor) and data.dtype == torch.float32:
            torch.index_select(data, 0, torch.as_tensor(perm[b]), out=out[b])
        elif isinstance(data, torch.Tensor):
            out[b] = data[torch.as_tensor(perm[b])]
        else:
            out[b] = torch.from_numpy(
                np.ascontiguousarray(data[perm[b]], dtype=np.float32)
            )
    return out


class StreamedBatches:
    """The batches of host-resident data ``host`` (num_batch, L, DET, DET),
    handed to the solver on ``device`` in the order it asks for.

    With ``timing`` each copy and each wait of the compute stream is
    bracketed by timing events, read by :meth:`stats`.
    """

    def __init__(self, host: torch.Tensor, device, timing: bool = False):
        self.host = host
        self.device = torch.device(device)
        self.shape = tuple(host.shape)
        self.timing = timing
        self._timed: typing.List[tuple] = []
        if self.device.type != "cuda":
            return
        if not host.is_pinned():
            raise ValueError(
                "host-streamed data must lie in pinned memory on a CUDA run "
                "(see pinned_batches)"
            )
        self._copy_stream = None

    def _start(self) -> None:
        """The copy stream, the two device buffers and their events, made
        when the first batch is asked for."""
        self._copy_stream = torch.cuda.Stream(self.device)
        self._buffers = [
            torch.empty(self.shape[1:], dtype=self.host.dtype, device=self.device)
            for _ in range(2)
        ]
        # The buffers come from the compute stream's pool, and may reuse
        # memory that work it has enqueued still reads: the first copies
        # wait for that work.
        self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        # ready[s]: the copy into buffer s has landed (copy -> compute);
        # free[s]: the kernels that read buffer s have run (compute -> copy).
        self._ready = [torch.cuda.Event() for _ in range(2)]
        self._free = [torch.cuda.Event() for _ in range(2)]

    def _enqueue_copy(self, k: int, n: int) -> None:
        """Enqueue the copy of batch ``n`` into the buffer of turn ``k``."""
        slot = k % 2
        stream = self._copy_stream
        stream.wait_event(self._free[slot])
        with torch.cuda.stream(stream):
            if self.timing:
                begin = torch.cuda.Event(enable_timing=True)
                begin.record(stream)
            self._buffers[slot].copy_(self.host[n], non_blocking=True)
            if self.timing:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                self._timed.append(("copy", begin, end))
            self._ready[slot].record(stream)

    def batches(self, order) -> typing.Iterator[typing.Tuple[int, torch.Tensor]]:
        """Yield ``(n, data_n)`` for each batch number of ``order``.

        ``data_n`` (L, DET, DET) lies on the device and is valid until the
        next item is asked for: enqueue everything that reads it before
        that, on the current stream.
        """
        order = [int(n) for n in order]
        if self.device.type != "cuda":
            for n in order:
                yield n, self.host[n]
            return
        if self._copy_stream is None:
            self._start()
        compute = torch.cuda.current_stream(self.device)
        if order:
            self._enqueue_copy(0, order[0])
        for k, n in enumerate(order):
            if k + 1 < len(order):
                self._enqueue_copy(k + 1, order[k + 1])
            slot = k % 2
            if self.timing:
                begin = torch.cuda.Event(enable_timing=True)
                begin.record(compute)
            compute.wait_event(self._ready[slot])
            if self.timing:
                end = torch.cuda.Event(enable_timing=True)
                end.record(compute)
                self._timed.append(("wait", begin, end))
            yield n, self._buffers[slot]
            self._free[slot].record(compute)

    def stats(self) -> dict:
        """Milliseconds since the last call, from the timing events: the
        copy stream's busy time (``copy_ms``, over ``copies`` copies of
        ``bytes`` in all) and the time the compute stream stood waiting for
        a copy (``wait_ms``). Synchronizes the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {"copy_ms": 0.0, "wait_ms": 0.0, "copies": 0}
        for kind, begin, end in self._timed:
            out[kind + "_ms"] += begin.elapsed_time(end)
            out["copies"] += kind == "copy"
        out["bytes"] = out["copies"] * int(np.prod(self.shape[1:])) * 4
        self._timed = []
        return out


def iter_batches(data, order):
    """``(n, data_n)`` over ``order`` for resident (a tensor, indexed) or
    streamed (:class:`StreamedBatches`) batch-major data."""
    if isinstance(data, StreamedBatches):
        return data.batches(order)
    return ((n, data[n]) for n in order)
