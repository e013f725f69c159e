"""Asynchronous device-to-host copies for the realtime pipeline.

Counterpart of dmvio_tpu/utils/fetch.py. The reference hides a fixed link
round trip per copy behind a pool of fetch threads. On a CUDA card a copy
needs no thread: `submit` enqueues one `non_blocking` copy per tensor into
pinned host memory on the current stream and records a CUDA event behind
them, so the host goes on dispatching while the copies wait their turn in
the stream. The returned future is done when the event has passed.

The copies ride the producer's own stream, so they are ordered after the
kernels that wrote their sources, and the caching allocator (which is
stream-ordered) cannot hand a source's memory to a later kernel before its
copy has read it. The pinned buffers come from PyTorch's caching host
allocator, which holds each one until the copy's event has passed.

CPU tensors, or `enabled=False`, copy at once and return a future that is
already done: the deterministic mode in which the accuracy tests run.

Consume order is unchanged: callers submit in dispatch order and resolve
in the same order.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch


def to_host(x):
    """Tensors -> numpy arrays through tuples, lists and NamedTuples; other
    leaves (None, Python numbers) are kept. Synchronous."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_host(a) for a in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(a) for a in x)
    return x


def _any_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_any_cuda(a) for a in x)
    return False


def _pinned_copy(x):
    """Start the copy of every CUDA tensor of the tree into pinned host
    memory (non-blocking, current stream); same tree of host tensors."""
    if isinstance(x, torch.Tensor):
        if not x.is_cuda:
            return x.detach()
        dst = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        dst.copy_(x.detach(), non_blocking=True)
        return dst
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_pinned_copy(a) for a in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_pinned_copy(a) for a in x)
    return x


class FetchFuture:
    """The pending host copy of one tree, with the `done` / `result` /
    `exception` part of concurrent.futures.Future."""

    _POLL_S = 2e-4

    def __init__(self, host_tree, event: Optional[torch.cuda.Event] = None):
        self._host = host_tree
        self._event = event

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def _wait(self, timeout: Optional[float]) -> None:
        if self._event is None:
            return
        if timeout is None:
            self._event.synchronize()
            return
        deadline = time.monotonic() + timeout
        while not self._event.query():
            if time.monotonic() >= deadline:
                raise TimeoutError("device-to-host copy still in flight")
            time.sleep(self._POLL_S)

    def exception(self, timeout: Optional[float] = None):
        """Wait for the copy (at most `timeout` seconds, else
        TimeoutError); a copy has no exception of its own to return, so
        this returns None (a device fault raises from the wait)."""
        self._wait(timeout)
        return None

    def result(self, timeout: Optional[float] = None):
        """The tree with every tensor turned into a numpy array."""
        self._wait(timeout)
        return to_host(self._host)


class AsyncFetcher:
    """Turns the host copy of a tree of tensors into a FetchFuture."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def submit(self, tree: Any) -> FetchFuture:
        if not self.enabled or not _any_cuda(tree):
            return FetchFuture(to_host(tree))
        host = _pinned_copy(tree)
        event = torch.cuda.Event()
        event.record()
        return FetchFuture(host, event)
