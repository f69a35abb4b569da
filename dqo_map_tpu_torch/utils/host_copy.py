"""`HostCopy`: a tensor's values copied to the host without waiting for
the card's work queued after them (the tracker's pose and residual, the
mapper's map counts)."""

from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """The host copy of a tensor. On a card: a copy into pinned host
    memory, queued on the tensor's current stream with an event recorded
    after it, so that `numpy()` waits for that event alone and not for the
    work queued later. The first read keeps the values as a numpy array
    and releases the pinned buffer and the event. Where the pinned buffer
    or the event cannot be made, it raises. On the CPU it keeps the
    values, with nothing to overlap."""

    def __init__(self, x: torch.Tensor):
        x = x.detach()
        self._event = None
        if x.is_cuda:
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(x.device))
        else:
            self._host = x.numpy()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._host, self._event = self._host.numpy().copy(), None
        return self._host

    def done(self) -> bool:
        """Whether the copy has landed, without waiting for it."""
        return self._event is None or self._event.query()
