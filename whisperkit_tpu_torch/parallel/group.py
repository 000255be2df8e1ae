"""In-process collectives between the tensor-parallel ranks of one mesh
group (port-only: in the JAX package XLA inserts these sums itself).

The port runs a mesh as one process with one thread per device
(parallel/mesh.py). The tp ranks of a (dcn, dp) cell share a `TPGroup`;
each rank's thread holds a `TPRank` and calls its collectives, which meet
at a barrier:

  all_reduce_sum / all_reduce_max  the first rank combines the ranks'
      tensors in rank order on its device, then every other rank copies
      the result: all ranks hold bit-identical values, so their host loops
      (sampling, stop checks, the fallback ladder) decide alike and never
      wait on each other at different collectives
  all_gather(dim)  every rank concatenates the ranks' tensors in rank order
  agree(fn)        the first rank's `fn()`, for a host decision that must
      be the same on every rank (a cancellation flag read once)

The barrier has a timeout, and `abort` breaks it: a rank that raises makes
the mesh runner abort its group, so every rank waiting there raises
`GroupAborted` instead of waiting forever.

On the card every tensor lies on its rank's device and the work is
ordered by the devices' current streams (PyTorch's cross-device copies
wait on both ends' streams), so nothing here synchronizes with the host.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

import torch

# seconds a rank waits at a collective for the others; generous, since the
# first launch of a process builds the kernels (tens of seconds) while the
# other ranks wait
DEFAULT_TIMEOUT = 600.0


class GroupAborted(RuntimeError):
    """A collective could not complete: another rank failed, or the ranks
    did not all arrive within the group's timeout."""


class TPGroup:
    """The collectives' meeting point for `size` ranks on `devices`."""

    def __init__(self, devices: Sequence[torch.device], timeout: float = DEFAULT_TIMEOUT):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.timeout = timeout
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        self._slots: list[Any] = [None] * self.size
        self._result: Any = None

    def rank(self, r: int) -> "TPRank":
        return TPRank(self, r)

    def abort(self) -> None:
        """Break the barrier: every rank waiting in or arriving at a
        collective raises GroupAborted."""
        self._barrier.abort()

    def reset(self) -> None:
        """Make the group usable again after an abort (no rank may be
        inside a collective)."""
        self._barrier.reset()
        self._slots = [None] * self.size
        self._result = None

    def _wait(self) -> None:
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise GroupAborted(
                f"tensor-parallel collective of {self.size} ranks aborted: a rank failed or did not "
                f"arrive within {self.timeout:g} s"
            ) from None

    def _combine(self, r: int, x: torch.Tensor, op: Callable) -> torch.Tensor:
        self._slots[r] = x
        self._wait()
        if r == 0:
            dev = self.devices[0]
            acc = self._slots[0]
            for y in self._slots[1:]:
                acc = op(acc, y.to(dev))
            self._result = acc
        self._wait()
        out = self._result if r == 0 else self._result.to(self.devices[r], copy=True)
        self._wait()  # every rank holds its copy before the slots are reused
        return out

    def _exchange(self, r: int, value):
        """Every rank's value, in rank order."""
        self._slots[r] = value
        self._wait()
        values = list(self._slots)
        self._wait()
        return values


class TPRank:
    """One rank's handle on its group."""

    def __init__(self, group: TPGroup, rank: int):
        if not 0 <= rank < group.size:
            raise ValueError(f"rank {rank} outside a group of {group.size}")
        self.group, self.rank, self.size = group, rank, group.size
        self.device = group.devices[rank]

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.group._combine(self.rank, x, torch.add)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return self.group._combine(self.rank, x, torch.maximum)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        parts = self.group._exchange(self.rank, x)
        return torch.cat([p.to(self.device) for p in parts], dim)

    def agree(self, fn: Callable[[], Any]) -> Any:
        """The first rank's `fn()` on every rank (the others do not call it)."""
        return self.group._exchange(self.rank, fn() if self.rank == 0 else None)[0]

    def head_slice(self, n_head: int) -> slice:
        """This rank's heads of `n_head` (contiguous, rank-major)."""
        if n_head % self.size:
            raise ValueError(f"{n_head} heads do not split over tp={self.size}")
        per = n_head // self.size
        return slice(self.rank * per, (self.rank + 1) * per)
