"""Collectives between the tensor-parallel ranks of one mesh group
(port-only: in the JAX package XLA inserts these sums itself).

The port runs a mesh as one process with one thread per device
(parallel/mesh.py), each rank on a stream of its own. The tp ranks of a
(dcn, dp) cell share a `TPGroup`; each rank's thread holds a `TPRank` and
calls its collectives:

  all_reduce_sum / all_reduce_max  on the device for a CUDA tensor: the
      hand-written kernel of csrc/tp_all_reduce.cu, which every rank
      launches on its own stream and which meets its peers' launches
      through flags in device memory, with no host barrier, so a decode
      step that holds them runs as one CUDA graph per rank. Every rank
      holds the same bits: the ranks' tensors folded in rank order,
      rounded to the working type after each add (`plain_all_reduce`), so
      their loops (sampling, stop checks, the fallback ladder) decide
      alike. A CUDA tensor never takes the host form: a kernel that does
      not build or launch raises. For a CPU tensor the host form below
      computes the same fold (the plain version)
  all_gather(dim)  on the host: every rank concatenates the ranks' tensors
      in rank order (the sequence-parallel encoder, outside any graph)
  agree(fn)        on the host: the first rank's `fn()`, for a host
      decision that must be the same on every rank (a cancellation flag
      read once)

The host collectives meet at a barrier with a timeout; `host_waits`
counts its waits, so a run can show that no replayed step waits on the
host. Ranks that share a device (replicas of one card) also meet there
before each eager call of the device all-reduce and wait for it to end
(`_device_reduce` says why), and meet after each capture of a step
(`TPRank.captured`); a graph's replay never does. The device collective waits on the device for at most the group's
timeout and polls an abort word in mapped host memory. `abort` breaks the
barrier and sets that word: a rank that raises makes the mesh runner
abort its group, so every rank waiting at a host collective raises
`GroupAborted` at once, and every rank whose kernel waits on the device
sees its kernel end and raises `GroupAborted` at the next host sync
(`TPRank.check`: the decode loops call it where they read `done`, and
every device collective calls it before it launches). `reset` makes the
group usable again; after a failure it waits for the group's devices and
clears the device state, so the ranks' call sequences start again at 0.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Callable, Optional, Sequence

import torch

from whisperkit_tpu_torch.ops import _build

# seconds a rank waits at a collective for the others; generous, since the
# first launch of a process builds the kernels (tens of seconds) while the
# other ranks wait
DEFAULT_TIMEOUT = 600.0
# bytes of one of the two staging slots each rank holds on its device; a
# larger tensor goes through in chunks of this size
STAGING_BYTES = 16 << 20
# csrc/tp_all_reduce.cu's limits: ranks, and blocks of one launch
MAX_RANKS = 8
MAX_BLOCKS = 32

KERNEL = "tp_all_reduce"
_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
# op -> (the kernel's op code, the types it takes, the plain version's rule)
_OPS = {
    "sum": (0, (torch.bfloat16, torch.float32, torch.float64), torch.add),
    "max": (1, (torch.float32,), torch.maximum),
}
_ERRORS = {1: "a peer did not arrive within the timeout", 2: "the group was aborted"}


class GroupAborted(RuntimeError):
    """A collective could not complete: another rank failed, or the ranks
    did not all arrive within the group's timeout."""


def plain_all_reduce(xs: Sequence[torch.Tensor], op: str = "sum") -> torch.Tensor:
    """The ranks' tensors folded in rank order on the first one's device,
    each step rounded to the working type (torch.add / torch.maximum):
    the host form's result, and the device kernel's on every rank."""
    rule = _OPS[op][2]
    acc = xs[0]
    for y in xs[1:]:
        acc = rule(acc, y.to(acc.device))
    return acc


class _DeviceState:
    """The device collective's buffers, at fixed addresses for the group's
    life (a CUDA graph holds them): per rank, on its device, two staging
    slots, an inbox of flags [MAX_BLOCKS][MAX_RANKS] and a control word
    {seq, count | err}; one mapped host array {abort, rank 0's error, ...}.
    Peer access is enabled between every two distinct devices, or this
    raises."""

    def __init__(self, devices: list[torch.device], slot_bytes: int):
        if len(devices) > MAX_RANKS:
            raise ValueError(f"a tp group of {len(devices)} ranks; the device all-reduce takes at most {MAX_RANKS}")
        lib = _build.library()
        distinct = list(dict.fromkeys(devices))
        for a in distinct:
            for b in distinct:
                if a != b:
                    status = lib.wk_tp_enable_peer(a.index, b.index)
                    if status:
                        raise RuntimeError(
                            f"{a} cannot reach {b}'s memory (peer access: "
                            f"{'no path' if status == -1 else f'CUDA error {status}'}): the device all-reduce "
                            f"needs peer access between the group's cards"
                        )
        self.slot_bytes = slot_bytes
        with torch.inference_mode(False):  # `clear` writes them from any mode
            self.stage = [torch.empty(2 * slot_bytes, dtype=torch.uint8, device=d) for d in devices]
            self.inbox = [torch.zeros(MAX_BLOCKS * MAX_RANKS, dtype=torch.int64, device=d) for d in devices]
            self.ctrl = [torch.zeros(2, dtype=torch.int64, device=d) for d in devices]
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        status = lib.wk_tp_host_alloc(4 * (1 + MAX_RANKS), ctypes.byref(host), ctypes.byref(dev))
        if status:
            raise RuntimeError(f"wk_tp_host_alloc failed with CUDA error {status}")
        self.host_ptr, self.host_dev = host, dev
        self.host = (ctypes.c_int32 * (1 + MAX_RANKS)).from_address(host.value)
        ptrs = ctypes.c_longlong * len(devices)
        self.stages = ptrs(*[t.data_ptr() for t in self.stage])
        self.inboxes = ptrs(*[t.data_ptr() for t in self.inbox])
        for d in distinct:  # the zeros land before any rank's first launch reads them
            torch.cuda.current_stream(d).synchronize()

    def failed(self) -> int:
        """0, or the first nonzero word: the abort, or a rank's error code."""
        return next((w for w in self.host if w), 0)

    def clear(self) -> None:
        """Zero the flags, the control words and the host words (no launch
        of the group may be in flight)."""
        for t in self.inbox + self.ctrl:
            t.zero_()
            torch.cuda.current_stream(t.device).synchronize()
        for i in range(len(self.host)):
            self.host[i] = 0

    def __del__(self):
        try:
            lib = _build._lib
            if lib is not None and self.host_ptr.value:
                lib.wk_tp_host_free(self.host_ptr)
        except Exception:  # the interpreter is shutting down: the process frees it
            pass


class TPGroup:
    """The collectives' meeting point for `size` ranks on `devices`."""

    def __init__(self, devices: Sequence[torch.device], timeout: float = DEFAULT_TIMEOUT):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.timeout = timeout
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        self._slots: list[Any] = [None] * self.size
        self._result: Any = None
        self._waits = [0] * self.size  # host barrier waits per rank (each thread writes its own)
        self._state: Optional[_DeviceState] = None
        self._state_lock = threading.Lock()
        # ranks that share a device meet on the host before each eager
        # launch of the device all-reduce (see `_device_reduce`)
        self._rendezvous = len(set(self.devices)) < self.size

    def rank(self, r: int) -> "TPRank":
        return TPRank(self, r)

    @property
    def host_waits(self) -> int:
        """Host barrier waits so far, summed over the ranks."""
        return sum(self._waits)

    def abort(self) -> None:
        """Break the barrier and set the device collectives' abort word:
        every rank waiting in or arriving at a collective raises
        GroupAborted (a device wait ends on the device, and its rank raises
        at its next `check`)."""
        self._barrier.abort()
        if self._state is not None:
            self._state.host[0] = 1

    def reset(self) -> None:
        """Make the group usable again after an abort (no rank may be
        inside a collective): after a failure, wait for the group's
        devices (every waiting launch ends on the abort word) and clear
        the device state."""
        self._barrier.reset()
        self._slots = [None] * self.size
        self._result = None
        if self._state is not None and self._state.failed():
            self._state.host[0] = 1
            for d in dict.fromkeys(self.devices):
                torch.cuda.synchronize(d)
            self._state.clear()

    def check(self) -> None:
        """Raise GroupAborted if a device collective of the group failed or
        the group was aborted (a read of mapped host memory, no sync)."""
        code = 0 if self._state is None else self._state.failed()
        if code:
            errors = [w for w in list(self._state.host)[1 : 1 + self.size]]
            why = ", ".join(f"rank {r}: {_ERRORS.get(w, w)}" for r, w in enumerate(errors) if w)
            raise GroupAborted(
                f"tensor-parallel collective of {self.size} ranks aborted on the device "
                f"({why or 'the group was aborted'}; timeout {self.timeout:g} s)"
            )

    def _device_state(self) -> _DeviceState:
        with self._state_lock:
            if self._state is None:
                self._state = _DeviceState(self.devices, STAGING_BYTES)
            return self._state

    def _device_reduce(self, r: int, x: torch.Tensor, op: str) -> torch.Tensor:
        """Rank r's call of the device all-reduce (csrc/tp_all_reduce.cu):
        one launch per staging slot's worth of x, on the current stream.

        Ranks that share a device (replicas of one card) meet at the host
        barrier before an eager call and wait for it to end after: one
        context holds all their work there, and a context-wide wait that a
        rank issues (the first launch of a kernel under CUDA's lazy module
        loading, a memset) would otherwise wait for a peer's all-reduce
        that waits for that very rank, until the timeout. So no rank goes
        on while a call that waits on it can run. A graph's replay makes no
        such call, and a capture runs nothing (no wait there)."""
        code, dtypes, _ = _OPS[op]
        if x.dtype not in dtypes:
            raise TypeError(f"the device all_reduce_{op} takes {[str(t) for t in dtypes]}, got {x.dtype}")
        if x.device != self.devices[r]:
            raise ValueError(f"rank {r} of the group lies on {self.devices[r]}, its tensor on {x.device}")
        state = self._device_state()
        self.check()
        meet = self._rendezvous and not torch.cuda.is_current_stream_capturing()
        if meet:
            self._wait(r)
        x = x.contiguous()
        y = torch.empty_like(x)
        es, n = x.element_size(), x.numel()
        chunk = state.slot_bytes // es
        timeout_ns = int(self.timeout * 1e9)
        for off in range(0, n, chunk):
            m = min(chunk, n - off)
            _build.launch(
                KERNEL, "wk_tp_all_reduce", x.device, state.stages, state.inboxes, self.size, r,
                _build.ptr(state.ctrl[r]), state.host_dev, ctypes.c_void_p(x.data_ptr() + off * es),
                ctypes.c_void_p(y.data_ptr() + off * es), m, _DTYPES[x.dtype], code, state.slot_bytes, timeout_ns,
            )
        if meet:
            torch.cuda.current_stream(x.device).synchronize()
        return y

    def _wait(self, r: int) -> None:
        self._waits[r] += 1
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise GroupAborted(
                f"tensor-parallel collective of {self.size} ranks aborted: a rank failed or did not "
                f"arrive within {self.timeout:g} s"
            ) from None

    def _combine(self, r: int, x: torch.Tensor, op: str) -> torch.Tensor:
        """The host form: the first rank folds the ranks' tensors in rank
        order on its device (`plain_all_reduce`), then every other rank
        copies the result."""
        self._slots[r] = x
        self._wait(r)
        if r == 0:
            self._result = plain_all_reduce(self._slots, op)
        self._wait(r)
        out = self._result if r == 0 else self._result.to(self.devices[r], copy=True)
        self._wait(r)  # every rank holds its copy before the slots are reused
        return out

    def _exchange(self, r: int, value):
        """Every rank's value, in rank order."""
        self._slots[r] = value
        self._wait(r)
        values = list(self._slots)
        self._wait(r)
        return values


class TPRank:
    """One rank's handle on its group."""

    def __init__(self, group: TPGroup, rank: int):
        if not 0 <= rank < group.size:
            raise ValueError(f"rank {rank} outside a group of {group.size}")
        self.group, self.rank, self.size = group, rank, group.size
        self.device = group.devices[rank]

    def _reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        if x.is_cuda:
            return self.group._device_reduce(self.rank, x, op)
        return self.group._combine(self.rank, x, op)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "sum")

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "max")

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        parts = self.group._exchange(self.rank, x)
        return torch.cat([p.to(self.device) for p in parts], dim)

    def agree(self, fn: Callable[[], Any]) -> Any:
        """The first rank's `fn()` on every rank (the others do not call it)."""
        return self.group._exchange(self.rank, fn() if self.rank == 0 else None)[0]

    def check(self) -> None:
        """Raise GroupAborted if the group's device collectives failed
        (`TPGroup.check`); call it after a host sync."""
        self.group.check()

    def captured(self) -> None:
        """This rank has captured its step's graph (decoding/graph.py): ranks
        that share a device wait here for every rank's capture, so that no
        replay waits on the device for a peer that is still capturing (a
        capture's instantiation may wait for the device's work)."""
        if self.group._rendezvous:
            self.group._wait(self.rank)

    def head_slice(self, n_head: int) -> slice:
        """This rank's heads of `n_head` (contiguous, rank-major)."""
        if n_head % self.size:
            raise ValueError(f"{n_head} heads do not split over tp={self.size}")
        per = n_head // self.size
        return slice(self.rank * per, (self.rank + 1) * per)
