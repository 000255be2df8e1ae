"""Device mesh and batch sharding over several devices (port of
whisperkit_tpu/parallel/mesh.py).

The JAX package lays its devices out as a `dcn x dp x tp` grid and lets
XLA partition one program over it. The port keeps that single-controller
shape with one process, one pipeline object and one thread per mesh
device: every worker thread runs the port's single-device code on its own
rows (dp, dcn) or on its own weight shard (tp, parallel/sharding.py), with
the device made current. The tp ranks of one (dcn, dp) cell meet in a
`TPGroup` (parallel/group.py); nothing else is shared between threads, so
no collective can cross a dcn slice or a dp group. On a card each mesh
thread runs its call on a CUDA stream of its own (`MeshPlan.run`): a tp
rank's device all-reduce waits on the device for its peers' launches, so
a rank's waiting kernel must never sit on the stream in front of the
kernels its peer has yet to run (on replicas of one card they would share
the device's current stream). Every mesh thread's Whisper decode, dp or
tp, captures and replays its own CUDA graph of the step on its own stream
(decoding/graph.py), its noise drawn from its rows of the group's draws
before each replay; a tp step's all-reduces are launches inside its graph.

  MeshPlan / make_mesh      the grid, `pad_batch`, the dcn-major row order
  MeshPlan.run              fn(group, rank) in every cell's thread
  shard_params_replicated   one copy of a tree per distinct device
  shard_batch / gather_rows rows → the groups' devices, and back
  dcn_shard                 fn once per dcn slice on its rows and sub-mesh
  SharedDraws               one generator's draws for a whole batch, handed
                            out by rows, so a seed samples the same on one
                            device and on N

A device list may repeat a device: `["cpu"] * 4` stands in for four
devices in the CPU tests, `[cuda:0, cuda:0]` rehearses a two-device mesh
on one card.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional, Sequence, Union

import torch

from whisperkit_tpu_torch.core.device import DeviceLike, resolve_device
from whisperkit_tpu_torch.parallel.group import TPGroup, TPRank

Devices = Union[DeviceLike, Sequence[DeviceLike]]


def resolve_devices(device: Devices) -> list[torch.device]:
    """A device or a sequence of them → the pipeline's device list. One
    device ("cpu", "cuda", "cuda:N", a torch.device) is a list of one: a
    bare "cuda" is the current card, not every visible one, so a default
    pipeline stays on one card; a mesh takes its devices as a list."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        return [resolve_device(d) for d in device]
    return [resolve_device(device)]


def run_threads(calls: Sequence[Callable[[], Any]], on_error: Callable[[], None] = lambda: None) -> list:
    """Run each call in a thread of its own (inline when there is one) and
    return their results in order. When a call raises, `on_error` runs at
    once (aborting the collectives the others may wait in), every thread
    is joined, and the first failure is raised, a rank's own error before
    the GroupAborted it caused in the others."""
    if len(calls) == 1:
        return [calls[0]()]
    results: list = [None] * len(calls)
    errors: list = [None] * len(calls)

    def body(i: int) -> None:
        try:
            results[i] = calls[i]()
        except BaseException as e:  # re-raised in the caller's thread below
            errors[i] = e
            on_error()

    threads = [threading.Thread(target=body, args=(i,), daemon=True) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        from whisperkit_tpu_torch.parallel.group import GroupAborted

        raise next((e for e in failed if not isinstance(e, GroupAborted)), failed[0])
    return results


class MeshPlan:
    """The device grid `devices[dcn][dp][tp]`. Batch rows shard over the
    dcn x dp cells, dcn-major (cell g = dcn index · dp + dp index); within a
    cell the tp ranks hold the same rows and their own weight shards."""

    def __init__(
        self, devices: Sequence[Sequence[Sequence[torch.device]]], timeout: Optional[float] = None,
        groups: Optional[list] = None,
    ):
        self.devices = [[list(cell) for cell in row] for row in devices]
        self.dcn, self.dp, self.tp = len(self.devices), len(self.devices[0]), len(self.devices[0][0])
        kw = {} if timeout is None else {"timeout": timeout}
        self._streams: Optional[dict] = None
        self.groups: list[Optional[TPGroup]] = groups if groups is not None else [
            TPGroup(cell, **kw) if self.tp > 1 else None for cell in self.cells()
        ]

    def cells(self) -> list[list[torch.device]]:
        """The tp devices of each cell, dcn-major."""
        return [cell for row in self.devices for cell in row]

    @property
    def n_cells(self) -> int:
        return self.dcn * self.dp

    @property
    def first_device(self) -> torch.device:
        return self.devices[0][0][0]

    def distinct_devices(self) -> list[torch.device]:
        seen: list[torch.device] = []
        for cell in self.cells():
            for d in cell:
                if d not in seen:
                    seen.append(d)
        return seen

    def rank(self, g: int, r: int) -> Optional[TPRank]:
        """Cell g's rank r handle (None when tp = 1)."""
        group = self.groups[g]
        return None if group is None else group.rank(r)

    def pad_batch(self, n: int) -> int:
        """Round a batch size up to a multiple of dcn x dp (every cell gets
        equal rows)."""
        m = self.dp * self.dcn
        return ((n + m - 1) // m) * m

    def row_slices(self, n: int) -> list[slice]:
        """Each cell's rows of a batch of n (a multiple of dcn x dp)."""
        if n % self.n_cells:
            raise ValueError(f"a batch of {n} rows does not split over {self.n_cells} mesh cells")
        per = n // self.n_cells
        return [slice(g * per, (g + 1) * per) for g in range(self.n_cells)]

    def _rank_streams(self) -> dict[tuple[int, int], torch.cuda.Stream]:
        """One CUDA stream per mesh thread on a card, made together at the
        plan's first run and kept; none for a mesh of one device."""
        if self._streams is None:
            cells = self.cells()
            many = self.n_cells * self.tp > 1
            self._streams = {
                (g, r): torch.cuda.Stream(cells[g][r]) for g in range(self.n_cells) for r in range(self.tp)
                if many and cells[g][r].type == "cuda"
            }
        return self._streams

    def run(self, fn: Callable[[int, int], Any]) -> list[list[Any]]:
        """fn(cell, rank) in one thread per mesh device, each with its device
        current and, on a card, its own stream current (ordered after the
        caller's work on the device, and the caller's after it) →
        results[cell][rank]. A failure anywhere aborts every tp group and
        is raised here once all threads have ended."""
        for group in self.groups:
            if group is not None:
                group.reset()
        streams = self._rank_streams()
        callers = {dev: torch.cuda.current_stream(dev) for dev in {self.cells()[g][r] for g, r in streams}}
        # the caller's work so far, marked here: a rank that waited on the
        # caller's stream itself could wait behind a peer's end-of-run wait
        # there (below), and so behind the peer's collectives
        started = {dev: stream.record_event() for dev, stream in callers.items()}

        def call(g: int, r: int):
            dev = self.cells()[g][r]
            if dev.type != "cuda":
                return fn(g, r)
            with torch.cuda.device(dev):
                stream = streams.get((g, r))
                if stream is None:
                    return fn(g, r)
                stream.wait_event(started[dev])
                try:
                    with torch.cuda.stream(stream):
                        return fn(g, r)
                finally:
                    callers[dev].wait_stream(stream)

        def abort() -> None:
            for group in self.groups:
                if group is not None:
                    group.abort()

        flat = run_threads(
            [lambda g=g, r=r: call(g, r) for g in range(self.n_cells) for r in range(self.tp)], abort,
        )
        return [flat[g * self.tp : (g + 1) * self.tp] for g in range(self.n_cells)]

    def slice(self, i: int) -> "MeshPlan":
        """dcn slice i as a mesh of its own (dcn = 1), sharing its cells' groups."""
        return MeshPlan([self.devices[i]], groups=self.groups[i * self.dp : (i + 1) * self.dp])


def make_mesh(
    dp: Optional[int] = None, tp: int = 1, dcn: int = 1, devices: Optional[Devices] = None,
    timeout: Optional[float] = None,
) -> MeshPlan:
    """The first dcn · dp · tp of `devices` (every visible card when None,
    as JAX takes `jax.devices()`) as a dcn-major grid; dp defaults to what
    the devices allow."""
    if devices is None:
        resolve_device("cuda")  # raises without a card
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = resolve_devices(devices)
    if dp is None:
        dp = len(devices) // (tp * dcn)
    n = dcn * dp * tp
    if n < 1:
        raise ValueError(f"a mesh of dcn={dcn} dp={dp} tp={tp} has no device")
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = [[devices[(i * dp + j) * tp : (i * dp + j + 1) * tp] for j in range(dp)] for i in range(dcn)]
    return MeshPlan(grid, timeout)


def tree_to(tree, device: torch.device, memo: Optional[dict] = None):
    """A tree of dicts, lists and tuples with its tensors on `device`;
    tensors that share storage and layout stay shared."""
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: tree_to(v, device, memo) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device, memo) for v in tree)
    if isinstance(tree, torch.Tensor):
        key = (tree.data_ptr(), tree.dtype, tuple(tree.shape), tree.stride(), tree.device)
        if key not in memo:
            memo[key] = tree.to(device)
        return memo[key]
    return tree


def shard_params_replicated(plan: MeshPlan, params) -> dict[torch.device, Any]:
    """One copy of `params` per distinct mesh device → {device: tree}."""
    return {d: tree_to(params, d) for d in plan.distinct_devices()}


def shard_batch(plan: MeshPlan, x: torch.Tensor) -> list[list[torch.Tensor]]:
    """x's rows (a multiple of dcn x dp) → parts[cell][rank]: each cell's
    rows on each of its tp devices."""
    cells = plan.cells()
    return [[x[rows].to(d) for d in cells[g]] for g, rows in enumerate(plan.row_slices(x.shape[0]))]


def gather_rows(parts: Sequence[torch.Tensor], device: DeviceLike) -> torch.Tensor:
    """The inverse of shard_batch: one part per cell (say each cell's first
    rank's), concatenated in cell order on `device`."""
    dev = torch.device(device)
    return torch.cat([p.to(dev) for p in parts], 0)


def _tree_cat(outs: list, device: torch.device):
    first = outs[0]
    if isinstance(first, dict):
        return {k: _tree_cat([o[k] for o in outs], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_cat([o[i] for o in outs], device) for i in range(len(first)))
    return gather_rows(outs, device)


def dcn_shard(plan: MeshPlan, fn: Callable, *, batch_argnums: tuple[int, ...]) -> Callable:
    """Wrap fn(sub_plan, *args) so that it runs once per dcn slice, in
    parallel, on that slice's share of the batch arguments and its own
    sub-mesh, and the results (a tensor, or a tree of them, batch-major)
    are concatenated in slice order on the mesh's first device.

    `batch_argnums` name the arguments with a leading axis sharded over
    dcn: a tensor's rows, or a list with one entry per mesh cell (the
    per-cell parameter trees of parallel/sharding.py). Every other argument
    goes to every slice. A slice's call sees only its own cells and their
    tp groups, so no collective can cross slices: the JAX package's manual
    dcn axis, by construction of the threads."""

    def wrapper(*args):
        if plan.dcn <= 1:
            return fn(plan, *args)

        def share(i: int, a):
            n = len(a) if isinstance(a, (list, tuple)) else a.shape[0]
            if n % plan.dcn:
                raise ValueError(f"a batch argument of {n} does not split over dcn={plan.dcn}")
            per = n // plan.dcn
            return a[i * per : (i + 1) * per]

        calls = [
            lambda i=i: fn(plan.slice(i), *(share(i, a) if j in batch_argnums else a for j, a in enumerate(args)))
            for i in range(plan.dcn)
        ]
        return _tree_cat(run_threads(calls), plan.first_device)

    return wrapper


class SharedDraws:
    """Uniform draws in [0, 1) for a whole batch from one generator,
    handed out by rows. The k-th draw of every shape is made once, for all
    `batch` rows, on the generator's device; `rows(sl)` returns a
    generator-like view whose k-th draw is those rows of it. A seed thus
    gives every row the same numbers on one device (where the view's rows
    are the whole batch) and on a mesh of any shape, as JAX's random
    numbers do not depend on the sharding. `batch` is the batch one device
    would draw for: rows the mesh pads in past it repeat its last row's
    draws. Shards step at their own pace; the draws are kept until the
    object is dropped (one decode's worth). On a card a draw is made on the
    drawing thread's stream and an event marks it; a reader's stream waits
    for that event before it reads the draw."""

    def __init__(self, generator: torch.Generator, batch: int):
        self.generator, self.batch = generator, batch
        self._draws: list[torch.Tensor] = []
        self._made: list[Optional[torch.cuda.Event]] = []  # each draw's event, on a card
        self._lock = threading.Lock()

    def _draw(self, k: int, shape: tuple) -> torch.Tensor:
        with self._lock:
            while len(self._draws) <= k:
                draw = torch.rand(
                    (self.batch, *shape), generator=self.generator, device=self.generator.device,
                    dtype=torch.float32,
                )
                made = None
                if draw.is_cuda:
                    made = torch.cuda.Event()
                    made.record(torch.cuda.current_stream(draw.device))
                self._draws.append(draw)
                self._made.append(made)
            draw, made = self._draws[k], self._made[k]
        if made is not None:
            torch.cuda.current_stream(draw.device).wait_event(made)
        return draw

    def rows(self, rows: slice) -> "RowDraws":
        return RowDraws(self, torch.arange(rows.start, rows.stop).clamp(max=self.batch - 1))


class RowDraws:
    """One shard's view of SharedDraws (see there): row i of its batch
    takes row index[i] of every draw."""

    def __init__(self, shared: SharedDraws, index: torch.Tensor, k: int = 0):
        self.shared, self.index, self._k = shared, index, k

    def rand(self, shape, device) -> torch.Tensor:
        """The next draw's rows: [shape[0] = len(index), *shape[1:]] on `device`."""
        if shape[0] != len(self.index):
            raise ValueError(f"a draw of {shape[0]} rows from a view of {len(self.index)}")
        full = self.shared._draw(self._k, tuple(shape[1:]))
        self._k += 1
        return full[self.index.to(full.device)].to(device)

    def take(self, rows: Sequence[int]) -> "RowDraws":
        """The view of a batch gathered down to `rows` (segmented decode's
        compaction): each kept row goes on with its own draws."""
        return RowDraws(self.shared, self.index[torch.as_tensor(list(rows), dtype=torch.long)], self._k)


def uniform(generator, shape, device) -> torch.Tensor:
    """The next uniform draw in [0, 1) of `shape` on `device`, float32,
    from a torch.Generator or a RowDraws view."""
    if isinstance(generator, RowDraws):
        return generator.rand(shape, device)
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniform draws `u`, as `jax.random.gumbel`
    makes it: -log(-log(u)), u clamped to [tiny, 1)."""
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))


def gumbel(generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise of `shape` on `device`, float32, from the
    next draw of a torch.Generator or a RowDraws view."""
    return gumbel_from_uniform(uniform(generator, shape, device))
