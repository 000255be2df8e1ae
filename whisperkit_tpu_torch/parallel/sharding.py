"""Tensor-parallel parameter sharding for Whisper (port of
whisperkit_tpu/parallel/sharding.py).

The Megatron split, as the JAX package's rules state it: the attention
q/k/v weights and the MLP's fc1 split by columns (each rank holds
n_head / tp heads, or 4·d / tp hidden units), the attention out and fc2
split by rows (each rank's product is a partial sum, all-reduced by the
model, models/whisper.py, with the bias added once after the sum);
everything else (embeddings, norms, convolutions) is replicated. In the
JAX package XLA inserts the sums from the arrays' NamedShardings; here
`whisper_param_shardings` names each leaf's role and
`shard_whisper_params` cuts one tree per tp rank, each carrying its rank's
handle under the key "tp", which the model functions read.

  "col"  split the last (output) axis: w, w_q, w_q4, b, scale, scale4
         under q, k, v and fc1
  "row"  split the first (input) axis: w, w_q and w_q4 under out and fc2
  "rep"  everything else, a row-split linear's scale, scale4 and bias too

A row-split W4A16 weight is packed by half-planes (byte p holds input row
p in its low nibble and row p + in/2 in its high one), so a contiguous
slice of the packed bytes would hold two separate input slices: the shard
is cut from the unpacked codes and packed again over its own rows, with
the scale groups (`scale4`, 64 rows each) that cover those rows.

`encoder_seq_sharding` is the sequence-parallel mode of the encoder: the
parameters replicated, the 1500 frames split over a cell's tp ranks.
"""

from __future__ import annotations

from typing import Any

import torch

from whisperkit_tpu_torch.ops.quant import _unpack4_planes
from whisperkit_tpu_torch.parallel.group import TPRank
from whisperkit_tpu_torch.parallel.mesh import MeshPlan, shard_params_replicated, tree_to

_COL_KEYS = frozenset({"q", "k", "v", "fc1"})
_ROW_KEYS = frozenset({"out", "fc2"})
_WEIGHT_KEYS = ("w", "w_q", "w_q4")


def _role(key, parent) -> str:
    if parent in _COL_KEYS and key in (*_WEIGHT_KEYS, "b", "scale", "scale4"):
        return "col"
    if parent in _ROW_KEYS and key in _WEIGHT_KEYS:
        return "row"
    return "rep"


def whisper_param_shardings(plan: MeshPlan, params) -> dict:
    """The roles tree ("col", "row", "rep") mirroring the port's parameter
    tree (models/whisper.py), built by walking it as the JAX package walks
    its tree: a list's items take the list's key, so a layer's leaves are
    judged by their linear's name. bf16, W8A16 and W4A16 trees alike."""
    del plan  # the roles do not depend on the grid; the JAX signature is kept

    def walk(node, key=None, parent=None):
        if isinstance(node, dict):
            return {k: walk(v, k, key) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key, parent) for v in node)
        return _role(key, parent)

    return walk(params)


def _cut(x: torch.Tensor, role: str, r: int, tp: int) -> torch.Tensor:
    axis = -1 if role == "col" else 0
    n = x.shape[axis]
    if n % tp:
        raise ValueError(f"a {role}-split axis of {n} does not divide over tp={tp}")
    per = n // tp
    return x.narrow(axis, r * per, per).contiguous()


def _row_shard_w4(lin: dict, r: int, tp: int) -> dict:
    """Rank r's rows of a row-split {"w_q4", "scale4", ...} linear, packed
    again over its own rows, with the scale groups that cover them."""
    lo, hi = _unpack4_planes(lin["w_q4"])
    codes = torch.cat([lo, hi], 0)  # [in, out] in [-7, 7]
    din = codes.shape[0]
    if din % (2 * tp):
        raise ValueError(f"a W4A16 row split needs an even shard of {din} rows over tp={tp}")
    n = din // tp
    u = (codes[r * n : (r + 1) * n] + 8).to(torch.uint8)
    scale4 = lin["scale4"]
    rows_per_group = din // scale4.shape[0]
    start = r * n
    if n % rows_per_group == 0:
        scale = scale4[start // rows_per_group : (start + n) // rows_per_group]
    elif rows_per_group % n == 0:  # the shard lies inside one group
        scale = scale4[start // rows_per_group : start // rows_per_group + 1]
    else:
        raise ValueError(f"a shard of {n} rows does not line up with W4A16 groups of {rows_per_group} rows")
    out = {k: v for k, v in lin.items() if k not in ("w_q4", "scale4")}
    out["w_q4"] = u[: n // 2] | (u[n // 2 :] << 4)
    out["scale4"] = scale.contiguous()
    return out


def shard_rank(params, r: int, tp: int):
    """Rank r's tree of `params` under a tp-way Megatron split (on the
    weights' device)."""
    roles = whisper_param_shardings(None, params)

    def walk(node, role):
        if isinstance(node, dict):
            if "w_q4" in node and role.get("w_q4") == "row":
                node = _row_shard_w4(node, r, tp)
                return {k: v if k in ("w_q4", "scale4") else walk(v, role[k]) for k, v in node.items()}
            return {k: walk(v, role[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, rl) for v, rl in zip(node, role))
        if role == "rep" or not isinstance(node, torch.Tensor):
            return node
        return _cut(node, role, r, tp)

    return walk(params, roles)


def shard_whisper_params(plan: MeshPlan, params) -> list[list[Any]]:
    """The tree of each mesh cell's rank, trees[cell][rank], on its device:
    replicated when tp = 1 (one copy per distinct device); with tp > 1
    rank r's Megatron shard (one copy per distinct device and rank), with
    its cell's rank handle under "tp"."""
    cells = plan.cells()
    if plan.tp <= 1:
        copies = shard_params_replicated(plan, params)
        return [[copies[d] for d in cell] for cell in cells]
    shards = [shard_rank(params, r, plan.tp) for r in range(plan.tp)]
    placed: dict = {}
    trees = []
    for g, cell in enumerate(cells):
        row = []
        for r, d in enumerate(cell):
            if (d, r) not in placed:
                placed[(d, r)] = tree_to(shards[r], d)
            row.append({**placed[(d, r)], "tp": plan.rank(g, r)})
        trees.append(row)
    return trees


def encoder_seq_sharding(plan: MeshPlan) -> list[list[TPRank]]:
    """The sequence-parallel plan of `encoder_forward(seq_group=...)`:
    each cell's tp ranks, sp[cell][rank]; rank r encodes frames
    [r·T/tp, (r+1)·T/tp) over replicated parameters and gathers the
    layers' K and V. Needs tp > 1."""
    if plan.tp <= 1:
        raise ValueError("sequence parallelism splits the frames over tp ranks; the mesh has tp = 1")
    return [[plan.rank(g, r) for r in range(plan.tp)] for g in range(plan.n_cells)]
