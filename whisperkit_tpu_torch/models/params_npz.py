"""The JAX package's pre-converted parameter files: `segmenter.npz` +
`embedder.npz` (diarization) and `qwen3_tts.npz` (text-to-speech), each
`np.savez(path, params=tree)` of a nested dict/list tree of numpy arrays,
which the JAX pipelines read with `np.load(path, allow_pickle=True)
["params"].item()`.

The tree is a pickle, and unpickling can import and run code: a pickled
`jax.Array` leaf imports JAX, which the port never does. So the pickle is
read here by an unpickler that resolves numpy's array machinery (and
ml_dtypes' bfloat16, which numpy arrays of bf16 name) and refuses every
other global with an error that says how to re-save the file.
"""

from __future__ import annotations

import pickle
import zipfile
from pathlib import Path
from typing import Any, Union

import numpy as np

# the globals a pickled tree of numpy arrays names (numpy 1.x and 2.x)
_ALLOWED = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("ml_dtypes", "bfloat16"),
}


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the params tree names {module}.{name}; only numpy arrays are read (a jax.Array leaf needs "
            "JAX to unpickle): save the tree as numpy, np.savez(path, params=jax.tree.map(np.asarray, params))"
        )


def _check_leaves(node, path: str = "params") -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _check_leaves(v, f"{path}[{k!r}]")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _check_leaves(v, f"{path}[{i}]")
    elif not isinstance(node, np.ndarray):
        raise TypeError(f"{path} is a {type(node).__name__}, not a numpy array")


def read_params_npz(path: Union[str, Path]) -> dict:
    """The `params` tree of a JAX package's pre-converted .npz file, every
    leaf a numpy array (TypeError naming the first leaf that is not one;
    pickle.UnpicklingError for a global outside numpy's array machinery)."""
    with zipfile.ZipFile(path) as zf, zf.open("params.npy") as f:
        version = np.lib.format.read_magic(f)
        read_header = np.lib.format.read_array_header_1_0 if version == (1, 0) else \
            np.lib.format.read_array_header_2_0
        shape, _, dtype = read_header(f)
        if shape != () or dtype != np.dtype(object):
            raise ValueError(f"{Path(path).name}: params is a {dtype} array of shape {shape}, not a pickled tree")
        tree = _NumpyOnlyUnpickler(f).load().item()
    if not isinstance(tree, dict):
        raise TypeError(f"{Path(path).name}: params holds a {type(tree).__name__}, not a dict tree")
    _check_leaves(tree)
    return tree
