"""Build and load the port's hand-written CUDA kernels.

All `csrc/*.cu` sources compile with nvcc, one process per source, all
started together, and link into ONE shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: a build takes seconds,
not minutes). Each exported function takes its pointers and the
CUDA stream as `void*`, launches on that stream, and returns
`cudaGetLastError()` as an int; the Python wrappers raise when it is not 0.

The library is built at first use into `build/whisperkit_tpu_torch/` beside
the package, named by a hash of the sources and flags so an edited kernel
never loads a stale build. Nothing here runs at import time: the CPU tests
import every module on hosts that have no nvcc.

`launches` counts kernel launches per kernel, and `launches_by_device`
per device and kernel: each wrapper adds one where it launches its
kernel, and nowhere else, so a run can show that its main path (and, on a
mesh, every device of it) went through the kernels. The counts are
guarded by a lock: the mesh's worker threads launch at the same time.

A CUDA graph's replay makes no Python call, so while a thread captures a
graph (`recording`) its launches go to a record instead of the counts,
and each replay adds that record to them (`add_launches`): a run counts
what it launched, graph or not.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "whisperkit_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

KERNELS = ("log_mel", "mha_encoder", "cross_attend_q8", "cross_attend_q8_probs", "self_attend", "self_attend_q8",
           "tp_all_reduce", "w8a16_matmul")
launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
launches_by_device: dict[str, dict[str, int]] = {}
_count_lock = threading.Lock()
_load_lock = threading.Lock()
# per thread: the (kernel, device) launches of the graph it is capturing
_capture = threading.local()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)
# C signatures of the exported launchers (csrc/*.cu), all returning int
_SIGNATURES = {
    # padded, basis fragments, mel_w, mel spans, out, batch, n_frames, n_mels, stream
    "wk_log_mel": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # q, k, v, out, strides (9 x int64: B, H, S of q, k, v), batch, heads,
    # query rows, key rows, is_bf16, scale, stream
    "wk_mha_encoder": (_P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong), _I, _I, _I, _I, _I, _F, _P),
    # qi, q_scale, k, v, v_scale, out, batch*heads, t, s, stream
    "wk_cross_attend_q8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # the same, then probs, n_head, head slots (n_head x int8, host), probs
    # strides (3 x int64, host: batch, slot, query row), stream
    "wk_cross_attend_q8_probs": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P,
                                 ctypes.POINTER(ctypes.c_longlong), _P),
    # q, k, v, mask, out, batch*heads, s, is_bf16, stream
    "wk_self_attend": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # qi, q_scale, k, k_scale, v, v_scale, mask, out, batch*heads, s, stream
    "wk_self_attend_q8": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # the ranks' staging buffers and inboxes (host arrays of tp device
    # pointers), tp, rank, ctrl, host words, x, y, elements, dtype, op,
    # slot bytes, timeout ns, stream
    "wk_tp_all_reduce": (_LP, _LP, _I, _I, _P, _P, _P, _P, _L, _I, _I, _L, _L, _P),
    # x, rows, k, then for each of three products sharing x: codes, scale,
    # bias (or null), out, n (0: no product), stream
    "wk_w8a16_matmul": (_P, _I, _I, *(_P, _P, _P, _P, _I) * 3, _P),
    # device, peer (no stream: set-up calls)
    "wk_tp_enable_peer": (_I, _I),
    # bytes, out host pointer, out device pointer
    "wk_tp_host_alloc": (_L, ctypes.POINTER(_P), ctypes.POINTER(_P)),
    "wk_tp_host_free": (_P,),
}


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0 when an identical earlier build was reused
    log: str  # nvcc's output, with the `-Xptxas -v` report


_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0
        launches_by_device.clear()


def _count(kernel: str, device: str, n: int = 1) -> None:
    """Add n launches of `kernel` on `device`; the caller holds _count_lock."""
    launches[kernel] += n
    launches_by_device.setdefault(device, dict.fromkeys(KERNELS, 0))[kernel] += n


@contextlib.contextmanager
def recording() -> Iterator[list[tuple[str, str]]]:
    """While a CUDA graph is captured on this thread: `launch` appends
    (kernel, device) to the yielded list instead of counting."""
    record: list[tuple[str, str]] = []
    _capture.record = record
    try:
        yield record
    finally:
        _capture.record = None


def add_launches(record: list[tuple[str, str]]) -> None:
    """Count the launches of one replay of a graph whose capture `recording`
    gave `record`."""
    with _count_lock:
        for kernel, device in record:
            _count(kernel, device)


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwktpu_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> BuildResult:
    """Compile csrc/*.cu into the shared library, or reuse an identical
    earlier build. Each source compiles in its own nvcc process, all
    running at once, then one nvcc links the objects."""
    path = _library_path()
    if path.exists() and not force:
        return BuildResult(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{path.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        log = BUILD_DIR / f"{stem}.{src.stem}.log"
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=out, stderr=subprocess.STDOUT,
            )
        jobs.append((src, obj, log, proc))
    logs, failed, objs = [], [], []
    for src, obj, log, proc in jobs:
        rc = proc.wait()
        text = log.read_text()
        log.unlink()
        logs.append(f"{src.name}:\n{text}")
        if rc != 0:
            failed.append(f"{src.name} (rc={rc}):\n{text}")
        objs.append(obj)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            failed.append(f"link (rc={link.returncode}):\n{link.stdout}{link.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, path)
    return BuildResult(path, time.perf_counter() - t0, "\n".join(logs))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (once, whichever
    thread asks first; the others wait for it)."""
    global _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call one exported launcher for tensors on `device`: with `device`
    the CUDA runtime's current device (the launcher's attribute calls and
    its launch act on the current device) and on `device`'s current
    stream, whatever device the calling thread had made current. Raise on
    a non-zero launch status; count the launch, or record it while this
    thread captures a graph (`recording`)."""
    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        status = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if status != 0:
        raise RuntimeError(f"{fn_name} launch failed with CUDA error {status}")
    record = getattr(_capture, "record", None)
    if record is not None:
        record.append((kernel, str(device)))
        return
    with _count_lock:
        _count(kernel, str(device))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, t: torch.Tensor, dtype, ndim: int, contiguous: bool = True) -> None:
    """Raise unless `t` is a CUDA tensor of `dtype` and rank, contiguous
    unless `contiguous` is False."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
