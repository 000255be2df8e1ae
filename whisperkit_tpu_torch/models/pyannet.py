"""The published speaker models, PyanNet segmenter and WeSpeaker ResNet34
embedder, with their checkpoint converters (port of
whisperkit_tpu/models/pyannet.py).

Reference: Sources/SpeakerKit/Pyannote/PyannoteModelManager.swift:63-147
loads pre-compiled segmenter/embedder models (variants
PyannoteConfig.swift:11-41). These functions compute the published
architectures, so public torch checkpoints convert and give the same
outputs:

  * PyanNet (pyannote/segmentation-3.0): SincNet front end (the ParamSincFB
    251-tap filterbank materialized to a plain conv at conversion, stride
    10, 3×(pool 3 + InstanceNorm + leaky_relu)), a 4-layer BiLSTM(128),
    2×Linear(128)+leaky_relu, a classifier → log-softmax over the 7
    powerset classes (≤3 speakers, ≤2 at once).
  * WeSpeaker ResNet34 (wespeaker-voxceleb-resnet34-LM): fbank [B,T,80] →
    one-channel 2D ResNet34 (BatchNorms folded into the convs at
    conversion), temporal statistics pooling, linear → 256-d embedding.

A parameter tree is the JAX package's, with torch tensors for leaves:
nested dicts and lists, a W8A16 leaf the dict {"w_q", "scale"}
(ops/quant.quantize_speaker_params), dequantized in the activation dtype
where it is used. The forward functions take a tree prepared for its
device (`prepare_params`), its LSTM stack built once into an `nn.LSTM`.
Activations are float32, as in the JAX package, whatever the weights'
dtype. The JAX package computes these models in XLA (no
Pallas kernel), so here they are torch's own ops: `F.conv1d`/`F.conv2d`,
`nn.LSTM` (cuDNN on the card), `torch.matmul`, in IEEE float32 on the
card (`core.device.ieee_float32`) whatever the process's TF32 flags.

Converters take torch-style state dicts (name → tensor or array) under the
published names (`sincnet.conv1d.0.filterbank.low_hz_`,
`lstm.weight_ih_l0`, `layer1.0.conv1.weight`, ...).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping, Union

import numpy as np
import torch
import torch.nn.functional as F

from whisperkit_tpu_torch.core.device import ieee_float32

Params = Any

SAMPLE_RATE = 16_000

# powerset classes of pyannote/segmentation-3.0: ≤3 speakers, ≤2 active
POWERSET_CLASSES: tuple[tuple[int, ...], ...] = (
    (), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2),
)


# ---------------------------------------------------------------------------
# SincNet filterbank materialization
# ---------------------------------------------------------------------------


def sinc_filters(
    low_hz: np.ndarray,  # [F, 1] learned
    band_hz: np.ndarray,  # [F, 1] learned
    kernel_size: int = 251,
    sample_rate: int = SAMPLE_RATE,
    min_low_hz: float = 50.0,
    min_band_hz: float = 50.0,
) -> np.ndarray:
    """Materialize the parametric sinc band-pass filterbank → [F, 1, K].

    Published SincNet/ParamSincFB construction (Ravanelli & Bengio 2018;
    asteroid_filterbanks ParamSincFB, used by pyannote's SincNet block):
    Hamming-windowed difference of sincs with per-filter learned (low, band).
    Computed once at conversion time, so the TPU runtime sees a plain conv.
    """
    low = min_low_hz + np.abs(low_hz)  # [F, 1]
    high = np.clip(
        low + min_band_hz + np.abs(band_hz), min_low_hz, sample_rate / 2
    )
    band = (high - low)[:, 0]  # [F]

    half = kernel_size // 2
    # published construction: linspace(0, K/2 - 1, K//2) — for odd K the
    # endpoint is fractional (124.5 for K=251), NOT half-1. The torch-parity
    # test shares this function on both sides, so it can't cross-check this
    # constant; it is pinned against asteroid_filterbanks ParamSincFB here.
    n_lin = np.linspace(0, kernel_size / 2 - 1, half)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * n_lin / kernel_size)  # [K//2]
    n_ = 2 * np.pi * np.arange(-half, 0)[None, :] / sample_rate  # [1, K//2]

    f_low = low * n_  # [F, K//2]
    f_high = high * n_
    left = ((np.sin(f_high) - np.sin(f_low)) / (n_ / 2)) * window[None, :]
    center = 2 * band[:, None]
    right = left[:, ::-1]
    filters = np.concatenate([left, center, right], axis=1)  # [F, K]
    filters = filters / (2 * band[:, None])
    return filters[:, None, :].astype(np.float32)  # [F, 1, K]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _w(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight leaf in `dtype`; a W8A16 leaf {"w_q", "scale"} is
    dequantized in `dtype` (the JAX package's `_w` with the activation
    dtype): the int8 code times the bf16 scale, both exact in float32."""
    if isinstance(w, dict) and "w_q" in w:
        return w["w_q"].to(dtype) * w["scale"].to(dtype)
    return w.to(dtype)


@torch.no_grad()
def lstm_module(lstms: list) -> torch.nn.LSTM:
    """A tree's stack of bidirectional LSTM layers (torch gate order i, f,
    g, o), each direction {"wx" [in, 4H], "wh" [H, 4H], "b" [4H]} as in
    the JAX package's `lax.scan`, as one float32 `nn.LSTM` on the leaves'
    device (cuDNN on the card): the weights dequantized and transposed
    back, the combined bias in `bias_ih`, `bias_hh` zero. Built once per
    loaded tree (`prepare_params`); the forward functions call it."""
    wh = _w(lstms[0]["fwd"]["wh"], torch.float32)
    lstm = torch.nn.LSTM(_w(lstms[0]["fwd"]["wx"], torch.float32).shape[0], wh.shape[0], num_layers=len(lstms),
                         bidirectional=True, batch_first=True, device=wh.device)
    for i, lp in enumerate(lstms):
        for suffix, d in (("", "fwd"), ("_reverse", "bwd")):
            getattr(lstm, f"weight_ih_l{i}{suffix}").copy_(_w(lp[d]["wx"], torch.float32).T)
            getattr(lstm, f"weight_hh_l{i}{suffix}").copy_(_w(lp[d]["wh"], torch.float32).T)
            getattr(lstm, f"bias_ih_l{i}{suffix}").copy_(lp[d]["b"].float())
            getattr(lstm, f"bias_hh_l{i}{suffix}").zero_()
    return lstm.requires_grad_(False).eval()


def prepare_params(params: Params, device) -> Params:
    """A loaded tree (a converter's, an `init_*`'s, or either in a variant)
    on `device`, as the forward functions take it: a segmenter's `lstms`
    list becomes the `nn.LSTM` under `lstm` (`lstm_module`)."""
    out = tree_to(params, device)
    if "lstms" in out:
        out["lstm"] = lstm_module(out.pop("lstms"))
    return out


def tree_to(params: Params, device=None, dtype_fn=None) -> Params:
    """Map every tensor leaf of a tree: `.to(device)`, then `dtype_fn(leaf)`
    where given."""
    if isinstance(params, dict):
        return {k: tree_to(v, device, dtype_fn) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(tree_to(v, device, dtype_fn) for v in params)
    if isinstance(params, torch.Tensor):
        out = params.to(device) if device is not None else params
        return dtype_fn(out) if dtype_fn is not None else out
    return params


def params_from_numpy(tree) -> Params:
    """A JAX speaker tree as numpy arrays (`jax.tree.map(np.asarray,
    params)`, or a `segmenter.npz`/`embedder.npz` file's) → the port's
    tree of CPU tensors, the same structure: float32 leaves stay float32,
    bf16 leaves bf16, integer leaves (W8A16 codes) keep their dtype."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# PyanNet forward
# ---------------------------------------------------------------------------


def _instance_norm(x: torch.Tensor, g, b, eps: float = 1e-5) -> torch.Tensor:
    """x [B, C, T]: normalize per (instance, channel) over time."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * g[None, :, None] + b[None, :, None]


def _conv1d_valid(x, w, b=None, stride: int = 1) -> torch.Tensor:
    """x [B, C, T], w [O, I, K], no padding (torch's default)."""
    return F.conv1d(x, _w(w, x.dtype), b, stride)


@ieee_float32()
@torch.no_grad()
def pyannet_forward(params: Params, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, T] float32 (10 s windows in the published model) →
    log-softmax powerset probabilities [B, F, 7].

    Frame grid: conv stride 10 then 3× pool 3 (floor) → 270 samples per
    frame (589 frames per 10 s window)."""
    x = audio.float()[:, None, :]  # [B, 1, T]
    x = _instance_norm(x, params["wav_norm"]["g"], params["wav_norm"]["b"])

    # block 0: materialized sinc filterbank (no bias) + |.| + pool + IN
    x = torch.abs(_conv1d_valid(x, params["sinc"]["w"], stride=10))
    x = F.max_pool1d(x, 3)
    x = F.leaky_relu(_instance_norm(x, params["norm0"]["g"], params["norm0"]["b"]), 0.01)
    for conv, norm in (("conv1", "norm1"), ("conv2", "norm2")):
        x = _conv1d_valid(x, params[conv]["w"], params[conv]["b"])
        x = F.max_pool1d(x, 3)
        x = F.leaky_relu(_instance_norm(x, params[norm]["g"], params[norm]["b"]), 0.01)

    x = params["lstm"](x.transpose(1, 2))[0]  # [B, F, 2H]
    for lin in params["linears"]:
        x = F.leaky_relu(x @ _w(lin["w"], x.dtype) + lin["b"], 0.01)
    logits = x @ _w(params["cls"]["w"], x.dtype) + params["cls"]["b"]  # [B, F, 7]
    return torch.log_softmax(logits, dim=-1)


def powerset_to_activity(log_probs: torch.Tensor) -> torch.Tensor:
    """[B, F, 7] powerset log-probs → [B, F, 3] hard per-speaker activity."""
    mapping = torch.zeros((len(POWERSET_CLASSES), 3), dtype=torch.float32, device=log_probs.device)
    for ci, members in enumerate(POWERSET_CLASSES):
        for m in members:
            mapping[ci, m] = 1.0
    return mapping[torch.argmax(log_probs, dim=-1)]


def _numpy_state_dict(state_dict: Mapping[str, Any]) -> dict[str, np.ndarray]:
    return {
        k: (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in state_dict.items()
    }


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def convert_pyannote_segmentation(state_dict: Mapping[str, Any]) -> Params:
    """Name-map a pyannote/segmentation-3.0 PyanNet state dict into a float32
    CPU tree.

    Published key layout (pyannote.audio PyanNet + SincNet blocks):
      sincnet.wav_norm1d.{weight,bias}
      sincnet.conv1d.0.filterbank.{low_hz_,band_hz_}
      sincnet.conv1d.{1,2}.{weight,bias}
      sincnet.norm1d.{0,1,2}.{weight,bias}
      lstm.{weight_ih_l{k},weight_hh_l{k},bias_ih_l{k},bias_hh_l{k}}[ _reverse]
      linear.{0,1}.{weight,bias}
      classifier.{weight,bias}
    """
    sd = _numpy_state_dict(state_dict)

    def lstm_dir(layer: int, reverse: bool):
        sfx = f"l{layer}" + ("_reverse" if reverse else "")
        return {
            "wx": _t(sd[f"lstm.weight_ih_{sfx}"].T),
            "wh": _t(sd[f"lstm.weight_hh_{sfx}"].T),
            "b": _t(sd[f"lstm.bias_ih_{sfx}"] + sd[f"lstm.bias_hh_{sfx}"]),
        }

    n_lstm = max(
        int(k.split("_l")[-1].replace("_reverse", "")) for k in sd if k.startswith("lstm.weight_ih_l")
    ) + 1
    n_linear = len({k for k in sd if k.startswith("linear.")}) // 2

    def affine(name):
        return {"g": _t(sd[f"{name}.weight"]), "b": _t(sd[f"{name}.bias"])}

    def conv(name):
        return {"w": _t(sd[f"{name}.weight"]), "b": _t(sd[f"{name}.bias"])}

    return {
        "wav_norm": affine("sincnet.wav_norm1d"),
        "sinc": {
            "w": _t(sinc_filters(sd["sincnet.conv1d.0.filterbank.low_hz_"],
                                 sd["sincnet.conv1d.0.filterbank.band_hz_"]))
        },
        "norm0": affine("sincnet.norm1d.0"),
        "conv1": conv("sincnet.conv1d.1"),
        "norm1": affine("sincnet.norm1d.1"),
        "conv2": conv("sincnet.conv1d.2"),
        "norm2": affine("sincnet.norm1d.2"),
        "lstms": [{"fwd": lstm_dir(i, False), "bwd": lstm_dir(i, True)} for i in range(n_lstm)],
        "linears": [
            {"w": _t(sd[f"linear.{i}.weight"].T), "b": _t(sd[f"linear.{i}.bias"])} for i in range(n_linear)
        ],
        "cls": {"w": _t(sd["classifier.weight"].T), "b": _t(sd["classifier.bias"])},
    }


# ---------------------------------------------------------------------------
# WeSpeaker ResNet34 embedder
# ---------------------------------------------------------------------------


def _conv2d_same(x, w, b=None, stride: int = 1) -> torch.Tensor:
    """x [B, C, H, W], w [O, I, kh, kw], padding kh//2, kw//2 on both sides
    (torch padding=1 for 3×3, 0 for 1×1)."""
    w = _w(w, x.dtype)
    return F.conv2d(x, w, b, stride, (w.shape[2] // 2, w.shape[3] // 2))


def _basic_block(x, bp) -> torch.Tensor:
    # ResNet34: a downsample branch exists exactly on the stride-2 blocks
    stride = 2 if "down" in bp else 1
    out = torch.relu(_conv2d_same(x, bp["conv1"]["w"], bp["conv1"]["b"], stride))
    out = _conv2d_same(out, bp["conv2"]["w"], bp["conv2"]["b"], 1)
    sc = _conv2d_same(x, bp["down"]["w"], bp["down"]["b"], stride) if "down" in bp else x
    return torch.relu_(out + sc)


def _resnet_trunk(params: Params, fbank: torch.Tensor) -> torch.Tensor:
    """fbank [B, T, n_mels] → features [B, C·H, T/8]."""
    x = fbank.transpose(1, 2)[:, None]  # [B, 1, n_mels, T]
    x = torch.relu(_conv2d_same(x, params["conv1"]["w"], params["conv1"]["b"], 1))
    for layer in ("layer1", "layer2", "layer3", "layer4"):
        for bp in params[layer]:
            x = _basic_block(x, bp)
    b, c, h, t = x.shape
    return x.reshape(b, c * h, t)


@ieee_float32()
@torch.no_grad()
def wespeaker_resnet_forward(params: Params, fbank: torch.Tensor) -> torch.Tensor:
    """fbank [B, T, n_mels] (mean-normalized, per WeSpeaker convention) →
    embedding [B, 256] (not normalized).

    BatchNorms are folded into the convs at conversion (inference only), so
    each block is conv→relu→conv→(+shortcut)→relu."""
    feat = _resnet_trunk(params, fbank.float())
    mean = feat.mean(-1)
    std = torch.sqrt(torch.clamp(((feat - mean[..., None]) ** 2).mean(-1), min=1e-7))
    stats = torch.cat([mean, std], dim=-1)  # [B, 2·C·H]
    return stats @ _w(params["seg_1"]["w"], stats.dtype) + params["seg_1"]["b"]


def _fold_bn(conv_w, conv_b, bn_w, bn_b, bn_mean, bn_var, eps=1e-5):
    """Fold an eval-mode BatchNorm into the preceding conv (inference only)."""
    scale = bn_w / np.sqrt(bn_var + eps)  # [O]
    w = conv_w * scale[:, None, None, None]
    b = (0.0 if conv_b is None else conv_b) * scale + bn_b - bn_mean * scale
    return _t(w), _t(b)


def resnet_blocks(keys) -> dict[str, int]:
    """Blocks per layer, counted from a WeSpeaker state dict's keys
    (`layer{L}.{i}.conv1.weight`): (3, 4, 6, 3) for ResNet34."""
    counts: dict[str, int] = {}
    for k in keys:
        m = re.match(r"(layer[1-4])\.(\d+)\.conv1\.weight$", k)
        if m:
            counts[m.group(1)] = max(counts.get(m.group(1), 0), int(m.group(2)) + 1)
    return {layer: counts[layer] for layer in ("layer1", "layer2", "layer3", "layer4")}


def convert_wespeaker_resnet34(state_dict: Mapping[str, Any], prefix: str = "") -> Params:
    """Name-map a WeSpeaker ResNet34 state dict (wespeaker resnet.py naming:
    conv1/bn1, layer{1..4}.{i}.{conv1,bn1,conv2,bn2,downsample.{0,1}},
    seg_1) into a float32 CPU tree, folding eval-mode BatchNorms into the
    convs. The blocks per layer come from the keys (`resnet_blocks`)."""
    sd = {k[len(prefix):]: v for k, v in _numpy_state_dict(state_dict).items() if k.startswith(prefix)}

    def fold(conv_key, bn_key):
        return _fold_bn(
            sd[f"{conv_key}.weight"],
            sd.get(f"{conv_key}.bias"),
            sd[f"{bn_key}.weight"],
            sd[f"{bn_key}.bias"],
            sd[f"{bn_key}.running_mean"],
            sd[f"{bn_key}.running_var"],
        )

    w, b = fold("conv1", "bn1")
    params: dict[str, Any] = {"conv1": {"w": w, "b": b}}
    for layer, n_blocks in resnet_blocks(sd).items():
        blocks = []
        for i in range(n_blocks):
            base = f"{layer}.{i}"
            w1, b1 = fold(f"{base}.conv1", f"{base}.bn1")
            w2, b2 = fold(f"{base}.conv2", f"{base}.bn2")
            bp: dict[str, Any] = {"conv1": {"w": w1, "b": b1}, "conv2": {"w": w2, "b": b2}}
            if f"{base}.downsample.0.weight" in sd:
                wd, bd = fold(f"{base}.downsample.0", f"{base}.downsample.1")
                bp["down"] = {"w": wd, "b": bd}
            blocks.append(bp)
        params[layer] = blocks
    params["seg_1"] = {"w": _t(sd["seg_1.weight"].T), "b": _t(sd["seg_1.bias"])}
    return params


# ---------------------------------------------------------------------------
# Checkpoint file loading
# ---------------------------------------------------------------------------


def read_state_dict(path: Union[str, Path]) -> dict[str, torch.Tensor]:
    """A torch .bin/.ckpt (loaded on the CPU, tensors only, a Lightning
    {"state_dict": ...} unwrapped) or a .safetensors file (the port's own
    reader, models/loader.py) → name → CPU tensor."""
    path = Path(path)
    if path.suffix == ".safetensors":
        from whisperkit_tpu_torch.models.loader import _read_safetensors_file

        return _read_safetensors_file(path)
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_pyannote_segmentation(path: Union[str, Path]) -> Params:
    """Load + convert a pyannote/segmentation-3.0 checkpoint file.

    Lightning checkpoints prefix the module ('model.'); plain state dicts
    don't; both are accepted."""
    sd = read_state_dict(path)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return convert_pyannote_segmentation(sd)


def load_wespeaker_resnet34(path: Union[str, Path]) -> Params:
    """Load + convert a WeSpeaker ResNet34 checkpoint file (optionally
    wrapped with a 'speaker_extractor.'/'resnet.'/'model.' prefix)."""
    sd = read_state_dict(path)
    for prefix in ("speaker_extractor.", "resnet.", "model."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break
    return convert_wespeaker_resnet34(sd)


# ---------------------------------------------------------------------------
# Masked embedding (speaker-selective, fixed shapes)
# ---------------------------------------------------------------------------


@ieee_float32()
@torch.no_grad()
def wespeaker_embed_masked(
    params: Params,
    fbank: torch.Tensor,  # [B, T, n_mels]
    frame_mask: torch.Tensor,  # [B, T] 1.0 at the target speaker's frames
) -> torch.Tensor:
    """Per-speaker embedding with fixed shapes: the active frames are
    compacted to the front (a stable argsort, the fixed-shape analogue of
    pyannote's per-speaker cropping), CMN is computed over the active frames
    only, and the statistics pooling covers ceil(n_active / 8) frames of
    the trunk's output. Returns [B, E], not normalized (the caller
    L2-normalizes)."""
    fbank = fbank.float()
    t = fbank.shape[1]
    active = frame_mask > 0.5
    order = torch.argsort((~active).to(torch.int8), dim=1, stable=True)  # active first
    fb = torch.take_along_dim(fbank, order[..., None], dim=1)
    n_active = active.sum(dim=1)  # [B]

    # cepstral mean over the active frames only (the pipeline computes the
    # fbank without mean_norm when masks are in play)
    valid = torch.arange(t, device=fbank.device)[None, :] < n_active[:, None]  # after compaction
    denom = torch.clamp_min(n_active, 1)[:, None, None]
    mean = (fb * valid[..., None]).sum(dim=1, keepdim=True) / denom
    fb = torch.where(valid[..., None], fb - mean, 0.0)

    # ResNet trunk (stride 8 in time), then masked statistics pooling
    feat = _resnet_trunk(params, fb)
    t8 = feat.shape[-1]
    t_valid = torch.clamp_min(torch.ceil(n_active / 8).to(torch.int32), 1)  # [B]
    w = (torch.arange(t8, device=feat.device)[None, :] < t_valid[:, None])[:, None, :].to(feat.dtype)
    denom8 = t_valid[:, None].to(feat.dtype)
    mean8 = (feat * w).sum(-1) / denom8
    var8 = ((feat - mean8[..., None]) ** 2 * w).sum(-1) / denom8
    stats = torch.cat([mean8, torch.sqrt(torch.clamp(var8, min=1e-7))], dim=-1)
    return stats @ _w(params["seg_1"]["w"], stats.dtype) + params["seg_1"]["b"]
