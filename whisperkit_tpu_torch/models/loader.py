"""Checkpoint loading: HF-format Whisper safetensors → the port's parameter
tree (port of whisperkit_tpu/models/loader.py).

Reference behavior: Sources/WhisperKit/Core/WhisperKit.swift:358-442
`loadModels` (detect model files, load per-component, sniff variant from
dims — ModelUtilities.swift:128-173). The artifact format is HF
`transformers` Whisper (config.json + *.safetensors), the de-facto
distribution format for Whisper weights.

The safetensors files are read here, without the `safetensors` package:
an 8-byte little-endian header length, a JSON header, then each tensor's
bytes at its `data_offsets`, taken from a memory map with
`torch.frombuffer` (BF16 included, which numpy cannot hold).

The JAX package's on-disk converted and quantized caches (Orbax) are not
ported: this loader neither reads nor writes `converted.orbax`,
`converted_dims.json` or `quantized_<scheme>.orbax`, so a folder that
holds them loads from its safetensors here.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from whisperkit_tpu_torch.core.device import DeviceLike, resolve_device
from whisperkit_tpu_torch.core.errors import ModelsUnavailable
from whisperkit_tpu_torch.core.logging import logging
from whisperkit_tpu_torch.models.whisper import WhisperDims, _with_logits_weight, sinusoidal_positions

# safetensors dtype names → torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


def dims_from_hf_config(cfg: dict) -> WhisperDims:
    return WhisperDims(
        n_mels=cfg.get("num_mel_bins", 80),
        n_vocab=cfg["vocab_size"],
        n_audio_ctx=cfg.get("max_source_positions", 1500),
        n_audio_state=cfg["d_model"],
        n_audio_head=cfg["encoder_attention_heads"],
        n_audio_layer=cfg["encoder_layers"],
        n_text_ctx=cfg.get("max_target_positions", 448),
        n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"],
        n_text_layer=cfg["decoder_layers"],
    )


def _read_safetensors_file(path: Path) -> dict[str, torch.Tensor]:
    """One .safetensors file → CPU tensors that view a private memory map
    of it (no copy until a tensor is moved or converted)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ModelsUnavailable(f"{path.name}: too short for a safetensors header")
        (n_header,) = struct.unpack("<Q", head)
        try:
            header = json.loads(f.read(n_header))
        except ValueError as e:
            raise ModelsUnavailable(f"{path.name}: unreadable safetensors header: {e}") from e
        size = path.stat().st_size
        # copy-on-write: torch.frombuffer wants a writable buffer; nothing
        # is written, so no page is copied
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n_header else None
    base = 8 + n_header
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise ModelsUnavailable(f"{path.name}: tensor {name} has unsupported dtype {info.get('dtype')!r}")
        shape = [int(d) for d in info["shape"]]
        begin, end = (int(x) for x in info["data_offsets"])
        count = int(np.prod(shape)) if shape else 1
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or base + end > size:
            raise ModelsUnavailable(f"{path.name}: tensor {name} has offsets {begin}..{end} for {count} items")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin).reshape(shape)
    return out


def _read_safetensors(folder: Path) -> dict[str, torch.Tensor]:
    """Every *.safetensors file of `folder` (sharded checkpoints included)."""
    tensors: dict[str, torch.Tensor] = {}
    files = sorted(Path(folder).glob("*.safetensors"))
    if not files:
        raise ModelsUnavailable(f"no .safetensors files in {folder}")
    for f in files:
        tensors.update(_read_safetensors_file(f))
    return tensors


def load_whisper(
    folder: Union[str, Path],
    dtype: torch.dtype = torch.bfloat16,
    quantization: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> tuple[WhisperDims, dict, Optional[np.ndarray]]:
    """Load a HF-format Whisper checkpoint onto `device`.

    Returns (dims, params, alignment_heads or None). alignment_heads is an
    [A, 2] int array of (decoder_layer, head) pairs from
    generation_config.json when present (used for word-timestamp DTW).

    quantization ("w8a16"/"w4a16"; "w8a8" loads the "w8a16" tree, whose A8
    half is the encoder's int8-activation dispatch) returns the tree
    quantized by ops/quant.quantize_whisper_params.
    """
    from whisperkit_tpu_torch.ops.quant import quantize_whisper_params

    if quantization == "w8a8":
        quantization = "w8a16"
    if quantization not in (None, "w8a16", "w4a16"):
        raise ValueError(f"unknown quantization scheme: {quantization!r}")
    folder = Path(folder)
    dev = resolve_device(device)
    with open(folder / "config.json") as f:
        cfg = json.load(f)
    dims = dims_from_hf_config(cfg)
    params = convert_hf_state_dict(_read_safetensors(folder), dims, dtype, dev)
    if quantization is not None:
        params = quantize_whisper_params(params, bits=4 if quantization == "w4a16" else 8)

    alignment_heads = None
    gen_cfg_path = folder / "generation_config.json"
    if gen_cfg_path.exists():
        with open(gen_cfg_path) as f:
            gen_cfg = json.load(f)
        if "alignment_heads" in gen_cfg:
            alignment_heads = np.asarray(gen_cfg["alignment_heads"], dtype=np.int32)
    logging.info(
        f"loaded whisper from {folder}: d={dims.n_audio_state} layers="
        f"{dims.n_audio_layer}/{dims.n_text_layer} vocab={dims.n_vocab}"
    )
    return dims, params, alignment_heads


def convert_hf_state_dict(
    tensors: dict[str, torch.Tensor],
    dims: WhisperDims,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = "cuda",
) -> dict:
    """Map HF `WhisperForConditionalGeneration` names → the port's tree.

    HF linear weights are [out, in] (y = x Wᵀ); ours are [in, out]. Each
    tensor moves to `device` as stored and is converted there. `proj_out`
    is tied to `embed_tokens` (the decoder's logits use `token_embed`)."""
    dev = resolve_device(device)

    def get(name: str) -> torch.Tensor:
        """The named tensor, copied to `dev` (never a view of the file)."""
        if name not in tensors:
            # some exports drop the leading "model."
            alt = name[len("model.") :] if name.startswith("model.") else "model." + name
            if alt not in tensors:
                raise ModelsUnavailable(f"missing tensor {name}")
            name = alt
        return tensors[name].to(dev, copy=True)

    def leaf(name: str) -> torch.Tensor:
        return get(name).to(dtype)

    def lin(prefix: str, bias: bool = True) -> dict:
        p = {"w": get(prefix + ".weight").T.contiguous().to(dtype)}
        if bias:
            p["b"] = leaf(prefix + ".bias")
        return p

    def ln(prefix: str) -> dict:
        return {"g": leaf(prefix + ".weight"), "b": leaf(prefix + ".bias")}

    def attn(prefix: str) -> dict:
        return {
            "q": lin(prefix + ".q_proj"),
            "k": lin(prefix + ".k_proj", bias=False),
            "v": lin(prefix + ".v_proj"),
            "out": lin(prefix + ".out_proj"),
        }

    enc_blocks = []
    for i in range(dims.n_audio_layer):
        p = f"model.encoder.layers.{i}"
        enc_blocks.append(
            {
                "attn_ln": ln(f"{p}.self_attn_layer_norm"),
                "attn": attn(f"{p}.self_attn"),
                "mlp_ln": ln(f"{p}.final_layer_norm"),
                "fc1": lin(f"{p}.fc1"),
                "fc2": lin(f"{p}.fc2"),
            }
        )
    dec_blocks = []
    for i in range(dims.n_text_layer):
        p = f"model.decoder.layers.{i}"
        dec_blocks.append(
            {
                "attn_ln": ln(f"{p}.self_attn_layer_norm"),
                "attn": attn(f"{p}.self_attn"),
                "cross_attn_ln": ln(f"{p}.encoder_attn_layer_norm"),
                "cross_attn": attn(f"{p}.encoder_attn"),
                "mlp_ln": ln(f"{p}.final_layer_norm"),
                "fc1": lin(f"{p}.fc1"),
                "fc2": lin(f"{p}.fc2"),
            }
        )

    try:
        enc_pos = leaf("model.encoder.embed_positions.weight")
    except ModelsUnavailable:
        enc_pos = torch.from_numpy(sinusoidal_positions(dims.n_audio_ctx, dims.n_audio_state)).to(dev, dtype)

    encoder = {
        "conv1": {"w": leaf("model.encoder.conv1.weight"), "b": leaf("model.encoder.conv1.bias")},
        "conv2": {"w": leaf("model.encoder.conv2.weight"), "b": leaf("model.encoder.conv2.bias")},
        "pos_embed": enc_pos,
        "blocks": enc_blocks,
        "ln_post": ln("model.encoder.layer_norm"),
    }
    decoder = {
        "token_embed": leaf("model.decoder.embed_tokens.weight"),
        "pos_embed": leaf("model.decoder.embed_positions.weight"),
        "blocks": dec_blocks,
        "ln": ln("model.decoder.layer_norm"),
    }
    return _with_logits_weight({"encoder": encoder, "decoder": decoder})
