"""Write a Whisper checkpoint folder in the HF layout from a port parameter
tree, and a byte-level BPE tokenizer for it: test and card tooling that
lets the loader, the tokenizer and the entry points run at full size with
no download.

    write_hf_checkpoint(folder, dims, params, alignment_heads=None)
        config.json, model.safetensors (the tree's own float dtype, BF16 or
        F32, written by `write_safetensors` below) and
        generation_config.json; the exact inverse of
        models/loader.convert_hf_state_dict
    write_synthetic_tokenizer(folder, n_vocab)
        vocab.json + merges.txt whose ids fill every regular id below EOT:
        the 256 byte symbols in GPT-2's order, then merges of byte pairs
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence, Union

import torch

from whisperkit_tpu_torch.models.loader import SAFETENSORS_DTYPES
from whisperkit_tpu_torch.models.whisper import WhisperDims
from whisperkit_tpu_torch.text.tokenizer import bytes_to_unicode, special_tokens_for_vocab

_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}


def write_safetensors(path: Union[str, Path], tensors: dict[str, torch.Tensor]) -> int:
    """Write `tensors` as one safetensors file (little-endian, the header
    padded with spaces to a multiple of 8 bytes, tensors in name order).
    Returns the file's size in bytes."""
    header: dict[str, dict] = {}
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in sorted(tensors):
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
    return 8 + len(raw) + offset


def hf_state_dict(params: dict, dims: WhisperDims) -> dict[str, torch.Tensor]:
    """The port's tree → HF `WhisperForConditionalGeneration` names, linear
    weights back to [out, in]. `proj_out.weight` is left out: HF ties it to
    `model.decoder.embed_tokens.weight`."""
    out: dict[str, torch.Tensor] = {}

    def lin(prefix: str, p: dict) -> None:
        if "w" not in p:
            raise ValueError(f"{prefix} is quantized: write the float tree")
        out[prefix + ".weight"] = p["w"].T
        if "b" in p:
            out[prefix + ".bias"] = p["b"]

    def ln(prefix: str, p: dict) -> None:
        out[prefix + ".weight"] = p["g"]
        out[prefix + ".bias"] = p["b"]

    def attn(prefix: str, p: dict) -> None:
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            lin(f"{prefix}.{theirs}", p[ours])

    enc, dec = params["encoder"], params["decoder"]
    for i in (1, 2):
        out[f"model.encoder.conv{i}.weight"] = enc[f"conv{i}"]["w"]
        out[f"model.encoder.conv{i}.bias"] = enc[f"conv{i}"]["b"]
    out["model.encoder.embed_positions.weight"] = enc["pos_embed"]
    for i, b in enumerate(enc["blocks"]):
        p = f"model.encoder.layers.{i}"
        ln(f"{p}.self_attn_layer_norm", b["attn_ln"])
        attn(f"{p}.self_attn", b["attn"])
        ln(f"{p}.final_layer_norm", b["mlp_ln"])
        lin(f"{p}.fc1", b["fc1"])
        lin(f"{p}.fc2", b["fc2"])
    ln("model.encoder.layer_norm", enc["ln_post"])
    out["model.decoder.embed_tokens.weight"] = dec["token_embed"]
    out["model.decoder.embed_positions.weight"] = dec["pos_embed"]
    for i, b in enumerate(dec["blocks"]):
        p = f"model.decoder.layers.{i}"
        ln(f"{p}.self_attn_layer_norm", b["attn_ln"])
        attn(f"{p}.self_attn", b["attn"])
        ln(f"{p}.encoder_attn_layer_norm", b["cross_attn_ln"])
        attn(f"{p}.encoder_attn", b["cross_attn"])
        ln(f"{p}.final_layer_norm", b["mlp_ln"])
        lin(f"{p}.fc1", b["fc1"])
        lin(f"{p}.fc2", b["fc2"])
    ln("model.decoder.layer_norm", dec["ln"])
    if len(enc["blocks"]) != dims.n_audio_layer or len(dec["blocks"]) != dims.n_text_layer:
        raise ValueError("the tree's layer counts are not the dims'")
    return out


def hf_config(dims: WhisperDims, dtype: torch.dtype) -> dict:
    """config.json of `WhisperForConditionalGeneration` for `dims`."""
    if dims.n_audio_state != dims.n_text_state:
        raise ValueError("the HF layout has one d_model for encoder and decoder")
    sp = special_tokens_for_vocab(dims.n_vocab)
    return {
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper",
        "vocab_size": dims.n_vocab,
        "num_mel_bins": dims.n_mels,
        "d_model": dims.n_audio_state,
        "encoder_layers": dims.n_audio_layer,
        "encoder_attention_heads": dims.n_audio_head,
        "decoder_layers": dims.n_text_layer,
        "decoder_attention_heads": dims.n_text_head,
        "encoder_ffn_dim": 4 * dims.n_audio_state,
        "decoder_ffn_dim": 4 * dims.n_text_state,
        "max_source_positions": dims.n_audio_ctx,
        "max_target_positions": dims.n_text_ctx,
        "pad_token_id": sp.eot,
        "bos_token_id": sp.eot,
        "eos_token_id": sp.eot,
        "decoder_start_token_id": sp.sot,
        "suppress_tokens": [],
        "begin_suppress_tokens": [],
        "scale_embedding": False,
        "tie_word_embeddings": True,
        "torch_dtype": str(dtype).removeprefix("torch."),
    }


def write_hf_checkpoint(
    folder: Union[str, Path],
    dims: WhisperDims,
    params: dict,
    alignment_heads: Optional[Sequence[Sequence[int]]] = None,
) -> int:
    """Write `params` (a float tree: `init_params`, `params_from_numpy` or
    `load_whisper` without quantization) as an HF Whisper folder: every
    tensor in the dtype it has in the tree. Returns the bytes written to
    model.safetensors."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    tensors = hf_state_dict(params, dims)
    dtype = tensors["model.decoder.embed_tokens.weight"].dtype
    with open(folder / "config.json", "w") as f:
        json.dump(hf_config(dims, dtype), f, indent=2)
    sp = special_tokens_for_vocab(dims.n_vocab)
    gen = {
        "decoder_start_token_id": sp.sot,
        "eos_token_id": sp.eot,
        "pad_token_id": sp.eot,
        "bos_token_id": sp.eot,
        "no_timestamps_token_id": sp.notimestamps,
    }
    if alignment_heads is not None:
        gen["alignment_heads"] = [[int(layer), int(head)] for layer, head in alignment_heads]
    with open(folder / "generation_config.json", "w") as f:
        json.dump(gen, f, indent=2)
    return write_safetensors(folder / "model.safetensors", tensors)


def write_synthetic_tokenizer(folder: Union[str, Path], n_vocab: int) -> None:
    """vocab.json + merges.txt for `n_vocab`: ids 0..255 are the byte
    symbols in GPT-2's order (bytes_to_unicode's), then each further
    regular id below EOT is the merge of a pair of byte symbols, pairs in
    that order. With fewer than 256 regular ids, the first EOT symbols."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    n_regular = special_tokens_for_vocab(n_vocab).eot
    symbols = list(bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols[:n_regular])}
    merges = []
    for a in symbols:
        for b in symbols:
            if len(vocab) >= n_regular:
                break
            merges.append((a, b))
            vocab[a + b] = len(vocab)
    with open(folder / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(folder / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.writelines(f"{a} {b}\n" for a, b in merges)
