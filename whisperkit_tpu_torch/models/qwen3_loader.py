"""Qwen3-TTS checkpoint loading: an HF-style safetensors folder → the port's
tree (port of whisperkit_tpu/models/qwen3_loader.py).

One folder carries the whole stack:

  * backbone (CodeDecoder) — HF Qwen3 names (`model.layers.N.self_attn.
    q_proj.weight`, …), with or without a `talker.` prefix; `codec_head`
    (or `lm_head`) is the code0 head and `codec_embedding` the CodeEmbedder
  * code predictor (MultiCodeDecoder) — HF `TalkerCodePredictor` names
    (`talker.code_predictor.model.layers.N.…`, `codec_embedding.{j}`,
    `lm_head.{j}`)
  * speech decoder — HF `Code2Wav` names (`code2wav.pre_transformer.…`,
    `code2wav.upsample.…`, `code2wav.decoder.…`), loaded in float32

The files are read by the port's own safetensors reader
(models/loader._read_safetensors_file), not the `safetensors` package.
The JAX package's rules hold: a component named in part always raises, a
component wholly absent raises unless `allow_partial=True` (then it is
random-initialised with an error-level log).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import torch

from whisperkit_tpu_torch.core.device import DeviceLike, resolve_device
from whisperkit_tpu_torch.core.errors import ModelsUnavailable
from whisperkit_tpu_torch.core.logging import logging
from whisperkit_tpu_torch.models.loader import _read_safetensors_file
from whisperkit_tpu_torch.models.qwen3_tts import (
    CODEC_VOCAB,
    Code2WavDims,
    Params,
    Qwen3TTSDims,
    init_tts_params,
    map_tree,
)


def dims_from_qwen3_config(cfg: dict) -> Qwen3TTSDims:
    """Backbone dims from a flat HF Qwen3 config, with optional nested
    `talker_config` / `code_predictor_config` / `code2wav_config` blocks
    (qwen3_omni_moe layout)."""
    talker = cfg.get("talker_config", {}).get("text_config", cfg)
    cp = cfg.get("talker_config", {}).get("code_predictor_config", {})
    c2w_cfg = cfg.get("code2wav_config", {})

    kwargs = dict(
        text_vocab=cfg.get("vocab_size", 151_936),
        d_model=talker.get("hidden_size", 1024),
        n_layer=talker.get("num_hidden_layers", 28),
        n_head=talker.get("num_attention_heads", 16),
        n_kv_head=talker.get("num_key_value_heads", 8),
        # Qwen3 configs carry an explicit head_dim (128 even at hidden 1024)
        head_dim=talker.get("head_dim", cfg.get("head_dim", 128)),
        d_ff=talker.get("intermediate_size", 3072),
        rope_theta=talker.get("rope_theta", 1_000_000.0),
        max_seq=talker.get("max_position_embeddings", 2048),
    )
    if cp:
        kwargs.update(
            cp_layer=cp.get("num_hidden_layers", 5),
            cp_head=cp.get("num_attention_heads", 16),
            cp_kv_head=cp.get("num_key_value_heads", 8),
            cp_head_dim=cp.get("head_dim", 128),
            cp_ff=cp.get("intermediate_size", 3072),
            cp_rope_theta=cp.get("rope_theta", 10_000.0),
        )
    if c2w_cfg:
        kwargs["c2w"] = Code2WavDims(
            d_model=c2w_cfg.get("hidden_size", 1024),
            n_layer=c2w_cfg.get("num_hidden_layers", 8),
            n_head=c2w_cfg.get("num_attention_heads", 16),
            n_kv_head=c2w_cfg.get("num_key_value_heads", 16),
            d_ff=c2w_cfg.get("intermediate_size", 3072),
            sliding_window=c2w_cfg.get("sliding_window", 72),
            rope_theta=c2w_cfg.get("rope_theta", 10_000.0),
            rms_eps=c2w_cfg.get("rms_norm_eps", 1e-5),
            layer_scale_init=c2w_cfg.get("layer_scale_initial_scale", 0.01),
            codebook=c2w_cfg.get("codebook_size", 2048),
            n_quantizers=c2w_cfg.get("num_quantizers", 16),
            upsampling_ratios=tuple(c2w_cfg.get("upsampling_ratios", (2, 2))),
            upsample_rates=tuple(c2w_cfg.get("upsample_rates", (8, 5, 4, 3))),
            decoder_dim=c2w_cfg.get("decoder_dim", 1536),
        )
    return Qwen3TTSDims(**kwargs)


# ---------------------------------------------------------------------------
# Component converters (HF state dict → the port's trees)
# ---------------------------------------------------------------------------


class _SD:
    """State-dict view with prefix search and a record of missing names."""

    def __init__(self, sd: dict, prefixes: tuple[str, ...] = ("",)):
        self.sd = sd
        self.prefixes = prefixes
        self.missing: list[str] = []

    def get(self, name: str) -> Optional[torch.Tensor]:
        for p in self.prefixes:
            if p + name in self.sd:
                return self.sd[p + name]
        self.missing.append(self.prefixes[0] + name)
        return None

    def lin(self, name: str) -> Optional[torch.Tensor]:
        """An HF Linear [out, in] → ours [in, out]."""
        t = self.get(name)
        return None if t is None else t.T

    def check(self, what: str) -> None:
        if self.missing:
            raise ModelsUnavailable(
                f"{what} checkpoint incomplete: missing {self.missing[:8]}"
                + (f" (+{len(self.missing) - 8} more)" if len(self.missing) > 8 else "")
            )


def _stack(rows, dtype, device) -> torch.Tensor:
    return torch.stack([r.to(device, dtype) for r in rows])


def _qwen3_blocks(v: _SD, prefix: str, n_layer: int, extra: dict) -> dict[str, list]:
    """Per-layer tensors of a Qwen3 block stack under `prefix`{i}."""
    names = {
        "ln1": ("input_layernorm.weight", False),
        "wq": ("self_attn.q_proj.weight", True),
        "wk": ("self_attn.k_proj.weight", True),
        "wv": ("self_attn.v_proj.weight", True),
        "wo": ("self_attn.o_proj.weight", True),
        **extra,
        "ln2": ("post_attention_layernorm.weight", False),
        "w_gate": ("mlp.gate_proj.weight", True),
        "w_up": ("mlp.up_proj.weight", True),
        "w_down": ("mlp.down_proj.weight", True),
    }
    return {
        key: [(v.lin if linear else v.get)(f"{prefix}{i}.{name}") for i in range(n_layer)]
        for key, (name, linear) in names.items()
    }


_QK_NORMS = {"qnorm": ("self_attn.q_norm.weight", False), "knorm": ("self_attn.k_norm.weight", False)}


def convert_code2wav_state_dict(
    sd: dict, dims: Code2WavDims, dtype: torch.dtype = torch.float32, prefix: str = "",
    device: DeviceLike = "cuda",
) -> Params:
    """HF `Qwen3OmniMoeCode2Wav` state dict → the c2w tree. Raises
    ModelsUnavailable naming the absent tensors."""
    dev = resolve_device(device)
    v = _SD(sd, (prefix,))
    blocks = _qwen3_blocks(v, "pre_transformer.layers.", dims.n_layer, {
        "attn_scale": ("self_attn_layer_scale.scale", False),
        "mlp_scale": ("mlp_layer_scale.scale", False),
    })
    upsample = []
    for i in range(len(dims.upsampling_ratios)):
        p = f"upsample.{i}."
        upsample.append({
            "tconv_w": v.get(p + "0.conv.weight"),
            "tconv_b": v.get(p + "0.conv.bias"),
            "cnx": {
                "dw_w": v.get(p + "1.dwconv.conv.weight"),
                "dw_b": v.get(p + "1.dwconv.conv.bias"),
                "ln_g": v.get(p + "1.norm.weight"),
                "ln_b": v.get(p + "1.norm.bias"),
                "pw1_w": v.lin(p + "1.pwconv1.weight"),
                "pw1_b": v.get(p + "1.pwconv1.bias"),
                "pw2_w": v.lin(p + "1.pwconv2.weight"),
                "pw2_b": v.get(p + "1.pwconv2.bias"),
                "gamma": v.get(p + "1.gamma"),
            },
        })
    dec_blocks = []
    for i in range(len(dims.upsample_rates)):
        p = f"decoder.{1 + i}.block."
        units = []
        for j in range(3):
            u = p + f"{2 + j}."
            units.append({
                "a1": v.get(u + "act1.alpha"),
                "b1": v.get(u + "act1.beta"),
                "c1_w": v.get(u + "conv1.conv.weight"),
                "c1_b": v.get(u + "conv1.conv.bias"),
                "a2": v.get(u + "act2.alpha"),
                "b2": v.get(u + "act2.beta"),
                "c2_w": v.get(u + "conv2.conv.weight"),
                "c2_b": v.get(u + "conv2.conv.bias"),
            })
        dec_blocks.append({
            "snake_a": v.get(p + "0.alpha"),
            "snake_b": v.get(p + "0.beta"),
            "tconv_w": v.get(p + "1.conv.weight"),
            "tconv_b": v.get(p + "1.conv.bias"),
            "units": units,
        })
    n_dec = 1 + len(dims.upsample_rates)
    params = {
        "code_embed": v.get("code_embedding.weight"),
        "ln_f": v.get("pre_transformer.norm.weight"),
        "upsample": upsample,
        "dec_in_w": v.get("decoder.0.conv.weight"),
        "dec_in_b": v.get("decoder.0.conv.bias"),
        "dec_blocks": dec_blocks,
        "out_snake_a": v.get(f"decoder.{n_dec}.alpha"),
        "out_snake_b": v.get(f"decoder.{n_dec}.beta"),
        "out_w": v.get(f"decoder.{n_dec + 1}.conv.weight"),
        "out_b": v.get(f"decoder.{n_dec + 1}.conv.bias"),
    }
    v.check("code2wav")
    params = map_tree(lambda _, t: t.to(dev, dtype), params)
    params["blocks"] = {k: _stack(rows, dtype, dev) for k, rows in blocks.items()}
    return params


def convert_code_predictor_state_dict(
    sd: dict, dims: Qwen3TTSDims, dtype: torch.dtype = torch.bfloat16, prefix: str = "",
    device: DeviceLike = "cuda",
) -> Params:
    """HF `TalkerCodePredictorModelForConditionalGeneration` state dict →
    the `mc` tree (15 embedding tables, the transformer, 15 heads)."""
    dev = resolve_device(device)
    v = _SD(sd, (prefix,))
    blocks = _qwen3_blocks(v, "model.layers.", dims.cp_layer, _QK_NORMS)
    embeds = [v.get(f"model.codec_embedding.{j}.weight") for j in range(15)]
    heads = [v.lin(f"lm_head.{j}.weight") for j in range(15)]
    ln_f = v.get("model.norm.weight")
    v.check("code-predictor")
    return {
        "blocks": {k: _stack(rows, dtype, dev) for k, rows in blocks.items()},
        "embeds": _stack(embeds, dtype, dev),
        "heads": _stack(heads, dtype, dev),
        "ln_f": ln_f.to(dev, dtype),
    }


def convert_backbone_state_dict(
    sd: dict, dims: Qwen3TTSDims, dtype: torch.dtype = torch.bfloat16, prefixes=("", "model."),
    device: DeviceLike = "cuda",
) -> Params:
    """HF Qwen3 decoder names → backbone blocks and final norm; `prefixes`
    are tried in order for each tensor (bare `layers.N.…`,
    `model.layers.N.…`, `talker.model.layers.N.…`)."""
    dev = resolve_device(device)
    v = _SD(sd, prefixes)
    blocks = _qwen3_blocks(v, "layers.", dims.n_layer, _QK_NORMS)
    ln_f = v.get("norm.weight")
    v.check("backbone")
    return {"blocks": {k: _stack(rows, dtype, dev) for k, rows in blocks.items()}, "ln_f": ln_f.to(dev, dtype)}


# ---------------------------------------------------------------------------
# Folder loader
# ---------------------------------------------------------------------------

BACKBONE_PREFIXES = ("", "model.", "talker.model.", "talker.")
CODE_PREDICTOR_PREFIXES = ("talker.code_predictor.", "code_predictor.")
# (key, candidate names, HF orientation is [out, in])
_TABLES = (
    ("text_embed", ("model.embed_tokens.weight", "embed_tokens.weight",
                    "talker.model.text_embedding.weight", "text_projection.weight")),
    ("code_embed", ("talker.model.codec_embedding.weight", "codec_embedding.weight",
                    "code_embedding.weight", "tts.code_embed.weight")),
    ("code0_head", ("talker.codec_head.weight", "codec_head.weight", "lm_head.weight",
                    "tts.code0_head.weight")),
)


def load_qwen3_tts(
    folder: Union[str, Path],
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    allow_partial: bool = False,
    device: DeviceLike = "cuda",
) -> tuple[Qwen3TTSDims, Params]:
    """config.json + *.safetensors of `folder` → (dims, tree on `device`):
    the backbone, the code predictor and the tables in `dtype`, Code2Wav
    in float32. A component named in part raises; one wholly absent raises
    unless `allow_partial`, which leaves it at the random init of `seed`."""
    folder = Path(folder)
    dev = resolve_device(device)
    cfg_path = folder / "config.json"
    if not cfg_path.exists():
        raise ModelsUnavailable(f"missing config.json in {folder}")
    with open(cfg_path) as f:
        dims = dims_from_qwen3_config(json.load(f))
    tensors: dict[str, torch.Tensor] = {}
    for path in sorted(folder.glob("*.safetensors")):
        tensors.update(_read_safetensors_file(path))
    if not tensors:
        raise ModelsUnavailable(f"no .safetensors in {folder}")

    params: Params = {}
    absent: list[str] = []
    if any(p + "layers.0.self_attn.q_proj.weight" in tensors for p in BACKBONE_PREFIXES):
        params.update(convert_backbone_state_dict(tensors, dims, dtype, BACKBONE_PREFIXES, dev))
    else:
        absent.append("backbone (model.layers.*)")

    want = {"text_embed": (dims.text_vocab, dims.d_model), "code_embed": (CODEC_VOCAB, dims.d_model),
            "code0_head": (dims.d_model, CODEC_VOCAB)}
    for key, names in _TABLES:
        name = next((n for n in names if n in tensors), None)
        if name is None:
            absent.append(f"{key} ({names[0]})")
            continue
        t = tensors[name]
        if tuple(t.shape) != want[key]:
            if t.ndim == 2 and tuple(t.shape[::-1]) == want[key]:
                t = t.T
            else:
                raise ModelsUnavailable(f"{name}: shape {tuple(t.shape)} does not fit {want[key]}")
        params[key] = t.to(dev, dtype)

    cp_prefix = next(
        (p for p in CODE_PREDICTOR_PREFIXES if p + "model.layers.0.self_attn.q_proj.weight" in tensors), None)
    if cp_prefix is not None:
        params["mc"] = convert_code_predictor_state_dict(tensors, dims, dtype, cp_prefix, dev)
    else:
        absent.append("code predictor (talker.code_predictor.*)")

    if "code2wav.code_embedding.weight" in tensors or \
            "code2wav.pre_transformer.layers.0.self_attn.q_proj.weight" in tensors:
        params["c2w"] = convert_code2wav_state_dict(tensors, dims.c2w, torch.float32, "code2wav.", dev)
    else:
        absent.append("speech decoder (code2wav.*)")

    if absent:
        msg = f"qwen3-tts checkpoint at {folder} is missing components: {', '.join(absent)}"
        if not allow_partial:
            raise ModelsUnavailable(msg + " — pass allow_partial=True to run with random init")
        logging.error(msg + " (allow_partial: left at RANDOM INIT)")
        random = init_tts_params(torch.Generator().manual_seed(seed), dims, dtype, dev)
        params = {k: params.get(k, random[k]) for k in random}

    logging.info(f"qwen3-tts loaded from {folder} ({len(tensors)} tensors)")
    return dims, params
