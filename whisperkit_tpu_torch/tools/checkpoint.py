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
    write_pyannote_checkpoint(folder, seed, full=True)
        segmentation-3.0.ckpt (PyanNet, a Lightning-style
        {"state_dict": {"model.…": …}} through torch.save) and
        wespeaker-resnet34.bin (a ResNet34 state dict), random weights
        under the published parameter names, for
        pipelines/diarize.DiarizePipeline.from_pretrained
    write_qwen3_tts_checkpoint(folder, dims, seed, params=None)
        a Qwen3-TTS folder for models/qwen3_loader.load_qwen3_tts and
        pipelines/tts.TTSPipeline.from_pretrained: config.json (flat keys
        and the nested talker_config / code2wav_config blocks),
        model.safetensors under the HF names the loader probes, and a small
        byte-level BPE tokenizer.json with Qwen2's pre-tokenizer and the
        chat template's added tokens
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence, Union

import torch

from whisperkit_tpu_torch.models.loader import SAFETENSORS_DTYPES
from whisperkit_tpu_torch.models.qwen3_tts import TEXT_BOS, TEXT_PAD, Qwen3TTSDims, init_tts_params
from whisperkit_tpu_torch.models.whisper import WhisperDims
from whisperkit_tpu_torch.pipelines.tts import QWEN2_SPLIT_PATTERN
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


# the published speaker models' shapes (pyannote/segmentation-3.0 PyanNet,
# wespeaker-voxceleb-resnet34-LM) and the small ones of the tests
PYANNET_FULL = {"sinc_filters": 80, "conv_channels": 60, "n_lstm": 4, "hidden": 128, "linear": 128, "classes": 7}
PYANNET_SMALL = {"sinc_filters": 80, "conv_channels": 60, "n_lstm": 2, "hidden": 32, "linear": 32, "classes": 7}
RESNET_FULL = {"m_channels": 32, "blocks": (3, 4, 6, 3), "n_mels": 80, "embedding": 256}
RESNET_SMALL = {"m_channels": 8, "blocks": (2, 2, 2, 2), "n_mels": 80, "embedding": 64}


def _uniform(g: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """torch's default init for a layer of `fan_in` inputs."""
    bound = fan_in**-0.5
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def pyannet_state_dict(g: torch.Generator, dims: dict = PYANNET_FULL) -> dict[str, torch.Tensor]:
    """A random pyannote/segmentation-3.0 PyanNet state dict (the names
    models/pyannet.convert_pyannote_segmentation reads). The LSTM, linear
    and classifier biases are zero: random biases of torch's default
    scale outweigh the features and give every frame of any audio the
    same class, while without them the classes follow the audio."""
    f, c, h, lin = dims["sinc_filters"], dims["conv_channels"], dims["hidden"], dims["linear"]
    sd = {
        "sincnet.wav_norm1d.weight": 1.0 + 0.1 * torch.randn(1, generator=g),
        "sincnet.wav_norm1d.bias": 0.1 * torch.randn(1, generator=g),
        "sincnet.conv1d.0.filterbank.low_hz_": torch.rand((f, 1), generator=g) * 3000 + 30,
        "sincnet.conv1d.0.filterbank.band_hz_": torch.rand((f, 1), generator=g) * 400 + 30,
    }
    for i, (c_in, k) in enumerate(((f, 5), (c, 5)), start=1):
        sd[f"sincnet.conv1d.{i}.weight"] = _uniform(g, (c, c_in, k), c_in * k)
        sd[f"sincnet.conv1d.{i}.bias"] = _uniform(g, (c,), c_in * k)
    for i, n in enumerate((f, c, c)):
        sd[f"sincnet.norm1d.{i}.weight"] = 1.0 + 0.1 * torch.randn(n, generator=g)
        sd[f"sincnet.norm1d.{i}.bias"] = 0.1 * torch.randn(n, generator=g)
    for layer in range(dims["n_lstm"]):
        d_in = c if layer == 0 else 2 * h
        for sfx in ("", "_reverse"):
            sd[f"lstm.weight_ih_l{layer}{sfx}"] = _uniform(g, (4 * h, d_in), h)
            sd[f"lstm.weight_hh_l{layer}{sfx}"] = _uniform(g, (4 * h, h), h)
            sd[f"lstm.bias_ih_l{layer}{sfx}"] = torch.zeros(4 * h)
            sd[f"lstm.bias_hh_l{layer}{sfx}"] = torch.zeros(4 * h)
    for i, d_in in enumerate((2 * h, lin)):
        sd[f"linear.{i}.weight"] = _uniform(g, (lin, d_in), d_in)
        sd[f"linear.{i}.bias"] = torch.zeros(lin)
    sd["classifier.weight"] = _uniform(g, (dims["classes"], lin), lin)
    sd["classifier.bias"] = torch.zeros(dims["classes"])
    return sd


def _batch_norm(g: torch.Generator, prefix: str, n: int) -> dict[str, torch.Tensor]:
    """A BatchNorm2d's state with random statistics and affine, so that
    folding it into its conv is exercised (not an identity)."""
    return {
        f"{prefix}.weight": torch.randn(n, generator=g),
        f"{prefix}.bias": torch.randn(n, generator=g),
        f"{prefix}.running_mean": torch.randn(n, generator=g),
        f"{prefix}.running_var": torch.rand(n, generator=g) * 2 + 0.5,
        f"{prefix}.num_batches_tracked": torch.tensor(0),
    }


def wespeaker_state_dict(g: torch.Generator, dims: dict = RESNET_FULL) -> dict[str, torch.Tensor]:
    """A random WeSpeaker ResNet34 state dict (wespeaker resnet.py names,
    the ones models/pyannet.convert_wespeaker_resnet34 reads): conv1/bn1,
    layer{1..4}.{i}.{conv1,bn1,conv2,bn2,downsample.{0,1}}, seg_1."""
    m = dims["m_channels"]
    sd = {"conv1.weight": _uniform(g, (m, 1, 3, 3), 9), **_batch_norm(g, "bn1", m)}
    in_c = m
    for li, n_blocks in enumerate(dims["blocks"]):
        c = m * 2**li
        for i in range(n_blocks):
            base = f"layer{li + 1}.{i}"
            c_in = in_c if i == 0 else c
            sd[f"{base}.conv1.weight"] = _uniform(g, (c, c_in, 3, 3), c_in * 9)
            sd.update(_batch_norm(g, f"{base}.bn1", c))
            sd[f"{base}.conv2.weight"] = _uniform(g, (c, c, 3, 3), c * 9)
            sd.update(_batch_norm(g, f"{base}.bn2", c))
            if i == 0 and (li > 0 or in_c != c):
                sd[f"{base}.downsample.0.weight"] = _uniform(g, (c, c_in, 1, 1), c_in)
                sd.update(_batch_norm(g, f"{base}.downsample.1", c))
        in_c = c
    d_stats = 2 * in_c * (dims["n_mels"] // 8)
    sd["seg_1.weight"] = _uniform(g, (dims["embedding"], d_stats), d_stats)
    sd["seg_1.bias"] = _uniform(g, (dims["embedding"],), d_stats)
    return sd


def write_pyannote_checkpoint(folder: Union[str, Path], seed: int, *, full: bool = True) -> tuple[Path, Path]:
    """Write random speaker models under the published parameter names:
    `segmentation-3.0.ckpt` (PyanNet as a Lightning checkpoint,
    {"state_dict": {"model.<name>": tensor}}) and `wespeaker-resnet34.bin`
    (the ResNet34 state dict), both through `torch.save`. `full` gives
    the published shapes (SincNet 80 × 251 at stride 10, 2 × Conv1d(60,
    k=5), a 4-layer BiLSTM(128), 2 × Linear(128), 7 classes; ResNet34
    with 32 base channels, blocks (3, 4, 6, 3), 80 mels, 256-d
    embedding); otherwise the small ones (PYANNET_SMALL, RESNET_SMALL).
    Returns the two paths."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    seg = pyannet_state_dict(g, PYANNET_FULL if full else PYANNET_SMALL)
    emb = wespeaker_state_dict(g, RESNET_FULL if full else RESNET_SMALL)
    seg_path, emb_path = folder / "segmentation-3.0.ckpt", folder / "wespeaker-resnet34.bin"
    torch.save({"state_dict": {f"model.{k}": v for k, v in seg.items()}}, seg_path)
    torch.save(emb, emb_path)
    return seg_path, emb_path


# --- Qwen3-TTS -----------------------------------------------------------------


def _qwen3_block_state(out: dict, prefix: str, blocks: dict, n_layer: int) -> None:
    """A stacked Qwen3 block tree → HF per-layer names, linears [out, in]."""
    names = {
        "ln1": "input_layernorm.weight", "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
        "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight", "qnorm": "self_attn.q_norm.weight",
        "knorm": "self_attn.k_norm.weight", "ln2": "post_attention_layernorm.weight",
        "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight", "w_down": "mlp.down_proj.weight",
        "attn_scale": "self_attn_layer_scale.scale", "mlp_scale": "mlp_layer_scale.scale",
    }
    for key, stack in blocks.items():
        if not isinstance(stack, torch.Tensor):
            raise ValueError(f"{prefix} {key} is quantized: write the float tree")
        if stack.shape[0] != n_layer:
            raise ValueError(f"{prefix} {key}: {stack.shape[0]} layers, not the dims' {n_layer}")
        for i in range(n_layer):
            out[f"{prefix}{i}.{names[key]}"] = stack[i].T if key.startswith("w") else stack[i]


def qwen3_tts_state_dict(params: dict, dims: Qwen3TTSDims) -> dict[str, torch.Tensor]:
    """The port's TTS tree → the HF names models/qwen3_loader.py reads:
    the inverse of its converters."""
    out: dict[str, torch.Tensor] = {}
    _qwen3_block_state(out, "talker.model.layers.", params["blocks"], dims.n_layer)
    out["talker.model.norm.weight"] = params["ln_f"]
    out["talker.model.text_embedding.weight"] = params["text_embed"]
    out["talker.model.codec_embedding.weight"] = params["code_embed"]
    out["talker.codec_head.weight"] = params["code0_head"].T
    mc = params["mc"]
    _qwen3_block_state(out, "talker.code_predictor.model.layers.", mc["blocks"], dims.cp_layer)
    out["talker.code_predictor.model.norm.weight"] = mc["ln_f"]
    for j in range(15):
        out[f"talker.code_predictor.model.codec_embedding.{j}.weight"] = mc["embeds"][j]
        out[f"talker.code_predictor.lm_head.{j}.weight"] = mc["heads"][j].T
    c2w, cd = params["c2w"], dims.c2w
    p = "code2wav."
    _qwen3_block_state(out, p + "pre_transformer.layers.", c2w["blocks"], cd.n_layer)
    out[p + "pre_transformer.norm.weight"] = c2w["ln_f"]
    out[p + "code_embedding.weight"] = c2w["code_embed"]
    for i, st in enumerate(c2w["upsample"]):
        u, cnx = f"{p}upsample.{i}.", st["cnx"]
        out[u + "0.conv.weight"], out[u + "0.conv.bias"] = st["tconv_w"], st["tconv_b"]
        out[u + "1.dwconv.conv.weight"], out[u + "1.dwconv.conv.bias"] = cnx["dw_w"], cnx["dw_b"]
        out[u + "1.norm.weight"], out[u + "1.norm.bias"] = cnx["ln_g"], cnx["ln_b"]
        out[u + "1.pwconv1.weight"], out[u + "1.pwconv1.bias"] = cnx["pw1_w"].T, cnx["pw1_b"]
        out[u + "1.pwconv2.weight"], out[u + "1.pwconv2.bias"] = cnx["pw2_w"].T, cnx["pw2_b"]
        out[u + "1.gamma"] = cnx["gamma"]
    out[p + "decoder.0.conv.weight"], out[p + "decoder.0.conv.bias"] = c2w["dec_in_w"], c2w["dec_in_b"]
    for i, blk in enumerate(c2w["dec_blocks"]):
        d = f"{p}decoder.{1 + i}.block."
        out[d + "0.alpha"], out[d + "0.beta"] = blk["snake_a"], blk["snake_b"]
        out[d + "1.conv.weight"], out[d + "1.conv.bias"] = blk["tconv_w"], blk["tconv_b"]
        for j, unit in enumerate(blk["units"]):
            r = f"{d}{2 + j}."
            out[r + "act1.alpha"], out[r + "act1.beta"] = unit["a1"], unit["b1"]
            out[r + "conv1.conv.weight"], out[r + "conv1.conv.bias"] = unit["c1_w"], unit["c1_b"]
            out[r + "act2.alpha"], out[r + "act2.beta"] = unit["a2"], unit["b2"]
            out[r + "conv2.conv.weight"], out[r + "conv2.conv.bias"] = unit["c2_w"], unit["c2_b"]
    n_dec = 1 + len(cd.upsample_rates)
    out[f"{p}decoder.{n_dec}.alpha"], out[f"{p}decoder.{n_dec}.beta"] = c2w["out_snake_a"], c2w["out_snake_b"]
    out[f"{p}decoder.{n_dec + 1}.conv.weight"] = c2w["out_w"]
    out[f"{p}decoder.{n_dec + 1}.conv.bias"] = c2w["out_b"]
    return out


def qwen3_tts_config(dims: Qwen3TTSDims, dtype: torch.dtype) -> dict:
    """config.json for `dims`: the backbone's keys flat and under
    talker_config.text_config, the code predictor's under
    talker_config.code_predictor_config, Code2Wav's under code2wav_config."""
    backbone = {
        "hidden_size": dims.d_model, "num_hidden_layers": dims.n_layer,
        "num_attention_heads": dims.n_head, "num_key_value_heads": dims.n_kv_head,
        "head_dim": dims.head_dim, "intermediate_size": dims.d_ff, "rope_theta": dims.rope_theta,
        "max_position_embeddings": dims.max_seq,
    }
    cd = dims.c2w
    return {
        "architectures": ["Qwen3TTSForConditionalGeneration"],
        "model_type": "qwen3_tts",
        "vocab_size": dims.text_vocab,
        **backbone,
        "talker_config": {
            "text_config": {"vocab_size": dims.text_vocab, **backbone},
            "code_predictor_config": {
                "num_hidden_layers": dims.cp_layer, "num_attention_heads": dims.cp_head,
                "num_key_value_heads": dims.cp_kv_head, "head_dim": dims.cp_head_dim,
                "intermediate_size": dims.cp_ff, "rope_theta": dims.cp_rope_theta,
            },
        },
        "code2wav_config": {
            "hidden_size": cd.d_model, "num_hidden_layers": cd.n_layer, "num_attention_heads": cd.n_head,
            "num_key_value_heads": cd.n_kv_head, "intermediate_size": cd.d_ff,
            "sliding_window": cd.sliding_window, "rope_theta": cd.rope_theta, "rms_norm_eps": cd.rms_eps,
            "layer_scale_initial_scale": cd.layer_scale_init, "codebook_size": cd.codebook,
            "num_quantizers": cd.n_quantizers, "upsampling_ratios": list(cd.upsampling_ratios),
            "upsample_rates": list(cd.upsample_rates), "decoder_dim": cd.decoder_dim,
        },
        "torch_dtype": str(dtype).removeprefix("torch."),
    }


# the chat template's added tokens, numbered after the BPE vocabulary as
# in Qwen's file (the `tokenizers` library numbers them so)
QWEN_ADDED_TOKENS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
# words whose merges the small vocabulary holds ("Ġ" is GPT-2's mapped space)
_TTS_TOKENIZER_WORDS = ("Ġthe", "Ġand", "Ġof", "Ġto", "Ġa", "Ġis", "ing", "er", "th", "he", "in", "an",
                        "re", "on", "assistant", "user", "Ċ")


def write_qwen3_tts_tokenizer(folder: Union[str, Path]) -> Path:
    """tokenizer.json of a small byte-level BPE in the layout of Qwen's (the
    `tokenizers` library reads it): the 256 byte symbols in GPT-2's order
    as ids 0-255, merges that build _TTS_TOKENIZER_WORDS, NFC, Qwen2's
    split, and QWEN_ADDED_TOKENS."""
    symbols = list(bytes_to_unicode().values())
    vocab = {sym: i for i, sym in enumerate(symbols)}
    merges = []
    for word in _TTS_TOKENIZER_WORDS:
        for k in range(2, len(word) + 1):
            if word[:k] not in vocab:
                merges.append([word[:k - 1], word[k - 1]])
                vocab[word[:k]] = len(vocab)
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": False}
    data = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [
            {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True}
            for i, t in enumerate(QWEN_ADDED_TOKENS, start=len(vocab))
        ],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_SPLIT_PATTERN}, "behavior": "Isolated", "invert": False},
            byte_level,
        ]},
        "post_processor": byte_level,
        "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    path = Path(folder) / "tokenizer.json"
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False)
    return path


def write_qwen3_tts_checkpoint(
    folder: Union[str, Path], dims: Qwen3TTSDims, seed: int = 0, params: Optional[dict] = None,
) -> dict:
    """Write a Qwen3-TTS folder: config.json, model.safetensors (each tensor
    in its dtype in the tree) and tokenizer.json. The tree is `params` (a
    float tree) or, without it, random bf16 weights drawn on the CPU from
    `seed`. Returns the tree written.

    The config format has no key that the loaders read for the text-track
    pad and BOS ids (they take TEXT_PAD and TEXT_BOS), so `dims` must use
    those and hold them in its text vocabulary."""
    if (dims.text_pad, dims.text_bos) != (TEXT_PAD, TEXT_BOS) or dims.text_vocab <= TEXT_BOS:
        raise ValueError("a Qwen3-TTS folder needs text_pad TEXT_PAD and text_bos TEXT_BOS inside text_vocab")
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    if params is None:
        params = init_tts_params(torch.Generator().manual_seed(seed), dims, torch.bfloat16, "cpu")
    tensors = qwen3_tts_state_dict(params, dims)
    with open(folder / "config.json", "w") as f:
        json.dump(qwen3_tts_config(dims, params["text_embed"].dtype), f, indent=2)
    write_safetensors(folder / "model.safetensors", tensors)
    write_qwen3_tts_tokenizer(folder)
    return params
