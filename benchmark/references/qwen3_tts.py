"""The plain float32 reference of a Qwen3-TTS configuration, and the weights
that the benchmark hands to both sides.

It follows the published talker and code predictor (Qwen3-TTS-12Hz, the
Hugging Face `config.json`; TTSKit's `Sources/TTSKit/Qwen3TTS/` runs it)
and, as the vocoder, Qwen3-Omni's Code2Wav at transformers'
`Qwen3OmniMoeCode2WavConfig` defaults: three transformer stacks a frame of
80 ms.

  talker          a Qwen3 decoder over a dual-track input: each position is
                  a text-track embedding plus a codec-track embedding;
                  RMSNorm, grouped-query attention with a per-head RMSNorm
                  on q and k and rotary positions, SwiGLU; the code0 head
                  over the 3072 codec ids
  code predictor  a 5-layer Qwen3 stack run anew every frame over the
                  frame's hidden state, the code0 embedding and the
                  embeddings of codes 1-14; its 15 heads give codes 1-15
  Code2Wav        the mean of the 16 codebooks' embeddings, an 8-layer
                  sliding-window transformer with LayerScale, two
                  transposed-conv + ConvNeXt upsamplings (x2 x2), a conv in,
                  four SnakeBeta blocks (transposed conv x8 x5 x4 x3, three
                  dilated residual units each), SnakeBeta and a conv out,
                  clamped to [-1, 1]: 1920 samples at 24 kHz a frame

Every product runs in float32 with TF32 off (`float32_mode`), over the whole
sequence at once (no cache, no batching of rows of different lengths).

The vocoder departs from the published model: Qwen3-TTS-12Hz's own decoder
(`speech_tokenizer/config.json`) is a split-RVQ decoder with projections of
its own, whose widths may differ; this module and the program both run
Qwen3-Omni's Code2Wav in its place.

Where else it departs from the published model, it computes the same thing:

  text track      one table of projected text embeddings [vocab, d]: the
                  published embedding followed by its projection MLP is a
                  function of the token id alone, so a table of its outputs
                  is the same map (the port's layout)
  rotary          1-D positions: the published multimodal rotary gives text
                  and codec positions three equal sections, which is the
                  1-D rotary
  placement       the vocoder's transposed convs trim `delay` samples; the
                  waveform is placed after `delay` samples of silence, so
                  that frame i owns samples [1920 i, 1920 (i + 1)), as
                  TTSKit's speech decoder delivers them

The serving configuration's stated format is worked out again here from the
bf16 weights that both sides get, never taken from the program:

  w8a16      every block linear of the talker and the code predictor, the
             code0 head and the 15 heads as int8 codes with one scale per
             output column: scale = max|w| / 127 over the input rows (floor
             1e-8), codes = round-half-even(w / scale) clipped to +-127, the
             scale then stored as bf16; the weight is codes x scale.

The weights are random, drawn on the device from `--seed` in a few large
calls, in the tree of the port's `init_tts_params` and its scales: linears
[in, out] ~ N(0, 1/in), embedding tables [rows, d] ~ N(0, 1/rows), conv
kernels [out, in, k] ~ N(0, 1/(in k)) (transposed [in, out, k] alike), norms
1, biases 0, SnakeBeta's log-scale alpha and beta 0, LayerScale 0.01,
ConvNeXt's gamma 1e-6. The vocoder's conv kernels are then scaled by
CONV_SCALE: at the init's own scale its cascade saturates the final clamp
on most samples, which would hide any error there. The talker and the code
predictor are bf16, the vocoder float32.

The prompt is TTSKit's (Qwen3GenerateTask.swift `buildCombinedEmbeddings`),
tokenized by the byte-fallback rule (each UTF-8 byte b is id 64 + b): the
role "<|im_start|>assistant\\n" on the text track alone; five text pads over
the codec's think, think-bos, language, think-eos and speaker ids; text-bos
over codec pad; the first text token over codec bos. Each frame's input is
the sum of its 16 code embeddings and the next text token's embedding
(text pad once the text is used up).

This module imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 24_000
CHUNK = 1 << 26  # elements per random draw: a few large calls, not one per leaf
CONV_SCALE = 0.85  # the vocoder's conv kernels (see the module's docstring)

# codec ids (TTSKit Qwen3Models.swift)
CODEC_PAD, CODEC_BOS, CODEC_EOS = 2148, 2149, 2150
CODEC_THINK, CODEC_THINK_BOS, CODEC_THINK_EOS = 2154, 2156, 2157
SUPPRESS = (2048, 3072)  # code0 ids never sampled, EOS excepted
SPEAKERS = {"ryan": 3061, "aiden": 2861, "serena": 3066, "vivian": 3065}
LANGUAGES = {"english": 2050, "chinese": 2055, "german": 2053, "spanish": 2054, "french": 2061}
ROLE = "<|im_start|>assistant\n"
BYTE_OFFSET = 64  # the byte-fallback tokenizer's reserved rows


@dataclasses.dataclass(frozen=True)
class Stack:
    """One Qwen3-family transformer stack."""

    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    rope_theta: float
    eps: float


@dataclasses.dataclass(frozen=True)
class Dims:
    d_model: int  # the talker's and the code predictor's
    vocoder_dim: int  # the vocoder transformer's hidden size
    text_vocab: int
    codec_vocab: int
    codebook: int  # the code predictor's and the vocoder's codebook size
    groups: int  # codes a frame: code0 and the code predictor's heads
    text_pad: int
    text_bos: int
    talker: Stack
    predictor: Stack
    vocoder: Stack
    window: int  # the vocoder transformer's sliding window
    layer_scale: float
    upsampling: tuple
    rates: tuple
    decoder_dim: int

    @classmethod
    def of(cls, model: dict) -> "Dims":
        """From a configuration's `model` block (the published configs' keys)."""
        t, c, v = model["talker"], model["code_predictor"], model["speech_decoder"]

        def stack(m, eps):
            heads = m["num_attention_heads"]
            return Stack(m["num_hidden_layers"], heads, m["num_key_value_heads"],
                         m.get("head_dim", m["hidden_size"] // heads), m["intermediate_size"],
                         float(m["rope_theta"]), eps)

        if t["hidden_size"] != c["hidden_size"]:
            raise ValueError("the code predictor takes the talker's hidden states: one hidden size")
        if c["vocab_size"] != v["codebook_size"] or c["num_code_groups"] != v["num_quantizers"]:
            raise ValueError("the code predictor's codebooks are the vocoder's")
        return cls(t["hidden_size"], v["hidden_size"], t["text_vocab_size"], t["vocab_size"], c["vocab_size"],
                   c["num_code_groups"], t["tts_pad_token_id"], t["tts_bos_token_id"], stack(t, t["rms_norm_eps"]),
                   stack(c, c["rms_norm_eps"]), stack(v, v["rms_norm_eps"]), v["sliding_window"],
                   v["layer_scale_initial_scale"], tuple(v["upsampling_ratios"]), tuple(v["upsample_rates"]),
                   v["decoder_dim"])

    @property
    def samples_per_frame(self) -> int:
        return math.prod(self.upsampling) * math.prod(self.rates)


@contextlib.contextmanager
def float32_mode():
    """True float32 products: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


# --- weights -----------------------------------------------------------------


class _Draws:
    """Normal draws cut from flat tensors filled in chunks of CHUNK draws
    (float32, scaled, then cast), one fill per scale."""

    def __init__(self, g: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = g, device, dtype

    def __call__(self, shapes: Sequence[tuple], scale: float) -> list[torch.Tensor]:
        total = sum(math.prod(s) for s in shapes)
        flat = torch.empty(total, dtype=self.dtype, device=self.device)
        for start in range(0, total, CHUNK):
            n = min(CHUNK, total - start)
            flat[start:start + n] = torch.randn(n, generator=self.g, device=self.device).mul_(scale)
        out, at = [], 0
        for s in shapes:
            n = math.prod(s)
            out.append(flat[at:at + n].view(s))
            at += n
        return out

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)


def _blocks(draw: _Draws, d: int, s: Stack, qk_norm: bool, layer_scale: float | None) -> dict:
    """A stack's block weights, each leaf stacked [layers, ...] (the port's layout)."""
    n, h, kv = s.layers, s.heads * s.head_dim, s.kv_heads * s.head_dim
    wq, wk, wv, gate, up = draw([(n, d, h), (n, d, kv), (n, d, kv), (n, d, s.ffn), (n, d, s.ffn)], d ** -0.5)
    (wo,) = draw([(n, h, d)], h ** -0.5)
    (down,) = draw([(n, s.ffn, d)], s.ffn ** -0.5)
    out = {"ln1": draw.full((n, d), 1.0), "wq": wq, "wk": wk, "wv": wv, "wo": wo, "ln2": draw.full((n, d), 1.0),
           "w_gate": gate, "w_up": up, "w_down": down}
    if qk_norm:
        out["qnorm"] = draw.full((n, s.head_dim), 1.0)
        out["knorm"] = draw.full((n, s.head_dim), 1.0)
    if layer_scale is not None:
        out["attn_scale"] = draw.full((n, d), layer_scale)
        out["mlp_scale"] = draw.full((n, d), layer_scale)
    return out


def _vocoder_weights(draw: _Draws, dims: Dims) -> dict:
    d, c0 = dims.vocoder_dim, dims.decoder_dim

    def conv(o, i, k):
        return draw([(o, i, k)], (i * k) ** -0.5)[0] * CONV_SCALE

    def tconv(i, o, k):
        return draw([(i, o, k)], (i * k) ** -0.5)[0] * CONV_SCALE

    def zeros(n):
        return draw.full((n,), 0.0)

    def convnext():
        pw1, = draw([(d, 4 * d)], d ** -0.5)
        pw2, = draw([(4 * d, d)], (4 * d) ** -0.5)
        return {"dw_w": conv(d, 1, 7), "dw_b": zeros(d), "ln_g": draw.full((d,), 1.0), "ln_b": zeros(d),
                "pw1_w": pw1, "pw1_b": zeros(4 * d), "pw2_w": pw2, "pw2_b": zeros(d), "gamma": draw.full((d,), 1e-6)}

    def unit(c):
        return {"a1": zeros(c), "b1": zeros(c), "c1_w": conv(c, c, 7), "c1_b": zeros(c),
                "a2": zeros(c), "b2": zeros(c), "c2_w": conv(c, c, 1), "c2_b": zeros(c)}

    (embed,) = draw([(dims.codebook * dims.groups, d)], (dims.codebook * dims.groups) ** -0.5)
    blocks = _blocks(draw, d, dims.vocoder, qk_norm=False, layer_scale=dims.layer_scale)
    upsample = [{"tconv_w": tconv(d, d, f), "tconv_b": zeros(d), "cnx": convnext()} for f in dims.upsampling]
    dec_in = conv(c0, d, 7)
    dec_blocks = []
    for i, rate in enumerate(dims.rates):
        ci, co = c0 // 2 ** i, c0 // 2 ** (i + 1)
        dec_blocks.append({"snake_a": zeros(ci), "snake_b": zeros(ci), "tconv_w": tconv(ci, co, 2 * rate),
                           "tconv_b": zeros(co), "units": [unit(co) for _ in range(3)]})
    c_out = c0 // 2 ** len(dims.rates)
    return {"code_embed": embed, "blocks": blocks, "ln_f": draw.full((d,), 1.0), "upsample": upsample,
            "dec_in_w": dec_in, "dec_in_b": zeros(c0), "dec_blocks": dec_blocks, "out_snake_a": zeros(c_out),
            "out_snake_b": zeros(c_out), "out_w": conv(1, c_out, 7), "out_b": zeros(1)}


def init_weights(dims: Dims, seed: int, device, dtype=torch.bfloat16, vocoder_dtype=torch.float32) -> dict:
    """The random weight tree of `seed` (see the module's docstring)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    draw = _Draws(g, device, dtype)
    d = dims.d_model
    (text,) = draw([(dims.text_vocab, d)], dims.text_vocab ** -0.5)
    (codec,) = draw([(dims.codec_vocab, d)], dims.codec_vocab ** -0.5)
    blocks = _blocks(draw, d, dims.talker, qk_norm=True, layer_scale=None)
    (head0,) = draw([(d, dims.codec_vocab)], d ** -0.5)
    (embeds,) = draw([(dims.groups - 1, dims.codebook, d)], dims.codebook ** -0.5)
    mc_blocks = _blocks(draw, d, dims.predictor, qk_norm=True, layer_scale=None)
    (heads,) = draw([(dims.groups - 1, d, dims.codebook)], d ** -0.5)
    vocoder = _vocoder_weights(_Draws(g, device, vocoder_dtype), dims)
    return {"text_embed": text, "code_embed": codec, "blocks": blocks, "ln_f": draw.full((d,), 1.0),
            "code0_head": head0,
            "mc": {"embeds": embeds, "blocks": mc_blocks, "ln_f": draw.full((d,), 1.0), "heads": heads},
            "c2w": vocoder}


def w8a16(w: torch.Tensor) -> torch.Tensor:
    """A [..., in, out] weight as the W8A16 format holds it, in float32."""
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=-2, keepdim=True) / 127.0, 1e-8)
    codes = torch.clamp(torch.round(w / scale), -127, 127)
    return codes * scale.to(torch.bfloat16).float()


LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def float32_tree(tree: dict, weights: str) -> dict:
    """The reference's float32 weights: the tree cast, with the talker's and
    the code predictor's block linears, the code0 head and the 15 heads in
    the stated weight format (`weights`: "bfloat16" or "w8a16")."""
    if weights not in ("bfloat16", "w8a16"):
        raise ValueError(f"the reference has no weight format {weights!r}")
    fmt = w8a16 if weights == "w8a16" else (lambda w: w.float())

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        return node.float()

    out = cast(tree)
    for blocks in (out["blocks"], out["mc"]["blocks"]):
        for key in LINEAR_KEYS:
            blocks[key] = fmt(blocks[key])
    out["code0_head"] = fmt(tree["code0_head"])
    out["mc"]["heads"] = fmt(tree["mc"]["heads"])
    return out


# --- the prompt -------------------------------------------------------------------


def text_ids(text: str, vocab: int) -> list[int]:
    """The byte-fallback tokenizer: id 64 + b for each UTF-8 byte b."""
    return [BYTE_OFFSET + b for b in text.encode("utf-8") if BYTE_OFFSET + b < vocab]


def tracks(text: str, voice: str, language: str, dims: Dims) -> tuple[list[int], list[int], list[int]]:
    """A chunk's prompt as (text track, codec track with -1 where the
    position has no codec embedding, the text ids fed one a frame after)."""
    ids = text_ids(text, dims.text_vocab) or [dims.text_pad]
    role = text_ids(ROLE, dims.text_vocab)
    codec = [CODEC_THINK, CODEC_THINK_BOS, LANGUAGES[language], CODEC_THINK_EOS, SPEAKERS[voice], CODEC_PAD,
             CODEC_BOS]
    text_track = role + [dims.text_pad] * 5 + [dims.text_bos, ids[0]]
    return text_track, [-1] * len(role) + codec, ids[1:]


# --- the model ----------------------------------------------------------------------


def _rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def _rotary(x, positions, theta):
    """x [B, T, H, Dh] rotated by `positions` [T] in half-split pairs."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    angles = (positions.double()[:, None] * freqs[None, :]).float()[:, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def stack_forward(w: dict, x: torch.Tensor, s: Stack, mask: torch.Tensor, qk_norm: bool,
                  layer_scale: bool) -> torch.Tensor:
    """x [B, T, D] through a stack's layers with the additive mask [T, T]."""
    b, t, _ = x.shape
    pos = torch.arange(t, device=x.device)
    rep = s.heads // s.kv_heads
    for li in range(s.layers):
        h = _rms(x, w["ln1"][li], s.eps)
        q = (h @ w["wq"][li]).view(b, t, s.heads, s.head_dim)
        k = (h @ w["wk"][li]).view(b, t, s.kv_heads, s.head_dim)
        v = (h @ w["wv"][li]).view(b, t, s.kv_heads, s.head_dim)
        if qk_norm:
            q, k = _rms(q, w["qnorm"][li], s.eps), _rms(k, w["knorm"][li], s.eps)
        q = _rotary(q, pos, s.rope_theta).transpose(1, 2)
        k = _rotary(k, pos, s.rope_theta).transpose(1, 2).repeat_interleave(rep, dim=1)
        v = v.transpose(1, 2).repeat_interleave(rep, dim=1)
        scores = q @ k.transpose(-1, -2) / math.sqrt(s.head_dim) + mask
        att = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, t, s.heads * s.head_dim)
        att = att @ w["wo"][li]
        x = x + (att * w["attn_scale"][li] if layer_scale else att)
        h = _rms(x, w["ln2"][li], s.eps)
        mlp = (F.silu(h @ w["w_gate"][li]) * (h @ w["w_up"][li])) @ w["w_down"][li]
        x = x + (mlp * w["mlp_scale"][li] if layer_scale else mlp)
    return x


def causal(t: int, device, window: int | None = None) -> torch.Tensor:
    q = torch.arange(t, device=device)[:, None]
    k = torch.arange(t, device=device)[None, :]
    ok = k <= q if window is None else (k <= q) & (k > q - window)
    return torch.where(ok, 0.0, float("-inf"))


def _snake(x, a, b):
    return x + 1.0 / (torch.exp(b)[None, :, None] + 1e-9) * torch.sin(x * torch.exp(a)[None, :, None]) ** 2


def _conv(x, w, b, dilation=1, groups=1):
    return F.conv1d(F.pad(x, ((w.shape[-1] - 1) * dilation, 0)), w, b, dilation=dilation, groups=groups)


def _tconv(x, w, b, stride):
    """A transposed conv trimmed by k - stride on each side."""
    y = F.conv_transpose1d(x, w, b, stride=stride)
    trim = w.shape[-1] - stride
    return y[..., trim:y.shape[-1] - trim]


def _convnext(x, p):
    h = _conv(x, p["dw_w"], p["dw_b"], groups=x.shape[1]).transpose(1, 2)
    h = F.layer_norm(h, (h.shape[-1],), p["ln_g"], p["ln_b"], 1e-6)
    h = F.gelu(h @ p["pw1_w"] + p["pw1_b"]) @ p["pw2_w"] + p["pw2_b"]
    return x + (h * p["gamma"]).transpose(1, 2)


class Reference:
    """The configuration's forward passes in float32 over a weight tree."""

    def __init__(self, tree: dict, dims: Dims, serving: dict):
        self.dims = dims
        self.w = float32_tree(tree, serving["weights"])

    @property
    def device(self):
        return self.w["ln_f"].device

    def prompt(self, text: str, voice: str, language: str) -> tuple[torch.Tensor, list[int]]:
        """A chunk's prompt embeddings [P, D] and its trailing text ids."""
        tt, ct, rest = tracks(text, voice, language, self.dims)
        dev = self.device
        emb = self.w["text_embed"][torch.tensor(tt, device=dev)]
        ct = torch.tensor(ct, device=dev)
        codec = torch.where((ct >= 0)[:, None], self.w["code_embed"][ct.clamp_min(0)], 0.0)
        return emb + codec, rest

    def code_embeddings(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [N, 16] → [N, 16, D]: code0 by the talker's codec table,
        code i by the code predictor's table i - 1."""
        first = self.w["code_embed"][codes[:, 0]][:, None]
        rest = torch.stack([self.w["mc"]["embeds"][i][codes[:, i + 1]] for i in range(codes.shape[1] - 1)], 1)
        return torch.cat([first, rest], 1)

    def talker(self, embeds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One row's causal forward over embeds [T, D] → (code0 logits [T, V],
        hidden [T, D]), position t predicting frame t - P + 1."""
        s = self.dims.talker
        x = stack_forward(self.w["blocks"], embeds[None], s, causal(embeds.shape[0], embeds.device), True, False)
        hidden = _rms(x[0], self.w["ln_f"], s.eps)
        return hidden @ self.w["code0_head"], hidden

    def code_predictor(self, hidden: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """Each frame's code predictor over [its hidden state, its code0 and
        codes 1-14 embedded] → the 15 heads' logits [N, 15, codebook], head
        i from the output at position i + 1."""
        mc, s = self.w["mc"], self.dims.predictor
        emb = self.code_embeddings(codes)[:, :-1]
        x = torch.cat([hidden[:, None], emb], 1)
        x = _rms(stack_forward(mc["blocks"], x, s, causal(x.shape[1], x.device), True, False), mc["ln_f"], s.eps)
        return torch.einsum("nid,idv->niv", x[:, 1:], mc["heads"])

    def row_logits(self, text: str, codes: torch.Tensor, frames: int, voice: str,
                   language: str) -> tuple[torch.Tensor, torch.Tensor]:
        """A row teacher-forced on its served codes [>= frames, 16]: code0's
        logits for frames 0..frames [frames + 1, V] and the heads' for
        frames 0..frames-1 [frames, 15, codebook]."""
        with float32_mode(), torch.inference_mode():
            embeds, rest = self.prompt(text, voice, language)
            codes = codes[:frames].to(self.device, torch.long)
            pad = self.dims.text_pad
            trailing = torch.tensor([rest[f] if f < len(rest) else pad for f in range(frames)],
                                    dtype=torch.long, device=self.device)
            inputs = self.code_embeddings(codes).sum(1) + self.w["text_embed"][trailing]
            p = embeds.shape[0]
            logits, hidden = self.talker(torch.cat([embeds, inputs], 0))
            return logits[p - 1:], self.code_predictor(hidden[p - 1:p - 1 + frames], codes)

    def code2wav(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, 16] → the waveform [B, T x 1920] (see `placement`)."""
        with float32_mode(), torch.inference_mode():
            return self._code2wav(codes.to(self.device, torch.long))

    def _code2wav(self, codes):
        c2w, d = self.w["c2w"], self.dims
        b, t, g = codes.shape
        ids = codes.clamp(0, d.codebook - 1) + torch.arange(g, device=codes.device) * d.codebook
        x = c2w["code_embed"][ids].mean(2)
        x = stack_forward(c2w["blocks"], x, d.vocoder, causal(t, x.device, d.window), False, True)
        x = _rms(x, c2w["ln_f"], d.vocoder.eps).transpose(1, 2)
        for factor, st in zip(d.upsampling, c2w["upsample"]):
            x = _convnext(_tconv(x, st["tconv_w"], st["tconv_b"], factor), st["cnx"])
        x = _conv(x, c2w["dec_in_w"], c2w["dec_in_b"])
        for rate, blk in zip(d.rates, c2w["dec_blocks"]):
            x = _tconv(_snake(x, blk["snake_a"], blk["snake_b"]), blk["tconv_w"], blk["tconv_b"], rate)
            for u, dilation in zip(blk["units"], (1, 3, 9)):
                y = _conv(_snake(x, u["a1"], u["b1"]), u["c1_w"], u["c1_b"], dilation)
                x = x + _conv(_snake(y, u["a2"], u["b2"]), u["c2_w"], u["c2_b"])
        wave = _conv(_snake(x, c2w["out_snake_a"], c2w["out_snake_b"]), c2w["out_w"], c2w["out_b"])[:, 0]
        out = torch.zeros((b, t * d.samples_per_frame), device=wave.device)
        out[:, out.shape[1] - wave.shape[1]:] = wave.clamp(-1.0, 1.0)
        return out


def crossfade(pieces: Sequence[np.ndarray], sample_rate: int = SAMPLE_RATE, seconds: float = 0.1) -> np.ndarray:
    """TTSKit's ordered delivery (AudioOutput.swift): consecutive pieces
    joined by an equal-power crossfade of `seconds` (cos out, sin in)."""
    pieces = [np.asarray(p, np.float32) for p in pieces if len(p)]
    if not pieces:
        return np.zeros(0, np.float32)
    out, n_fade = pieces[0], int(seconds * sample_rate)
    for nxt in pieces[1:]:
        fade = min(n_fade, len(out), len(nxt))
        t = np.linspace(0.0, np.pi / 2, fade, dtype=np.float32)
        out = np.concatenate([out[:len(out) - fade], out[len(out) - fade:] * np.cos(t) + nxt[:fade] * np.sin(t),
                              nxt[fade:]])
    return out


def spans(lengths: Sequence[int], sample_rate: int = SAMPLE_RATE, seconds: float = 0.1) -> list[tuple[int, int]]:
    """Where each piece of `crossfade` lies in its output: (start, end)."""
    out, at, total, n_fade = [], 0, 0, int(seconds * sample_rate)
    for i, n in enumerate(lengths):
        if n == 0:
            out.append((total, total))
            continue
        fade = min(n_fade, total, n) if total else 0
        at = total - fade
        out.append((at, at + n))
        total = at + n
    return out
