"""The plain float32 reference of a Whisper configuration, and the weights
and windows that the benchmark hands to both sides.

It follows the published model (openai/whisper, the Hugging Face
`WhisperForConditionalGeneration` config): a log-mel front end, two strided
convolutions with GELU, sinusoidal encoder positions, pre-norm transformer
blocks (q, v and out with a bias, k without), a decoder with learned
positions, causal self-attention and cross-attention, and logits tied to the
token embedding. Every product runs in float32 with TF32 off (`float32_mode`).

The serving configuration's stated formats are worked out again here from
the bf16 weights that both sides get, never taken from the program:

  w8a16      every block linear as int8 codes with one scale per output
             column: scale = max|w| / 127 over the input rows (floor 1e-8),
             codes = round-half-even(w / scale) clipped to +-127, the scale
             then stored as bf16; the weight is codes x scale.
  int8 cross-KV  each layer's cross-attention K and V as int8 codes with a
             float32 scale per (window, head, channel) over the 1500 frames,
             by the same rounding.

Everything else (activations, the self-attention cache, the logits) is
float32. The GELU is the published exact (erf) one.

The weights are random, drawn on the device from `--seed` in a few large
calls, in the tree and scales of the port's `init_params` (the layout the
port's entry points take): linears [in, out] ~ N(0, 1/in), conv kernels
[out, in, 3] ~ N(0, 1/(3 in)), the token embedding ~ N(0, 1/d), decoder
positions ~ N(0, 0.01^2), biases 0, norms (1, 0), encoder positions the
fixed sinusoids.

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

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
WINDOW_SAMPLES = 480_000
N_FRAMES = 3_000
CHUNK = 1 << 26  # elements per random draw: a few large calls, not one per leaf


@dataclasses.dataclass(frozen=True)
class Dims:
    n_mels: int
    n_vocab: int
    n_audio_ctx: int
    n_text_ctx: int
    d_model: int
    encoder_heads: int
    decoder_heads: int
    encoder_layers: int
    decoder_layers: int
    encoder_ffn: int
    decoder_ffn: int

    @classmethod
    def of(cls, model: dict) -> "Dims":
        """From a configuration's `model` block (the published config's keys)."""
        return cls(
            model["num_mel_bins"], model["vocab_size"], model["max_source_positions"],
            model["max_target_positions"], model["d_model"], model["encoder_attention_heads"],
            model["decoder_attention_heads"], model["encoder_layers"], model["decoder_layers"],
            model["encoder_ffn_dim"], model["decoder_ffn_dim"],
        )


@dataclasses.dataclass(frozen=True)
class Tokens:
    """The special tokens of the published multilingual vocabularies."""

    eot: int
    sot: int
    n_languages: int

    @classmethod
    def of(cls, n_vocab: int) -> "Tokens":
        if n_vocab == 51866:  # v3: 100 languages
            return cls(50257, 50258, 100)
        if n_vocab == 51865:
            return cls(50257, 50258, 99)
        raise ValueError(f"no published vocabulary has {n_vocab} tokens")

    @property
    def transcribe(self) -> int:
        return self.sot + 1 + self.n_languages + 1

    @property
    def notimestamps(self) -> int:
        return self.sot + 1 + self.n_languages + 5

    @property
    def timestamp_begin(self) -> int:
        return self.sot + 1 + self.n_languages + 6

    def prompt(self, language_index: int = 0) -> list[int]:
        """sot, the language (0 = English), transcribe."""
        return [self.sot, self.sot + 1 + language_index, self.transcribe]


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


def sinusoids(length: int, channels: int) -> torch.Tensor:
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float64))
    scaled = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1).float()


def _draw(g: torch.Generator, shapes: Sequence[tuple], scale: float, device, dtype) -> list[torch.Tensor]:
    """N(0, scale^2) tensors of `shapes`, cut from one flat tensor filled in
    chunks of CHUNK draws (float32, scaled, then cast)."""
    total = sum(math.prod(s) for s in shapes)
    flat = torch.empty(total, dtype=dtype, device=device)
    for start in range(0, total, CHUNK):
        n = min(CHUNK, total - start)
        flat[start:start + n] = torch.randn(n, generator=g, device=device).mul_(scale)
    out, at = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(flat[at:at + n].view(s))
        at += n
    return out


def init_weights(dims: Dims, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The random weight tree of `seed` (see the module's docstring)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    d, ne, nd = dims.d_model, dims.encoder_layers, dims.decoder_layers

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def ln():
        return {"g": torch.ones(d, dtype=dtype, device=device), "b": zeros(d)}

    # the linears with d inputs, in one draw: per encoder layer q k v out
    # fc1, per decoder layer q k v out, cross q k v out, fc1
    enc_keys = ("q", "k", "v", "out", "fc1")
    dec_keys = ("q", "k", "v", "out", "cq", "ck", "cv", "cout", "fc1")

    def shape(key, ffn):
        return (d, ffn) if key == "fc1" else (d, d)

    wide = _draw(g, [shape(k, dims.encoder_ffn) for _ in range(ne) for k in enc_keys]
                 + [shape(k, dims.decoder_ffn) for _ in range(nd) for k in dec_keys], d ** -0.5, device, dtype)
    fc2_e = _draw(g, [(dims.encoder_ffn, d)] * ne, dims.encoder_ffn ** -0.5, device, dtype)
    fc2_d = _draw(g, [(dims.decoder_ffn, d)] * nd, dims.decoder_ffn ** -0.5, device, dtype)
    (embed,) = _draw(g, [(dims.n_vocab, d)], d ** -0.5, device, dtype)
    (conv1,) = _draw(g, [(d, dims.n_mels, 3)], (3 * dims.n_mels) ** -0.5, device, dtype)
    (conv2,) = _draw(g, [(d, d, 3)], (3 * d) ** -0.5, device, dtype)
    (dec_pos,) = _draw(g, [(dims.n_text_ctx, d)], 0.01, device, dtype)
    it = iter(wide)

    def attn(w):
        return {"q": {"w": w[0], "b": zeros(d)}, "k": {"w": w[1]},
                "v": {"w": w[2], "b": zeros(d)}, "out": {"w": w[3], "b": zeros(d)}}

    enc_blocks = []
    for layer in range(ne):
        w = [next(it) for _ in enc_keys]
        enc_blocks.append({"attn_ln": ln(), "attn": attn(w[:4]), "mlp_ln": ln(),
                           "fc1": {"w": w[4], "b": zeros(dims.encoder_ffn)},
                           "fc2": {"w": fc2_e[layer], "b": zeros(d)}})
    dec_blocks = []
    for layer in range(nd):
        w = [next(it) for _ in dec_keys]
        dec_blocks.append({"attn_ln": ln(), "attn": attn(w[:4]), "cross_attn_ln": ln(),
                           "cross_attn": attn(w[4:8]), "mlp_ln": ln(),
                           "fc1": {"w": w[8], "b": zeros(dims.decoder_ffn)},
                           "fc2": {"w": fc2_d[layer], "b": zeros(d)}})
    return {
        "encoder": {"conv1": {"w": conv1, "b": zeros(d)}, "conv2": {"w": conv2, "b": zeros(d)},
                    "pos_embed": sinusoids(dims.n_audio_ctx, d).to(device, dtype),
                    "blocks": enc_blocks, "ln_post": ln()},
        "decoder": {"token_embed": embed, "pos_embed": dec_pos, "blocks": dec_blocks, "ln": ln()},
    }


def quantize_int8(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over axis `dim` of a float32 tensor: (codes as float32,
    float32 scale with `dim` kept)."""
    scale = torch.clamp_min(x.abs().amax(dim=dim, keepdim=True) / 127.0, 1e-8)
    return torch.clamp(torch.round(x / scale), -127, 127), scale


def w8a16(w: torch.Tensor) -> torch.Tensor:
    """A [in, out] weight as the W8A16 format holds it, in float32."""
    codes, scale = quantize_int8(w.float(), 0)
    return codes * scale.to(torch.bfloat16).float()


LINEAR_KEYS = ("q", "k", "v", "out", "fc1", "fc2")


def float32_tree(tree: dict, weights: str) -> dict:
    """The reference's float32 weights: the bf16 tree cast, with every block
    linear in the stated weight format (`weights`: "bfloat16" or "w8a16")."""
    if weights not in ("bfloat16", "w8a16"):
        raise ValueError(f"the reference has no weight format {weights!r}")

    def walk(node, key=None):
        if isinstance(node, dict):
            if key in LINEAR_KEYS and "w" in node:
                out = {k: v.float() for k, v in node.items()}
                if weights == "w8a16":
                    out["w"] = w8a16(node["w"])
                return out
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        return node.float()

    return walk(tree)


# --- front end -----------------------------------------------------------------


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa's slaney mel filterbank for 16 kHz and a 400-point FFT (what
    Whisper's published mel_filters.npz holds): [n_mels, 201]."""

    def to_mel(f):
        f = np.asarray(f, np.float64)
        linear = f * 3.0 / 200.0
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (math.log(6.4) / 27.0)
        return np.where(f >= 1000.0, log, linear)

    def to_hz(m):
        m = np.asarray(m, np.float64)
        linear = m * 200.0 / 3.0
        log = 1000.0 * np.exp((math.log(6.4) / 27.0) * (m - 15.0))
        return np.where(m >= 15.0, log, linear)

    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    edges = to_hz(np.linspace(to_mel(0.0), to_mel(SAMPLE_RATE / 2), n_mels + 2))
    widths = np.diff(edges)
    ramps = edges[:, None] - freqs[None, :]
    rising = -ramps[:-2] / widths[:-1, None]
    falling = ramps[2:] / widths[1:, None]
    weights = np.maximum(0.0, np.minimum(rising, falling))
    return (weights * (2.0 / (edges[2:] - edges[:-2]))[:, None]).astype(np.float32)


def log_mel(windows: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, 480000] float32 audio → the model's input [B, n_mels, 3000]:
    power spectrum of a periodic Hann STFT (reflect-padded, the last frame
    dropped), slaney mel, log10 with a 1e-10 floor, clamped to 8 below each
    window's maximum, then (x + 4) / 4."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32, device=windows.device)
    spec = torch.stft(windows, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.real ** 2 + spec.imag ** 2
    filters = torch.from_numpy(mel_filters(n_mels)).to(windows.device)
    logm = torch.log10(torch.clamp_min(filters @ power, 1e-10))
    logm = torch.maximum(logm, logm.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logm + 4.0) / 4.0


def vad_windows(audio: np.ndarray, max_len: int = WINDOW_SAMPLES) -> list[tuple[int, int]]:
    """The ≤30 s windows of a recording longer than one window, as
    WhisperKit's energy VAD chunker cuts them (AudioChunker.swift `chunkAll`,
    EnergyVAD.swift) from its whole 10 ms frames (the samples past the last
    whole frame are not transcribed): each chunk ends at the middle of the
    longest run of silent 0.1 s frames (RMS ≤ 0.02) in the second half of
    the next 30 s, or at its end. A clip of one window or less is one
    window. (start, length)."""
    if len(audio) <= max_len:
        return [(0, len(audio))]
    n = len(audio) // HOP * HOP
    frame = SAMPLE_RATE // 10
    out, start = [], 0
    while start < n:
        if n - start <= max_len:
            out.append((start, n - start))
            break
        end = start + max_len
        half = start + max_len // 2
        seg = audio[half:end].astype(np.float64)
        n_frames = -(-len(seg) // frame)
        rms = np.array([np.sqrt(np.mean(np.square(seg[i * frame:(i + 1) * frame]))) for i in range(n_frames)])
        active = rms.astype(np.float32) > np.float32(0.02)
        best, run = None, None
        for i in range(n_frames + 1):
            quiet = i < n_frames and not active[i]
            if quiet and run is None:
                run = i
            elif not quiet and run is not None:
                if best is None or i - run > best[1] - best[0]:
                    best = (run, i)
                run = None
        split = end if best is None else half + (best[0] + best[1]) // 2 * frame
        if split <= start:
            split = end
        out.append((start, split - start))
        start = split
    return out


# --- the model ---------------------------------------------------------------------


def _ln(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], 1e-5)


def _linear(x, p):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _heads(x, n):
    b, t, d = x.shape
    return x.view(b, t, n, d // n).transpose(1, 2)


def _attend(q, k, v, mask=None):
    scores = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        scores = scores + mask
    out = torch.softmax(scores, dim=-1) @ v
    b, h, t, dh = out.shape
    return out.transpose(1, 2).reshape(b, t, h * dh)


def _mlp(x, bp):
    return _linear(F.gelu(_linear(_ln(x, bp["mlp_ln"]), bp["fc1"])), bp["fc2"])


class Reference:
    """The configuration's forward pass in float32 over a bf16 weight tree."""

    def __init__(self, tree: dict, dims: Dims, serving: dict):
        self.dims = dims
        self.serving = serving
        self.w = float32_tree(tree, serving["weights"])

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        enc, h = self.w["encoder"], self.dims.encoder_heads
        x = F.gelu(F.conv1d(mel, enc["conv1"]["w"], enc["conv1"]["b"], padding=1))
        x = F.gelu(F.conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], stride=2, padding=1))
        x = x.transpose(1, 2) + enc["pos_embed"]
        for bp in enc["blocks"]:
            a = _ln(x, bp["attn_ln"])
            x = x + _linear(_attend(_heads(_linear(a, bp["attn"]["q"]), h), _heads(_linear(a, bp["attn"]["k"]), h),
                                    _heads(_linear(a, bp["attn"]["v"]), h)), bp["attn"]["out"])
            x = x + _mlp(x, bp)
        return _ln(x, enc["ln_post"])

    def cross_kv(self, enc_out: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Each decoder layer's cross-attention K and V [B, H, 1500, Dh], in
        the stated cross-KV format."""
        h, out = self.dims.decoder_heads, []
        for bp in self.w["decoder"]["blocks"]:
            kv = [_heads(_linear(enc_out, bp["cross_attn"][name]), h) for name in ("k", "v")]
            if self.serving["cross_kv"] == "int8":
                kv = [torch.mul(*quantize_int8(x, 2)) for x in kv]
            elif self.serving["cross_kv"] != "bfloat16":
                raise ValueError(f"the reference has no cross-KV format {self.serving['cross_kv']!r}")
            out.append(tuple(kv))
        return out

    def decode(self, tokens: torch.Tensor, cross: list) -> torch.Tensor:
        """Teacher-forced logits [B, T, V] of token rows [B, T] (all rows of
        one length), position t predicting token t + 1."""
        dec, h = self.w["decoder"], self.dims.decoder_heads
        t = tokens.shape[1]
        x = dec["token_embed"][tokens] + dec["pos_embed"][:t]
        mask = torch.full((t, t), float("-inf"), device=x.device).triu_(1)
        for bp, (ck, cv) in zip(dec["blocks"], cross):
            a = _ln(x, bp["attn_ln"])
            x = x + _linear(_attend(_heads(_linear(a, bp["attn"]["q"]), h), _heads(_linear(a, bp["attn"]["k"]), h),
                                    _heads(_linear(a, bp["attn"]["v"]), h), mask), bp["attn"]["out"])
            a = _ln(x, bp["cross_attn_ln"])
            x = x + _linear(_attend(_heads(_linear(a, bp["cross_attn"]["q"]), h), ck, cv), bp["cross_attn"]["out"])
            x = x + _mlp(x, bp)
        return _ln(x, dec["ln"]) @ dec["token_embed"].T

    def logits(self, windows: Sequence[np.ndarray], rows: Sequence[Sequence[int]], block: int = 4):
        """For each window's audio (≤ 480000 samples) and its token row
        (prompt + served tokens), yield the logits [T, V] on the device,
        computed in blocks of `block` windows."""
        dev = self.w["decoder"]["token_embed"].device
        with float32_mode(), torch.inference_mode():
            for at in range(0, len(windows), block):
                part = windows[at:at + block]
                audio = np.zeros((len(part), WINDOW_SAMPLES), np.float32)
                for i, w in enumerate(part):
                    audio[i, :min(len(w), WINDOW_SAMPLES)] = w[:WINDOW_SAMPLES]
                cross = self.cross_kv(self.encode(log_mel(torch.from_numpy(audio).to(dev), self.dims.n_mels)))
                for i, row in enumerate(rows[at:at + block]):
                    one = [(k[i:i + 1], v[i:i + 1]) for k, v in cross]
                    tokens = torch.tensor([list(row)], dtype=torch.long, device=dev)
                    yield self.decode(tokens, one)[0]
