"""The frozen float32 reference against the port's CPU path at tiny widths:
the same log-mel, the same VAD windows, the same W8A16 and int8 cross-KV
formats worked out again from the same weights, and the same forward pass
(the port's GELU is the tanh form, the reference's the published erf one:
the one departure, well inside the tolerance below). The test may import
both; the reference itself imports nothing of the port."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.references import whisper as ref
from benchmark.workload import synth_speechlike_audio
from conftest import TINY

MODEL = {"vocab_size": 51866, "max_source_positions": 1500, "max_target_positions": 448, **TINY}


def port_dims(d: ref.Dims):
    from whisperkit_tpu_torch.models.whisper import WhisperDims

    return WhisperDims(d.n_mels, d.n_vocab, d.n_audio_ctx, d.d_model, d.encoder_heads, d.encoder_layers,
                       d.n_text_ctx, d.d_model, d.decoder_heads, d.decoder_layers)


def test_log_mel_matches_the_port():
    from whisperkit_tpu_torch.ops.mel import log_mel_spectrogram

    audio = np.zeros((2, ref.WINDOW_SAMPLES), np.float32)
    audio[0] = synth_speechlike_audio(30, seed=1)
    audio[1, :7 * 16000] = synth_speechlike_audio(7, seed=2)
    for n_mels in (80, 128):
        mine = ref.log_mel(torch.from_numpy(audio), n_mels)
        port = log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels)
        assert mine.shape == port.shape == (2, n_mels, 3000)
        assert float((mine - port).abs().max()) < 5e-4


def test_vad_windows_match_the_port():
    from whisperkit_tpu_torch.audio.chunker import VADAudioChunker

    for seed, seconds in ((1, 200), (2, 95.5), (3, 30), (4, 12), (5, 480_148 / 16_000)):
        audio = synth_speechlike_audio(seconds, seed=seed)
        if len(audio) <= ref.WINDOW_SAMPLES:
            assert ref.vad_windows(audio) == [(0, len(audio))]
            continue
        # the pipeline and the batcher chunk the audio's whole 10 ms frames
        chunks = VADAudioChunker().chunk_all(audio[: len(audio) // 160 * 160])
        assert ref.vad_windows(audio) == [(c.seek_offset_index, len(c.audio_samples)) for c in chunks]


def test_weight_formats_match_the_port():
    from whisperkit_tpu_torch.models.whisper import _q8_quantize
    from whisperkit_tpu_torch.ops.quant import dequantize_weight, quantize_weight

    w = (torch.randn(256, 192) * 0.05).to(torch.bfloat16)
    assert torch.equal(ref.w8a16(w), dequantize_weight(quantize_weight(w), torch.float32))
    x = torch.randn(2, 3, 1500, 32) * 0.7
    codes, scale = ref.quantize_int8(x, 2)
    port_codes, port_scale = _q8_quantize(x, -2)
    assert torch.equal(codes, port_codes.float()) and torch.equal(scale, port_scale)


def test_init_weights_is_the_ports_tree_and_the_seeds():
    from whisperkit_tpu_torch.models.whisper import init_params

    dims = ref.Dims.of(MODEL)
    mine = ref.init_weights(dims, 2**31 + 3, "cpu")
    port = init_params(0, port_dims(dims), torch.bfloat16, device="cpu")
    port["decoder"].pop("token_embed_f32")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(mine) == shapes(port)
    again = ref.init_weights(dims, 2**31 + 3, "cpu")
    other = ref.init_weights(dims, 2**31 + 4, "cpu")
    assert torch.equal(mine["decoder"]["token_embed"], again["decoder"]["token_embed"])
    assert not torch.equal(mine["decoder"]["token_embed"], other["decoder"]["token_embed"])
    w = mine["encoder"]["blocks"][0]["fc1"]["w"].float()
    assert abs(float(w.std()) * 64 ** 0.5 - 1.0) < 0.05


def test_forward_matches_the_ports_float32_path():
    """Encoder, cross-KV and a teacher-forced decoder pass in float32 on the
    same weights: the encoder's output within 1e-3 of its scale, the logits
    within 2e-2 (the port's int8 cross-attention rounds the query and the
    probabilities to int8 as well) and the same best token everywhere."""
    from whisperkit_tpu_torch.models import whisper as model

    dims = ref.Dims.of(MODEL)
    tree = ref.init_weights(dims, 11, "cpu", torch.float32)
    tree["decoder"]["token_embed"] = tree["decoder"]["token_embed"] * 4
    reference = ref.Reference(tree, dims, {"weights": "bfloat16", "cross_kv": "int8"})
    params = {**tree, "decoder": {**tree["decoder"], "token_embed_f32": tree["decoder"]["token_embed"]}}
    audio = torch.from_numpy(synth_speechlike_audio(30, seed=5))[None]
    tokens = torch.tensor([[50258, 50259, 50360, 50364, 1000, 2000, 50400, 50401, 77]])
    with ref.float32_mode(), torch.inference_mode():
        mel = ref.log_mel(audio, dims.n_mels)
        enc = reference.encode(mel)
        want = reference.decode(tokens, reference.cross_kv(enc))[0]
        pdims = port_dims(dims)
        port_enc = model.encoder_forward(params, mel, pdims)
        ck, cv = model.compute_cross_kv_quantized(params, port_enc, pdims)
        kv_k, kv_v = model.init_kv_cache(pdims, 1, 16, torch.float32, "cpu")
        got = model.decoder_forward(params, tokens, 0, kv_k, kv_v, ck, cv, pdims)[0]
    assert float((enc - port_enc).abs().max()) < 1e-3 * float(enc.abs().max())
    assert float((want - got).abs().max()) < 2e-2 * float(want.abs().max())
    assert torch.equal(want.argmax(-1), got.argmax(-1))
