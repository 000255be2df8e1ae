"""The Qwen3 decode glue's kernels (csrc/qwen3_decode.cu) on the card,
against their plain versions at the TTS frame's shapes, within the limits
of whisperkit_tpu_torch/tools/qwen3_decode_check.py. Marked `card`: each
test skips where there is no CUDA device. This file imports nothing of
JAX, so it runs on the card's machine without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_qwen3_decode_card.py
"""

from __future__ import annotations

import pytest
import torch

from whisperkit_tpu_torch.tools import qwen3_decode_check as check

pytestmark = pytest.mark.card

ATTENTION = [("talker", 1, s) for s in check.TALKER_SLOTS] + [("cp", t, s) for t, s in check.CP_PASSES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.parametrize("rows", [check.ROWS, 2 * check.ROWS])
@pytest.mark.parametrize("d", [check.D_MODEL, 2 * check.D_MODEL])
@pytest.mark.parametrize("with_y", [False, True], ids=["norm", "add"])
def test_add_rms_norm(cuda, rows, d, with_y):
    assert not check.failures({"add_rms_norm": check.check_add_rms_norm(cuda, rows, d, with_y)})


@pytest.mark.parametrize("rows", [check.ROWS, 2 * check.ROWS])
def test_swiglu(cuda, rows):
    assert not check.failures({"swiglu": check.check_swiglu(cuda, rows, check.D_FF)})


@pytest.mark.parametrize("kind, t, slot", ATTENTION)
def test_decode_attention(cuda, kind, t, slot):
    results = {"attention/case": check.check_attention(check.attention_case(cuda, kind, slot, t))}
    assert not check.failures(results), results


@pytest.mark.parametrize("kind, t, slot", [ATTENTION[1], ATTENTION[-1]])
def test_decode_attention_graph_replays(cuda, kind, t, slot):
    assert check.attention_graph_equal(check.attention_case(cuda, kind, slot, t))


def test_frame_logits_within_the_plain_paths_spread(cuda):
    from whisperkit_tpu_torch.pipelines.tts import TTS_VARIANTS, TTSPipeline

    with torch.inference_mode():
        pipe = TTSPipeline(TTS_VARIANTS["0.6b"], seed=check.SEED, quantize="w8a16", device=cuda)
    frame = check.check_frame(pipe)
    assert not check.frame_failures(frame), frame
