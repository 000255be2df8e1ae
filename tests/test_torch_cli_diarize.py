"""The port's CLI for diarization and streaming, `diarize`, `transcribe
--diarization` and `transcribe --stream-simulated` (which the port's CLI
once refused with exit 2), against the JAX package's CLI, on the CPU.

Both CLIs transcribe with pipelines that share one float32 tree (drawn by
the port's init_params, in JAX's layout for JAX) and diarize with their
own `DiarizePipeline.from_pretrained` of one small pyannote folder
(`tools/checkpoint.write_pyannote_checkpoint(full=False)`). Their printed
output, RTTM files and JSON reports must be equal.
"""

import dataclasses
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.cli import main as jcli
from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.pipelines.whisper import WhisperPipeline as JaxPipeline
from whisperkit_tpu_torch.cli import main as cli
from whisperkit_tpu_torch.core.configurations import WhisperConfig
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.tools.checkpoint import write_pyannote_checkpoint

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 448, 64, 4, 2)
HEADS = np.asarray([[0, 1], [1, 2]], np.int32)


@pytest.fixture(scope="module")
def pipes():
    """A JAX and a port pipeline on the same float32 weights and heads."""
    tparams = model.init_params(0, DIMS, torch.float32, "cpu")
    jax_pipe = JaxPipeline(
        jconf.WhisperConfig(compute_options=jconf.ComputeOptions(dp_size=1), load=False),
        dims=jmodel.WhisperDims(*dataclasses.astuple(DIMS)),
        params=jax.tree.map(jnp.asarray, model.params_to_numpy(tparams)), alignment_heads=HEADS,
    )
    torch_pipe = WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=tparams, alignment_heads=HEADS,
                                 device="cpu")
    return jax_pipe, torch_pipe


def _assert_same_json(ours, ref, path="$"):
    """Equal JSON, numbers within 0.01 (times, log-probs), ints exact."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(ref), path
        for k in ref:
            _assert_same_json(ours[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same_json(a, b, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert ours == pytest.approx(ref, abs=0.01), path
    else:
        assert ours == ref, path


@pytest.fixture(scope="module")
def pyannote_folder(tmp_path_factory):
    """Small speaker models under the published names; JAX's converter reads
    them with RESNET34_BLOCKS patched for this module."""
    from whisperkit_tpu.models import pyannet as jpyannet

    root = tmp_path_factory.mktemp("pyannote")
    write_pyannote_checkpoint(root, seed=0, full=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpyannet, "RESNET34_BLOCKS", {"layer1": 2, "layer2": 2, "layer3": 2, "layer4": 2})
        yield root


def _speech_wav(path, seconds, seed):
    from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio

    audio = synth_speechlike_audio(seconds, seed=seed)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())
    return path


@pytest.mark.parametrize("case", ["diarize", "diarization", "stream_simulated"])
def test_cli_formerly_out_of_slice_matches_jax(case, tmp_path, pipes, pyannote_folder, monkeypatch, capsys):
    """The three features the port used to refuse with exit 2 now run and
    print what the JAX CLI prints: `diarize` (stdout and the RTTM file, both
    packages loading the same pyannote folder), `transcribe --diarization`
    (segments labelled by speaker, stdout and the JSON report) and
    `transcribe --stream-simulated` (the replay's output, its last line the
    confirmed text). Transcription runs on both CLIs' pipelines with the
    same weights."""
    jax_pipe, torch_pipe = pipes
    monkeypatch.setattr(jcli, "_build_pipeline", lambda args: jax_pipe)
    monkeypatch.setattr(cli, "_build_pipeline", lambda args: torch_pipe)
    wav = _speech_wav(tmp_path / "talk.wav", 6.0 if case == "stream_simulated" else 12.0, 3)
    if case == "diarize":
        argv = ["diarize", "--model-folder", str(pyannote_folder), "--audio-path", str(wav), "--num-speakers", "2"]
    else:
        argv = ["transcribe", "--audio-path", str(wav), "--language", "en", "--sample-length", "12",
                "--temperature-fallback-count", "0",
                *(["--stream-simulated"] if case == "stream_simulated" else
                  ["--diarization", "--model-folder", str(pyannote_folder), "--report", "--report-format", "json"])]
    outputs = []
    for main, extra, name in ((jcli.main, [], "jax"), (cli.main, ["--device", "cpu"], "torch")):
        out_dir = tmp_path / name
        out_dir.mkdir()
        paths = (["--rttm-path", str(out_dir / "talk.rttm")] if case == "diarize" else
                 ["--report-path", str(out_dir)] if case == "diarization" else [])
        assert main(argv + extra + paths) == 0
        outputs.append(capsys.readouterr().out)
    assert outputs[1] == outputs[0] and outputs[1].strip()
    if case == "diarize":
        rttm = (tmp_path / "torch" / "talk.rttm").read_text()
        assert rttm == (tmp_path / "jax" / "talk.rttm").read_text() and rttm.startswith("SPEAKER audio 1 ")
    elif case == "diarization":
        ours, ref = (json.loads((tmp_path / n / "talk.json").read_text()) for n in ("torch", "jax"))
        _assert_same_json(ours, ref)
        assert ours["segments"] and all(s["text"].startswith("[SPEAKER_") for s in ours["segments"])
    else:
        assert outputs[1].splitlines()[-1].strip()
