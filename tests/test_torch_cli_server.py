"""The port's entry points — the OpenAI-compatible server
(server/openai_api.py on `http.server`), its schema, the CLI and the CUDA
probe — against the JAX package's, on the CPU.

The same requests go to the JAX aiohttp app (`TestClient`) and to the
port's stdlib server on an ephemeral port, each over a pipeline with the
same random float32 weights and alignment heads. Status codes, JSON bodies
(tokens and text equal, times to 0.01 s), srt/vtt/text bodies and the SSE
event sequence must be equal, and the port's responses must pass both the
JAX package's pydantic models and the port's own. The decode ladder is held
at greedy in both pipelines (JAX keys and torch generators draw different
numbers at t > 0); the server's options are otherwise its own.
"""

import asyncio
import dataclasses
import io
import json
import select
import socket
import subprocess
import sys
import threading
import time
import types
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperkit_tpu.cli import main as jcli
from whisperkit_tpu.core import configurations as jconf
from whisperkit_tpu.models import whisper as jmodel
from whisperkit_tpu.pipelines.whisper import WhisperPipeline as JaxPipeline
from whisperkit_tpu.server import schema as jschema
from whisperkit_tpu_torch.cli import main as cli
from whisperkit_tpu_torch.core import device_probe
from whisperkit_tpu_torch.core.configurations import WhisperConfig
from whisperkit_tpu_torch.core.errors import DeviceUnavailable
from whisperkit_tpu_torch.models import whisper as model
from whisperkit_tpu_torch.pipelines.whisper import WhisperPipeline
from whisperkit_tpu_torch.server import client, schema
from whisperkit_tpu_torch.server.openai_api import create_app
from whisperkit_tpu_torch.tools.checkpoint import write_hf_checkpoint, write_synthetic_tokenizer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

REPO = Path(__file__).resolve().parent.parent
# a 448-token text context: the server decodes the 224-token default budget
DIMS = model.WhisperDims(80, 207, 1500, 64, 4, 2, 448, 64, 4, 2)
JDIMS = jmodel.WhisperDims(*dataclasses.astuple(DIMS))
HEADS = np.asarray([[0, 1], [1, 2]], np.int32)


def _wav_bytes(seconds, seed):
    pcm = (np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1 * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JDIMS, dtype=jnp.float32)


@pytest.fixture(scope="module")
def pipes(jparams):
    jax_pipe = JaxPipeline(
        jconf.WhisperConfig(compute_options=jconf.ComputeOptions(dp_size=1), load=False),
        dims=JDIMS, params=jparams, alignment_heads=HEADS,
    )
    tparams = model.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    torch_pipe = WhisperPipeline(WhisperConfig(load=False), dims=DIMS, params=tparams, alignment_heads=HEADS,
                                 device="cpu")
    return jax_pipe, torch_pipe


@pytest.fixture
def greedy(monkeypatch):
    """Both pipelines decode at temperature 0 only (fallback ladder off)."""
    for cls in (JaxPipeline, WhisperPipeline):
        orig = cls._decode_with_fallback

        def forced(self, ck, cv, options, language, window_index, _orig=orig):
            return _orig(self, ck, cv, dataclasses.replace(options, temperature_fallback_count=0), language,
                         window_index)

        monkeypatch.setattr(cls, "_decode_with_fallback", forced)


# -- the server against the JAX app -------------------------------------------------

WAV = _wav_bytes(2.0, 0)
REQUESTS = [  # (name, method, path, fields, with a file)
    ("health", "GET", "/health", [], False),
    ("json", "POST", "/v1/audio/transcriptions", [("language", "en")], True),
    ("verbose_words", "POST", "/v1/audio/transcriptions",
     [("language", "en"), ("response_format", "verbose_json"), ("timestamp_granularities[]", "word")], True),
    ("srt", "POST", "/v1/audio/transcriptions", [("language", "en"), ("response_format", "srt")], True),
    ("vtt", "POST", "/v1/audio/transcriptions", [("language", "en"), ("response_format", "vtt")], True),
    ("text", "POST", "/v1/audio/transcriptions", [("language", "en"), ("response_format", "text")], True),
    ("translate", "POST", "/v1/audio/translations", [("model", "whisper-1"), ("response_format", "verbose_json")],
     True),
    ("stream", "POST", "/v1/audio/transcriptions", [("language", "en"), ("stream", "true")], True),
    ("latency", "POST", "/v1/audio/transcriptions", [("language", "en"), ("priority", "latency")], True),
    ("no_file", "POST", "/v1/audio/transcriptions", [("language", "en")], False),
    ("bad_priority", "POST", "/v1/audio/transcriptions", [("language", "en"), ("priority", "bogus")], True),
    ("bad_temperature", "POST", "/v1/audio/transcriptions", [("temperature", "warm")], True),
    ("health_after", "GET", "/health", [], False),
]


def _jax_responses(pipe, requests, **app_kw):
    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    from whisperkit_tpu.server.openai_api import create_app as jcreate_app

    async def go():
        out = {}
        async with TestClient(TestServer(jcreate_app(pipe, **app_kw))) as c:
            for name, method, path, fields, with_file in requests:
                if method == "GET":
                    r = await c.get(path)
                else:
                    form = aiohttp.FormData(default_to_multipart=True)  # as the port's client
                    for k, v in fields:
                        form.add_field(k, v)
                    if with_file:
                        form.add_field("file", WAV, filename="a.wav", content_type="audio/wav")
                    r = await c.post(path, data=form)
                out[name] = (r.status, r.content_type, await r.read())
        return out

    return asyncio.run(go())


def _port_responses(pipe, requests, **app_kw):
    app = create_app(pipe, **app_kw)
    host, port = app.start()
    try:
        out = {}
        for name, method, path, fields, with_file in requests:
            url = f"http://{host}:{port}{path}"
            if method == "GET":
                status, headers, body = client.get(url, timeout=300)
            else:
                status, headers, body = client.post(url, fields, [("file", "a.wav", WAV)] if with_file else [],
                                                    timeout=300)
            out[name] = (status, headers["Content-Type"].split(";")[0], body)
        return out
    finally:
        app.close()


def _sse(body: bytes) -> list:
    events = []
    for block in body.decode().split("\n\n"):
        if block.startswith("data: "):
            data = block[len("data: "):]
            events.append(data if data == "[DONE]" else json.loads(data))
    return events


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


@pytest.mark.parametrize("batching", [True, False], ids=["batching", "serialized"])
def test_server_responses_match_jax(pipes, greedy, batching):
    jax_pipe, torch_pipe = pipes
    requests = REQUESTS if batching else [r for r in REQUESTS if r[0] in ("json", "verbose_words", "stream")]
    ref = _jax_responses(jax_pipe, requests, batching=batching, max_batch=4)
    ours = _port_responses(torch_pipe, requests, batching=batching, max_batch=4)
    for name, *_ in requests:
        (status, ctype, body), (jstatus, jctype, jbody) = ours[name], ref[name]
        assert (status, ctype) == (jstatus, jctype), name
        if name == "stream":
            events, jevents = _sse(body), _sse(jbody)
            assert [e if e == "[DONE]" else e["type"] for e in events] == [
                e if e == "[DONE]" else e["type"] for e in jevents]
            assert events == jevents
            assert [e["type"] for e in events[:-1]][-1] == "transcript.text.done"
        elif ctype == "application/json":
            _assert_same_json(json.loads(body), json.loads(jbody))
        else:
            assert body.decode() == jbody.decode(), name
    statuses = {name: ours[name][0] for name, *_ in requests}
    if batching:
        assert statuses["no_file"] == statuses["bad_priority"] == statuses["bad_temperature"] == 400
        assert json.loads(ours["no_file"][2]) == {"error": {"message": "missing file field"}}
        assert json.loads(ours["translate"][2])["task"] == "translate"
        assert json.loads(ours["health_after"][2])["jobs_run"] == 8
    words = json.loads(ours["verbose_words"][2])
    assert words["words"] and words["segments"]
    # the port's responses pass both packages' schema models
    for name, model_ours, model_jax in (("verbose_words", schema.VerboseTranscriptionResponse,
                                         jschema.VerboseTranscriptionResponse),
                                        ("json", schema.TranscriptionResponse, jschema.TranscriptionResponse)):
        payload = json.loads(ours[name][2])
        model_ours.validate(payload)
        model_jax.model_validate(payload)
    for event in _sse(ours["stream"][2])[:-1]:
        (schema.StreamDeltaEvent if event["type"].endswith("delta") else schema.StreamDoneEvent).validate(event)
        (jschema.StreamDeltaEvent if event["type"].endswith("delta") else jschema.StreamDoneEvent).model_validate(event)
    if batching:
        for name in ("health", "health_after"):
            schema.HealthResponse.validate(json.loads(ours[name][2]))
            jschema.HealthResponse.model_validate(json.loads(ours[name][2]))
        for name in ("no_file", "bad_priority"):
            schema.ErrorResponse.validate(json.loads(ours[name][2]))
            jschema.ErrorResponse.model_validate(json.loads(ours[name][2]))


def test_server_rate_limit_and_bad_bodies(pipes, monkeypatch):
    """Past max_concurrent_requests a request gets 429 (the counter is
    taken under a lock); /health stays reachable; a body that is not
    multipart/form-data is a 400; an unknown route a 404."""
    pipe = pipes[1]
    entered, release = threading.Event(), threading.Event()
    orig = WhisperPipeline.transcribe

    def slow(self, audio, options, callback=None):
        entered.set()
        assert release.wait(60)
        # the request only has to hold its slot: a short greedy decode, not
        # the server's 224-token budget and fallback ladder, which take
        # minutes on a host loaded by the parallel test run
        return orig(self, audio, dataclasses.replace(options, sample_length=8, temperature_fallback_count=0),
                    callback)

    monkeypatch.setattr(WhisperPipeline, "transcribe", slow)
    app = create_app(pipe, batching=False, max_concurrent_requests=1)
    host, port = app.start()
    base = f"http://{host}:{port}"
    try:
        first = {}
        t = threading.Thread(target=lambda: first.update(r=client.post(
            base + "/v1/audio/transcriptions", [("language", "en")], [("file", "a.wav", WAV)], timeout=300)))
        t.start()
        assert entered.wait(60)
        status, _, body = client.post(base + "/v1/audio/transcriptions", [("language", "en")],
                                      [("file", "a.wav", WAV)], timeout=60)
        assert status == 429
        assert json.loads(body) == {"error": {"message": "too many concurrent requests", "type": "rate_limit_exceeded"}}
        assert client.get(base + "/health", timeout=60)[0] == 200
        release.set()
        t.join(300)
        assert not t.is_alive() and first["r"][0] == 200
        import urllib.request

        req = urllib.request.Request(base + "/v1/audio/transcriptions", data=b"{}", method="POST",
                                     headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            raise AssertionError("a JSON body was accepted")
        except urllib.error.HTTPError as e:
            assert e.code == 400 and "multipart/form-data" in json.loads(e.read())["error"]["message"]
        assert client.get(base + "/nowhere", timeout=60)[0] == 404
    finally:
        release.set()
        app.close()


@pytest.mark.parametrize("status", [429, 404])
def test_server_answer_reaches_a_client_still_sending(status):
    """A 429 (too many requests in flight) or a 404 is answered without
    using the body, but the server reads the body before it answers and
    closes. A client that writes its several-hundred-KB body only after the
    server could have answered, and waits before it reads, must get the
    status and its JSON: a socket closed over unread bytes sends a reset,
    which fails the client's write or drops the answer."""
    app = create_app(types.SimpleNamespace(model_state="loaded"), batching=False,
                     max_concurrent_requests=0 if status == 429 else 1)
    host, port = app.start()
    path = "/v1/audio/transcriptions" if status == 429 else "/nowhere"
    ctype, body = client.encode_multipart([("language", "en")], [("file", "a.wav", bytes(600_000))])
    head = (f"POST {path} HTTP/1.1\r\nHost: {host}\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode()
    data = b""
    try:
        with socket.create_connection((host, port), timeout=60) as s:
            s.sendall(head)
            select.select([s], [], [], 1.0)  # a server that does not wait for the body answers here
            s.sendall(body)
            time.sleep(0.2)
            while chunk := s.recv(1 << 16):
                data += chunk
    finally:
        app.close()
    status_line, _, rest = data.partition(b"\r\n")
    assert status_line.split(b" ")[1] == str(status).encode()
    payload = json.loads(rest.partition(b"\r\n\r\n")[2])
    if status == 429:
        assert payload == {"error": {"message": "too many concurrent requests", "type": "rate_limit_exceeded"}}
    else:
        assert payload == {"error": {"message": "no route POST /nowhere"}}


def test_server_frees_the_slot_before_answering(monkeypatch):
    """With max_concurrent_requests=1, a client that has its answer (a 400)
    and at once sends its next request gets that request served (a 404),
    even when the handler thread that answered is held up right after
    writing: the server frees the request's slot before the answer goes
    out, not after."""
    import urllib.request

    from whisperkit_tpu_torch.server.openai_api import OpenAIApp

    send = OpenAIApp._send

    def held_up_after_writing(h, *args):
        send(h, *args)
        time.sleep(0.5)

    monkeypatch.setattr(OpenAIApp, "_send", staticmethod(held_up_after_writing))
    app = create_app(types.SimpleNamespace(model_state="loaded"), batching=False, max_concurrent_requests=1)
    host, port = app.start()
    try:
        req = urllib.request.Request(f"http://{host}:{port}/v1/audio/transcriptions", data=b"{}", method="POST",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400
        assert client.get(f"http://{host}:{port}/nowhere", timeout=60)[0] == 404
    finally:
        app.close()


@pytest.mark.parametrize("batching", [True, False], ids=["batching", "serialized"])
def test_server_concurrent_streams(pipes, greedy, batching):
    """Concurrent SSE requests each end with transcript.text.done and
    [DONE]: with batching they share the batcher, without it they take
    turns on the pipeline's lock."""
    app = create_app(pipes[1], batching=batching, max_batch=4)
    host, port = app.start()
    bodies = []
    try:
        def one():
            bodies.append(client.post(f"http://{host}:{port}/v1/audio/transcriptions",
                                      [("language", "en"), ("stream", "true")], [("file", "t.wav", WAV)],
                                      timeout=300))

        threads = [threading.Thread(target=one) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
    finally:
        app.close()
    assert len(bodies) == 3
    for status, _, body in bodies:
        events = _sse(body)
        assert status == 200 and events[-1] == "[DONE]"
        assert events[-2]["type"] == "transcript.text.done"
        assert any(e["type"] == "transcript.text.delta" for e in events[:-1])


def test_schema_validate_raises_on_bad_payloads():
    ok = {"task": "transcribe", "language": "en", "duration": 2, "text": "x", "segments": [
        {"id": 0, "seek": 0, "start": 0.0, "end": 1.0, "text": "x", "tokens": [1, 2], "temperature": 0.0,
         "avg_logprob": -0.5, "compression_ratio": 1.0, "no_speech_prob": 0.1}]}
    parsed = schema.VerboseTranscriptionResponse.validate(ok)
    assert parsed.duration == 2.0 and parsed.segments[0].tokens == [1, 2] and parsed.words is None
    bad_payloads = [  # (payload, whether pydantic, which coerces numeric strings, rejects it too)
        ({k: v for k, v in ok.items() if k != "segments"}, True),
        (dict(ok, segments=[dict(ok["segments"][0], tokens=[1.5])]), True),
        (dict(ok, words=[{"word": "x", "start": 0.0}]), True),
        (dict(ok, duration="2"), False),
    ]
    for bad, pydantic_rejects in bad_payloads:
        with pytest.raises(schema.SchemaError):
            schema.VerboseTranscriptionResponse.validate(bad)
        if pydantic_rejects:
            with pytest.raises(ValueError):
                jschema.VerboseTranscriptionResponse.model_validate(bad)
    with pytest.raises(schema.SchemaError):
        schema.StreamDeltaEvent.validate({"type": "transcript.text.done", "delta": "x"})
    assert schema.TranscriptionRequestFields.validate({}).response_format == "json"
    with pytest.raises(schema.SchemaError):
        schema.TranscriptionRequestFields.validate({"response_format": "xml"})
    assert [f.name for f in dataclasses.fields(schema.VerboseTranscriptionResponse)] == list(
        jschema.VerboseTranscriptionResponse.model_fields)


# -- the CLI ---------------------------------------------------------------------------

ARGVS = [
    ["transcribe", "--audio-path", "a.wav", "b.wav", "--language", "en", "--word-timestamps", "--beam-size", "3",
     "--chunking-strategy", "vad", "--report", "--report-format", "srt", "vtt", "--quantization", "w8a8"],
    ["transcribe", "--model-folder", "m", "--no-download", "--prompt", "hi", "--clip-timestamps", "1", "2.5",
     "--temperature-fallback-count", "0", "--device-probe-timeout", "0", "--stream-simulated"],
    ["diarize", "--audio-path", "x.wav", "--num-speakers", "2"],
    ["tts", "--text", "hi", "--seed", "3"],
    ["serve", "--port", "8080", "--draft-model-folder", "d"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: a[0] + str(len(a)))
def test_cli_parser_matches_jax(argv):
    ours = vars(cli.build_parser().parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jcli.build_parser().parse_args(argv))
    assert cli.build_parser().parse_args(argv + ["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv + ["--device", "tpu"])


def test_cli_rejects_unknown_command():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["frobnicate"])


def _write_wav(path, seconds, seed):
    path.write_bytes(_wav_bytes(seconds, seed))
    return path


def test_cli_transcribe_matches_jax(tmp_path, pipes, monkeypatch, capsys):
    """cmd_transcribe of both CLIs on the same pipeline weights: the same
    printed segments and the same json/srt/vtt/txt reports."""
    jax_pipe, torch_pipe = pipes
    wav = _write_wav(tmp_path / "clip.wav", 2.0, 1)
    argv = ["transcribe", "--audio-path", str(wav), "--language", "en", "--sample-length", "12",
            "--temperature-fallback-count", "0", "--report", "--report-format", "json", "srt", "vtt", "txt"]
    monkeypatch.setattr(jcli, "_build_pipeline", lambda args: jax_pipe)
    monkeypatch.setattr(cli, "_build_pipeline", lambda args: torch_pipe)
    assert jcli.main(argv + ["--report-path", str(tmp_path / "jax")]) == 0
    jout = capsys.readouterr().out
    assert cli.main(argv + ["--report-path", str(tmp_path / "torch")]) == 0
    out = capsys.readouterr().out
    assert out == jout and out.strip()
    for ext in ("srt", "vtt", "txt"):
        assert (tmp_path / "torch" / f"clip.{ext}").read_text() == (tmp_path / "jax" / f"clip.{ext}").read_text()
    _assert_same_json(json.loads((tmp_path / "torch" / "clip.json").read_text()),
                      json.loads((tmp_path / "jax" / "clip.json").read_text()))


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """A tiny checkpoint with a byte-level tokenizer, and a draft."""
    root = tmp_path_factory.mktemp("ckpt")
    write_hf_checkpoint(root / "target", DIMS, model.init_params(0, DIMS, torch.float32, "cpu"),
                        alignment_heads=HEADS.tolist())
    write_synthetic_tokenizer(root / "target", DIMS.n_vocab)
    write_hf_checkpoint(root / "draft", DIMS, model.init_params(1, DIMS, torch.float32, "cpu"))
    return root


def test_cli_transcribe_end_to_end_on_a_folder(tmp_path, folders, capsys):
    """`transcribe --device cpu --model-folder ...` loads the folder, runs
    the VAD path on 35 s of audio and writes reports whose segments equal
    an in-process pipeline's with the CLI's own options."""
    from whisperkit_tpu_torch.tools.workload import synth_speechlike_audio

    audio = synth_speechlike_audio(35.0, seed=2)
    wav = tmp_path / "talk.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())
    argv = ["transcribe", "--device", "cpu", "--model-folder", str(folders / "target"), "--no-download",
            "--audio-path", str(wav), "--chunking-strategy", "vad", "--language", "en", "--sample-length", "8",
            "--report", "--report-format", "json", "srt", "--report-path", str(tmp_path)]
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    assert "RTF" in err and "talk.json" in err
    report = json.loads((tmp_path / "talk.json").read_text())
    assert (tmp_path / "talk.srt").read_text().startswith("1\n")
    args = cli.build_parser().parse_args(argv)
    pipe = WhisperPipeline(WhisperConfig(model_folder=str(folders / "target"), download=False), device="cpu")
    ref = pipe.transcribe(wav, cli._decode_options(args, pipe.tokenizer))
    assert [s["tokens"] for s in report["segments"]] == [s.tokens for s in ref.segments] and ref.segments
    assert [s["text"] for s in report["segments"]] == [s.text for s in ref.segments]
    assert report["text"] == ref.text


def test_cli_build_pipeline_with_draft_and_probe_skipped_on_cpu(folders, monkeypatch):
    def boom(_timeout):
        raise AssertionError("the probe must not run for --device cpu")

    monkeypatch.setattr(device_probe, "probe_backend", boom)
    args = cli.build_parser().parse_args([
        "transcribe", "--device", "cpu", "--model-folder", str(folders / "target"),
        "--draft-model-folder", str(folders / "draft"), "--no-download", "--quantization", "w8a8"])
    built = cli._build_pipeline(args)
    assert built.draft_params is not None and built.draft_dims.n_vocab == built.dims.n_vocab
    assert built.device.type == "cpu" and built._act8
    assert built.alignment_heads.tolist() == HEADS.tolist()
    assert type(built.tokenizer).__name__ == "WhisperTokenizer"


@pytest.mark.parametrize(
    "argv, message",
    [
        (["tts", "--text", "hi", "--quantization", "w8a8", "--device", "cpu"],
         "--quantization w8a8 is not available for tts (choices: w8a16, w4a16)"),
        (["transcribe", "--audio-path", "x.wav", "--stream"], "no microphone backend (sounddevice) on this host"),
        (["transcribe", "--audio-path", "x.wav", "--profile-dir", "p", "--stream-simulated"],
         "--profile-dir is not supported with --stream/--stream-simulated"),
    ],
    ids=["tts", "stream", "profile_dir"],
)
def test_cli_out_of_slice_exits_2(argv, message, capsys, monkeypatch):
    """What the port does not run exits 2 before any model loads, with the
    JAX CLI's messages: `--stream` without a capture backend, `tts
    --quantization w8a8`, and `--profile-dir` with a stream (an open-ended
    run has no whole batch to trace)."""
    from whisperkit_tpu_torch.audio import capture
    from whisperkit_tpu_torch.pipelines import tts

    monkeypatch.setattr(capture, "capture_available", lambda: False)
    monkeypatch.setattr(cli, "_build_pipeline", lambda args: (_ for _ in ()).throw(AssertionError("built")))
    monkeypatch.setattr(tts.TTSPipeline, "from_pretrained", lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("built")))
    assert cli.main(argv) == 2
    assert message in capsys.readouterr().err


def test_cli_module_entry_point():
    proc = subprocess.run([sys.executable, "-m", "whisperkit_tpu_torch.cli", "transcribe", "--audio-path", "x.wav",
                           "--profile-dir", "p", "--stream-simulated"], capture_output=True, text=True, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 2 and "--profile-dir is not supported with --stream" in proc.stderr


def test_cli_device_cuda_without_a_card_fails_through_the_probe(folders, capsys):
    """The default --device cuda on a host without a card exits 1 through
    the probe's DeviceUnavailable, never carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: this checks a host without one")
    rc = cli.main(["transcribe", "--model-folder", str(folders / "target"), "--audio-path", "x.wav"])
    assert rc == 1
    assert "device probe failed" in capsys.readouterr().err
    # with the probe off, the pipeline itself refuses the missing card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--model-folder", str(folders / "target"), "--device-probe-timeout", "0"])


def test_device_probe(monkeypatch):
    monkeypatch.setattr(device_probe, "_PROBE_CODE", "print('FakeCard 1')")
    assert device_probe.probe_backend(60) == "FakeCard 1"
    monkeypatch.setattr(device_probe, "_PROBE_CODE", "import time; time.sleep(60)")
    with pytest.raises(DeviceUnavailable, match="did not initialise within 1s"):
        device_probe.probe_backend(timeout_s=1.0)
    monkeypatch.setattr(device_probe, "_PROBE_CODE", "raise SystemExit('no CUDA-capable device is detected')")
    with pytest.raises(DeviceUnavailable, match="no CUDA-capable device"):
        device_probe.probe_backend(60)
