"""OpenAI-compatible local HTTP server (Audio API), the port's counterpart of
whisperkit_tpu/server/openai_api.py on the standard library's
`http.server.ThreadingHTTPServer`.

Reference: Sources/ArgmaxCLI/ServeCLI.swift:26-63 +
Server/OpenAIHandler.swift (`createTranscription` :121, SSE streaming
:22-119), generated from scripts/specs/localserver_openapi.yaml. Endpoints:

  POST /v1/audio/transcriptions   multipart: file, model, language, prompt,
                                  temperature, response_format, stream,
                                  priority (extension: "latency" → b=1 +
                                  speculative when a draft is loaded),
                                  timestamp_granularities[]
  POST /v1/audio/translations     same minus language (task=translate)
  GET  /health

The endpoints, fields, status codes, payloads and SSE event names are the
JAX package's. Each request runs on a thread of its own. With batching on,
every transcription goes through the continuous batcher
(pipelines/scheduler.py), whose collector thread is the only one that
touches the pipeline; with batching off, requests take turns on one lock.
SSE streaming sends one `transcript.text.delta` event per decoded window
and ends with `transcript.text.done`. Multipart bodies are parsed with
`email.parser.BytesParser`.
"""

from __future__ import annotations

import email.parser
import email.policy
import json
import queue
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import urlsplit

from whisperkit_tpu_torch.core.configurations import DecodingOptions, DecodingTask
from whisperkit_tpu_torch.core.logging import logging

MAX_BODY_BYTES = 512 * 1024 * 1024  # the JAX server's client_max_size


def _result_payload(result, response_format: str, task: str = "transcribe"):
    from whisperkit_tpu_torch.text.writers import WriteSRT, WriteVTT

    if response_format == "text":
        return result.text, "text/plain"
    if response_format == "srt":
        return WriteSRT().format(result), "text/plain"
    if response_format == "vtt":
        return WriteVTT().format(result), "text/plain"
    if response_format == "verbose_json":
        payload = {
            "task": task,
            "language": result.language,
            "duration": result.timings.input_audio_seconds,
            "text": result.text,
            "segments": [
                {
                    "id": s.id,
                    "seek": s.seek,
                    "start": s.start,
                    "end": s.end,
                    "text": s.text,
                    "tokens": s.tokens,
                    "temperature": s.temperature,
                    "avg_logprob": s.avg_logprob,
                    "compression_ratio": s.compression_ratio,
                    "no_speech_prob": s.no_speech_prob,
                }
                for s in result.segments
            ],
        }
        words = result.all_words
        if words:
            payload["words"] = [
                {"word": w.word, "start": w.start, "end": w.end} for w in words
            ]
        return json.dumps(payload), "application/json"
    # default: json
    return json.dumps({"text": result.text}), "application/json"


def _error(message: str, **extra) -> dict:
    return {"error": {"message": message, **extra}}


def _drain_body(h: BaseHTTPRequestHandler) -> None:
    """Read and drop a request body the server answers without using (429,
    404), as the JAX server's aiohttp does. The handler closes the
    connection after its answer; a socket closed with unread bytes in it
    sends a reset, and a client still writing its body then fails on the
    write (or loses the answer) instead of reading the status. Bodies
    beyond MAX_BODY_BYTES are not read."""
    try:
        n = int(h.headers.get("Content-Length") or 0)
    except ValueError:
        return
    n = min(n, MAX_BODY_BYTES)
    while n > 0:
        chunk = h.rfile.read(min(n, 1 << 16))
        if not chunk:
            return
        n -= len(chunk)


class _BadRequest(ValueError):
    """The request body is not the multipart form the endpoint takes."""


def _parse_multipart(content_type: str, body: bytes) -> tuple[dict, Optional[Path], list]:
    """(fields, path of the uploaded file written to a temp file or None,
    timestamp granularities) of a multipart/form-data body."""
    if not content_type.lower().startswith("multipart/form-data"):
        raise _BadRequest(f"content type {content_type!r} is not multipart/form-data")
    head = f"Content-Type: {content_type}\r\nMIME-Version: 1.0\r\n\r\n".encode("latin-1")
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(head + body)
    if not msg.is_multipart() or msg.defects:
        raise _BadRequest(f"malformed multipart body: {[type(d).__name__ for d in msg.defects]}")
    fields: dict[str, str] = {}
    audio_path: Optional[Path] = None
    granularities: list[str] = []
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition") or ""
        payload = part.get_payload(decode=True) or b""
        if name == "file":
            suffix = Path(part.get_filename() or "audio.wav").suffix or ".wav"
            with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tmp:
                tmp.write(payload)
            if audio_path is not None:
                audio_path.unlink(missing_ok=True)
            audio_path = Path(tmp.name)
        elif name in ("timestamp_granularities[]", "timestamp_granularities"):
            granularities.append(payload.decode("utf-8").strip())
        else:
            fields[name] = payload.decode("utf-8")
    return fields, audio_path, granularities


class OpenAIApp:
    """The server's routes and state. `create_app` builds it; `start` serves
    it on a thread, `serve` (module level) in the foreground; `close`
    stops the server and the batcher."""

    def __init__(self, pipeline, *, batching: bool, max_batch: int, max_concurrent_requests: int):
        self.pipeline = pipeline
        self.max_concurrent_requests = max_concurrent_requests
        self.scheduler = None
        if batching:
            from whisperkit_tpu_torch.pipelines.scheduler import BatchScheduler

            self.scheduler = BatchScheduler(pipeline, max_batch=max_batch)
        # explicit in-flight counter under a lock: a check followed by an
        # increment without one lets a burst pass the check together and
        # queue past the limit instead of getting 429
        self._in_flight = 0
        self._count_lock = threading.Lock()
        # with batching off, concurrent requests would call the pipeline
        # (not thread-safe) from several handler threads: they take turns
        self._pipeline_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- serving ---------------------------------------------------------------

    def make_server(self, host: str, port: int) -> ThreadingHTTPServer:
        app = self

        class Handler(BaseHTTPRequestHandler):
            server_version = "whisperkit-tpu-torch"

            def do_GET(self):
                app._dispatch(self, "GET")

            def do_POST(self):
                app._dispatch(self, "POST")

            def log_message(self, fmt, *args):
                logging.debug(f"{self.address_string()} {fmt % args}")

        class Server(ThreadingHTTPServer):
            request_queue_size = max(64, self.max_concurrent_requests)

        return Server((host, port), Handler)

    def start(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        """Serve on a daemon thread; returns the bound (host, port)."""
        self._httpd = self.make_server(host, port)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self._httpd.server_address[:2]

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = self._thread = None
        if self.scheduler is not None:
            self.scheduler.shutdown()

    # -- routes ------------------------------------------------------------------

    def _dispatch(self, h: BaseHTTPRequestHandler, method: str) -> None:
        path = urlsplit(h.path).path
        routes = {
            ("GET", "/health"): self._health,
            ("POST", "/v1/audio/transcriptions"): lambda h: self._handle(h, DecodingTask.TRANSCRIBE),
            ("POST", "/v1/audio/translations"): lambda h: self._handle(h, DecodingTask.TRANSLATE),
        }
        route = routes.get((method, path))
        if path == "/health" and route is not None:
            route(h)
            return
        with self._count_lock:
            if self._in_flight >= self.max_concurrent_requests:
                busy = True
            else:
                busy = False
                self._in_flight += 1
        if busy:
            _drain_body(h)
            self._send_json(h, 429, _error("too many concurrent requests", type="rate_limit_exceeded"))
            return
        released = False

        def release_slot() -> None:
            nonlocal released
            with self._count_lock:
                if not released:
                    released = True
                    self._in_flight -= 1

        # `_send` frees the slot before the answer goes out, as the JAX
        # server's middleware does (its count drops when the handler
        # returns, before aiohttp writes the response): a client that has
        # its answer and sends the next request must find the slot free
        h.release_slot = release_slot
        try:
            if route is None:
                _drain_body(h)
                self._send_json(h, 404, _error(f"no route {method} {path}"))
            else:
                route(h)
        finally:
            release_slot()

    def _health(self, h) -> None:
        payload = {"status": "ok", "model_state": str(self.pipeline.model_state)}
        if self.scheduler is not None:
            payload["batches_run"] = self.scheduler.batches_run
            payload["jobs_run"] = self.scheduler.jobs_run
        self._send_json(h, 200, payload)

    def _options(self, fields: dict, granularities: list, task: DecodingTask) -> DecodingOptions:
        word_ts = "word" in granularities
        prompt = fields.get("prompt")
        prompt_tokens = (
            self.pipeline.tokenizer.encode(" " + prompt.strip()) if prompt else None
        )
        return DecodingOptions(
            task=task,
            language=fields.get("language"),
            temperature=float(fields.get("temperature", 0.0)),
            word_timestamps=word_ts,
            prompt_tokens=prompt_tokens,
            chunking_strategy="vad",
            # extension field (no OpenAI equivalent): "latency" requests
            # decode alone at batch 1 without waiting to batch — and run
            # the lossless speculative draft-verify loop when the server's
            # pipeline carries a draft model
            priority=fields.get("priority", "throughput"),
        )

    def _locked_transcribe(self, audio, options, callback=None):
        with self._pipeline_lock:
            return self.pipeline.transcribe(audio, options, callback)

    def _read_body(self, h) -> bytes:
        length = h.headers.get("Content-Length")
        if length is None:
            raise _BadRequest("missing Content-Length")
        n = int(length)
        if n > MAX_BODY_BYTES:
            raise _BadRequest(f"body of {n} bytes exceeds {MAX_BODY_BYTES}")
        return h.rfile.read(n)

    def _handle(self, h, task: DecodingTask) -> None:
        try:
            fields, audio_path, granularities = _parse_multipart(
                h.headers.get("Content-Type", ""), self._read_body(h)
            )
        except ValueError as e:
            self._send_json(h, 400, _error(f"expected multipart/form-data: {e}"))
            return
        if audio_path is None:
            self._send_json(h, 400, _error("missing file field"))
            return
        response_format = fields.get("response_format", "json")
        stream = fields.get("stream", "false").lower() in ("1", "true", "yes")
        try:
            try:
                options = self._options(fields, granularities, task)
            except (ValueError, TypeError) as e:
                self._send_json(h, 400, _error(f"invalid request field: {e}"))
                return
            if stream:
                # streaming owns the temp file (its worker may outlive this
                # handler's own use of it)
                path, audio_path = audio_path, None
                self._handle_streaming(h, path, options)
                return
            if self.scheduler is not None:
                from whisperkit_tpu_torch.audio.io import load_audio

                result = self.scheduler.submit(load_audio(audio_path), options).result()
            else:
                result = self._locked_transcribe(audio_path, options)
            body, ctype = _result_payload(result, response_format, task.value)
            self._send(h, 200, body, ctype)
        except Exception as e:  # surface as an OpenAI-style error object
            logging.error(f"transcription failed: {e}")
            self._send_json(h, 500, _error(str(e)))
        finally:
            if audio_path is not None:
                audio_path.unlink(missing_ok=True)

    def _handle_streaming(self, h, audio_path: Path, options: DecodingOptions) -> None:
        """SSE: one transcript.text.delta per decoded window, then done.

        Owns (and deletes) `audio_path`. A client that goes away sets a
        cancel flag, which the per-window progress callback turns into an
        early stop (returning False), so the decode winds down instead of
        transcribing an abandoned request to its end. With batching on, the
        request rides the same batcher as non-streaming traffic."""
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Connection", "close")
        h.end_headers()
        events: queue.Queue = queue.Queue()
        cancelled = threading.Event()

        if self.scheduler is not None:
            from whisperkit_tpu_torch.audio.io import load_audio

            # the response has started: a load failure goes out as the
            # SSE error event
            audio = None
            try:
                audio = load_audio(audio_path)
            except Exception as e:  # noqa: BLE001 — forwarded as SSE error
                events.put(("error", e))
            finally:
                audio_path.unlink(missing_ok=True)

            def window_callback(text: str):
                if cancelled.is_set():
                    return False  # drop the job's undecoded windows
                events.put(("delta", text))
                return None

            def on_done(fut):
                exc = fut.exception()
                events.put(("error", exc) if exc is not None else ("done", fut.result()))

            if audio is not None:
                self.scheduler.submit(audio, options, progress_callback=window_callback).add_done_callback(on_done)
        else:

            def progress_callback(progress):
                if cancelled.is_set():
                    return False  # early-stop the seek loop
                events.put(("delta", progress.text))
                return None

            def run():
                try:
                    events.put(("done", self._locked_transcribe(audio_path, options, progress_callback)))
                except Exception as e:  # noqa: BLE001 — forwarded as SSE error
                    events.put(("error", e))
                finally:
                    audio_path.unlink(missing_ok=True)

            threading.Thread(target=run, daemon=True).start()

        def send(event: dict) -> None:
            h.wfile.write(f"data: {json.dumps(event)}\n\n".encode())

        try:
            while True:
                kind, value = events.get()
                if kind == "delta":
                    send({"type": "transcript.text.delta", "delta": value})
                elif kind == "error":
                    send({"type": "error", "error": {"message": str(value)}})
                    break
                else:
                    send({"type": "transcript.text.done", "text": value.text})
                    h.wfile.write(b"data: [DONE]\n\n")
                    break
        except (BrokenPipeError, ConnectionResetError):
            cancelled.set()

    # -- responses --------------------------------------------------------------

    @staticmethod
    def _send(h, status: int, body: str, content_type: str) -> None:
        data = body.encode("utf-8")
        release_slot = getattr(h, "release_slot", None)  # /health and a 429 hold none
        if release_slot is not None:
            release_slot()
        h.send_response(status)
        h.send_header("Content-Type", f"{content_type}; charset=utf-8")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    def _send_json(self, h, status: int, payload: dict) -> None:
        self._send(h, status, json.dumps(payload), "application/json")


def create_app(
    pipeline,
    *,
    batching: bool = True,
    max_batch: int = 16,
    max_concurrent_requests: int = 64,
) -> OpenAIApp:
    """`batching=True` routes every request through the continuous batcher
    so concurrent clients share one batched decode on the card
    (pipelines/scheduler.py). Requests beyond `max_concurrent_requests` in
    flight are rejected with 429 instead of queueing unboundedly."""
    return OpenAIApp(
        pipeline, batching=batching, max_batch=max_batch, max_concurrent_requests=max_concurrent_requests
    )


def serve(pipeline, host: str = "127.0.0.1", port: int = 50060) -> None:
    """Serve in the foreground until interrupted."""
    app = create_app(pipeline)
    httpd = app.make_server(host, port)
    logging.info(f"serving OpenAI-compatible audio API on http://{host}:{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        app.close()
