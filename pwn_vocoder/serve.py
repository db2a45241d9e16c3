"""Streaming vocoder HTTP server — the production serving path.

The reference had no serving story at all: `generate.py` [R] was a
one-shot script (SURVEY.md §3.2).  This module turns the streaming
synthesis path into a deployable endpoint:

- checkpoint -> params via the `eval_shape` restore template (no
  throwaway parameter init);
- the per-(config, chunk) cached streaming window jit;
- EMA (Polyak) serving params when the checkpoint carries them;
- the persistent compilation cache, so process restarts reuse
  compiled executables.

Protocol (stdlib-only, chunked transfer):

- ``GET /healthz``  -> ``{"status": "ok", ...}``
- ``POST /synthesize[?temperature=T&chunk_frames=N]`` with either a
  RIFF wav body (copy-synthesis conditioning, like the reference's
  generate) or an ``.npy`` body holding a ``(frames, n_mels)`` float
  mel (the production vocoder input — a TTS acoustic model's output;
  convention at ``generate.coerce_mel``) -> streamed raw little-endian
  PCM16 mono; sample rate in the ``X-Sample-Rate`` response header.
  Chunks are produced as the device emits them — playback can start
  ~one chunk after the request.

One device, one compute stream: device calls serialize on a lock; the
HTTP layer is threaded so health checks never queue behind synthesis.
With ``batch_max > 1`` (the CLI default) concurrent streaming requests
are DYNAMICALLY BATCHED — `_BatchEngine` merges up to ``batch_max``
requests' next windows into one device call with per-row noise keys,
offsets and temperatures, so N concurrent clients cost ~one client's
wall instead of N×.

Resource bounds (VERDICT r3 weak item 5):

- request bodies are capped (``413`` past ``max_body_bytes``, default
  64 MB) — previously one multi-GB POST could OOM the host;
- concurrent synthesis admissions are bounded (``503`` +
  ``Retry-After`` past ``max_pending``) so a burst cannot pile up
  unbounded producer threads behind the device lock;
- the per-request chunk buffer is a BOUNDED queue (``queue_chunks``
  chunks ≈ tens of seconds of audio): a slow client buffers bounded
  host RAM; in the pathological case (buffer full AND client stalled)
  the producer blocks holding the device lock, but total damage is
  bounded by ``max_pending`` admissions, each of bounded RAM.
"""

from __future__ import annotations

import io
import itertools
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, NamedTuple, Optional
from urllib.parse import parse_qs, urlparse

import jax
import numpy as np
from scipy.io import wavfile
from scipy.signal import lfilter, resample_poly

from pwn_vocoder.config import Config


def _pcm16(x: np.ndarray) -> bytes:
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


class _ShortUtterance(Exception):
    """Pre-stream signal: the utterance is shorter than one streaming
    window, take the whole-call path.  A dedicated type so that a
    ValueError relayed from the batch engine mid-stream is NOT mistaken
    for this fallback decision (which would silently append a full
    whole-utterance synthesis after already-streamed chunks)."""


class _Deemph:
    """Streaming 1-pole deemphasis: x[t] = y[t] + coef * x[t-1], state
    carried across chunks so streamed output equals the whole-call
    `dsp.deemphasis` sample-for-sample."""

    def __init__(self, coef: float):
        self.coef = coef
        self._zi = np.zeros(1, np.float64)

    def __call__(self, y: np.ndarray) -> np.ndarray:
        if self.coef == 0.0:
            return y
        x, self._zi = lfilter(
            [1.0], [1.0, -self.coef], y.astype(np.float64), zi=self._zi
        )
        return x.astype(np.float32)


class _Job(NamedTuple):
    """One streaming window of one request, queued to `_BatchEngine`."""

    mel_win: np.ndarray    # (1, WF, n_mels) host window
    key: np.ndarray        # (2,) uint32 request noise key
    ws: int                # base-noise window start (samples)
    off: int               # cond offset within the window
    out_off: int           # output offset within the window
    temperature: float
    future: Future         # resolves to the (CT,) waveform row


class _BatchEngine:
    """Cross-request dynamic batching: one device call per streaming
    window services up to `max_batch` concurrent requests.

    Without it, concurrent requests serialize on the device lock: each
    window runs at batch 1 while the other requests wait.  A streaming
    window's weight reads amortize across the rows of a batch, so
    batching raises aggregate serving throughput with the concurrency.

    Design (all windows run through `generate._batched_stream_window_fn`,
    whose per-row offsets/keys let requests at DIFFERENT chunk positions
    share one call):

    - jobs gather for `gather_ms` after the first arrival — but only
      when another synthesis is actually pending, so a lone client pays
      no batching latency;
    - a gathered group is padded to the next power-of-two bucket by
      repeating row 0 (one compile per bucket, persistent-cached);
    - the device lock is held only for the batched call, keeping the
      whole-call fallback path safe to interleave.
    """

    def __init__(self, service: "VocoderService", max_batch: int = 4,
                 gather_ms: float = 3.0):
        self.service = service
        self.buckets = [b for b in (1, 2, 4, 8, 16) if b <= max_batch]
        self.max_batch = self.buckets[-1]
        self.gather_ms = gather_ms
        self.calls = 0  # batched device calls executed
        self.rows = 0   # real (non-padding) rows across those calls
        self.retries = 0  # device-call retries after a transient error
        # engine-ROUTED streams currently active: the gather heuristic
        # keys off this, not service.pending, so direct-path/multi-row/
        # whole-call admissions (which never produce engine jobs) cannot
        # make a lone batched stream pay gather_ms per window
        self._streams = 0
        self._streams_lock = threading.Lock()
        self.jobs: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stream_started(self) -> None:
        with self._streams_lock:
            self._streams += 1

    def stream_done(self) -> None:
        with self._streams_lock:
            self._streams -= 1

    @property
    def active_streams(self) -> int:
        with self._streams_lock:
            return self._streams

    def submit(self, job: _Job) -> Future:
        self.jobs.put(job)
        return job.future

    def stop(self) -> None:
        self.jobs.put(None)
        self._thread.join(timeout=10)

    def _run(self) -> None:
        while True:
            job = self.jobs.get()
            if job is None:
                return
            batch = [job]
            # gather only when another ENGINE-ROUTED stream is active: a
            # lone stream should not pay gather_ms per window, and
            # direct-path/whole-call admissions can never co-batch
            if self.active_streams > 1:
                deadline = time.monotonic() + self.gather_ms * 1e-3
                while len(batch) < self.max_batch:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        break
                    try:
                        nxt = self.jobs.get(timeout=rem)
                    except queue.Empty:
                        break
                    if nxt is None:
                        self.jobs.put(None)  # re-arm shutdown
                        break
                    batch.append(nxt)
            else:
                # drain whatever is already waiting, without sleeping
                while len(batch) < self.max_batch:
                    try:
                        nxt = self.jobs.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        self.jobs.put(None)
                        break
                    batch.append(nxt)
            self._execute(batch)

    def _execute(self, batch) -> None:
        from pwn_vocoder.generate import _batched_stream_window_fn

        k = len(batch)
        B = next(b for b in self.buckets if b >= k)
        rows = batch + [batch[0]] * (B - k)

        def run_once():
            fn = _batched_stream_window_fn(
                self.service.cfg, self.service.chunk_frames, B)
            args = (
                np.concatenate([r.mel_win for r in rows]),
                np.stack([r.key for r in rows]),
                np.asarray([r.ws for r in rows], np.int32),
                np.asarray([r.off for r in rows], np.int32),
                np.asarray([r.out_off for r in rows], np.int32),
                np.asarray([r.temperature for r in rows], np.float32),
            )
            with self.service.lock:
                return np.asarray(fn(self.service.params, *args))

        try:
            out = run_once()
        except Exception:  # noqa: BLE001 — one retry before failing
            # a transient device error here would otherwise fail up to
            # batch_max unrelated client streams at once
            self.retries += 1
            try:
                out = run_once()
            except Exception as e:  # noqa: BLE001 — relay to waiters
                for r in batch:
                    r.future.set_exception(e)
                return
        self.calls += 1
        self.rows += k
        for i, r in enumerate(batch):
            r.future.set_result(out[i])


class VocoderService:
    """Config + params + the device lock; shared by all HTTP threads."""

    def __init__(self, cfg: Config, params: Any,
                 chunk_frames: int = 64, max_pending: int = 4,
                 queue_chunks: int = 64,
                 max_body_bytes: int = 64 * 2 ** 20,
                 batch_max: int = 1,
                 batch_window_ms: float = 3.0):
        self.cfg = cfg
        self.params = params
        self.chunk_frames = chunk_frames
        self.max_pending = max_pending
        self.queue_chunks = queue_chunks
        self.max_body_bytes = max_body_bytes
        self.lock = threading.Lock()  # one device, one compute stream
        self._counter = itertools.count()  # atomic under the GIL
        self._pending = 0
        self._pending_lock = threading.Lock()
        self.requests_served = 0
        # graceful shutdown: draining stops admissions (503) while
        # in-flight streams finish (serve_forever's SIGTERM path)
        self.draining = False
        # latency observability (VERDICT r4 item 6): client-visible
        # time-to-first-byte per request, bounded ring for /healthz
        # p50/p99 — the numbers that made the r4 batching case
        from collections import deque

        self._ttfb_ms: "deque[float]" = deque(maxlen=512)
        self._stats_lock = threading.Lock()
        # cross-request dynamic batching (batch_max > 1): concurrent
        # streams share one device call per window instead of
        # serializing on the lock
        self.engine = (
            _BatchEngine(self, batch_max, batch_window_ms)
            if batch_max > 1 else None
        )

    def close(self) -> None:
        if self.engine is not None:
            self.engine.stop()

    def try_admit(self) -> bool:
        """Reserve a synthesis slot; False when the server is saturated
        (the HTTP layer then answers 503 + Retry-After instead of
        queueing unboundedly behind the device lock) or draining for
        shutdown."""
        if self.draining:
            return False
        with self._pending_lock:
            if self._pending >= self.max_pending:
                return False
            self._pending += 1
            return True

    def observe_ttfb(self, ms: float) -> None:
        with self._stats_lock:
            self._ttfb_ms.append(ms)

    def ttfb_stats(self) -> dict:
        with self._stats_lock:
            xs = sorted(self._ttfb_ms)
        if not xs:
            return {"count": 0}
        pick = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
        return {
            "count": len(xs),
            "p50_ms": round(pick(0.50), 1),
            "p90_ms": round(pick(0.90), 1),
            "p99_ms": round(pick(0.99), 1),
            "max_ms": round(xs[-1], 1),
        }

    def release(self) -> None:
        with self._pending_lock:
            self._pending -= 1

    @property
    def pending(self) -> int:
        with self._pending_lock:
            return self._pending

    @classmethod
    def from_workdir(cls, cfg: Config, workdir: str,
                     chunk_frames: int = 64,
                     **kwargs) -> "VocoderService":
        """Restore a checkpointed student and build the service.  Extra
        kwargs (max_pending, batch_max, batch_window_ms, ...) pass
        through to the constructor so CLI wiring lives in ONE place."""
        import os

        from pwn_vocoder.training.common import serving_params
        from pwn_vocoder.training.loop import abstract_state_template
        from pwn_vocoder.utils.checkpoint import CheckpointManager

        state = abstract_state_template(cfg, "student")
        state, _ = CheckpointManager(
            os.path.join(os.path.abspath(workdir), "ckpt_student")
        ).restore(state)
        # device-commit once: the restore yields host numpy, and a host
        # tree as a jit arg re-uploads per chunk call
        return cls(cfg, jax.device_put(serving_params(state)),
                   chunk_frames, **kwargs)

    def synthesize_chunks(self, wav: np.ndarray, temperature: float,
                          chunk_frames: Optional[int] = None,
                          batching: bool = True):
        """Yield deemphasized float32 waveform chunks for a conditioning
        WAVEFORM (copy-synthesis).  The wav->mel runs in host numpy
        (`generate.mel_from_wav_host`, allclose-pinned to the device
        pipeline): on-device eager mel compiles PER REQUEST LENGTH — a
        server receiving arbitrary-length wavs must not pay that at
        request time."""
        from pwn_vocoder.generate import mel_from_wav_host

        return self.synthesize_chunks_from_mel(
            mel_from_wav_host(self.cfg, wav.astype(np.float32))[None],
            temperature, chunk_frames, batching,
        )

    def synthesize_chunks_from_mel(self, mel, temperature: float,
                                   chunk_frames: Optional[int] = None,
                                   batching: bool = True):
        """Yield deemphasized float32 waveform chunks for a conditioning
        mel (1, F, n_mels) — the production vocoder input (a TTS
        acoustic model's output; convention documented at
        `generate.coerce_mel`).  Utterances shorter than one streaming
        window fall back to a single whole-call chunk.

        Device work runs in a producer thread draining into a BOUNDED
        queue (`queue_chunks`), so the device lock is held only while
        the chip computes and a slow client buffers bounded host RAM.
        In the pathological case (queue full AND the client stalled,
        not gone) the producer blocks holding the device lock until the
        client reads or disconnects — total damage is bounded by
        `max_pending` admissions (see the module docstring's resource-
        bounds contract).
        """
        from pwn_vocoder.generate import (
            generate_student,
            stream_student_chunks,
        )

        cf = chunk_frames or self.chunk_frames
        # keep the mel host-resident: eager slices of a device array
        # (mel[:, :Fp] below) compile per distinct request length;
        # numpy slicing is free and the streaming path ships fixed-size
        # windows to the device anyway
        mel = np.asarray(mel)
        # per-request noise stream; itertools.count is atomic, so two
        # threads entering together still get distinct keys
        req_id = next(self._counter)
        key = jax.random.PRNGKey(req_id)
        self.requests_served = req_id + 1
        F = mel.shape[1]
        Fp = F - F % cf
        deemph = _Deemph(self.cfg.dsp.preemphasis)
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_chunks)

        # abandonment protocol for the BOUNDED queue: if the consumer
        # generator is closed (client gone) while the queue is full, the
        # producer must NOT block on q.put holding the device lock — it
        # polls this flag and stops producing instead
        abandoned = threading.Event()

        def put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        # engine route: the batch engine keys its compiled kernel to
        # the service chunk size and single-utterance rows; other
        # requests use the direct (lock-serialized) streaming path
        use_engine = (
            batching
            and self.engine is not None
            and cf == self.chunk_frames
            and mel.shape[0] == 1
        )

        def produce_batched() -> None:
            """Stream via the batch engine: windows from the SAME plan
            as the direct path, executed in cross-request batches (the
            engine holds the device lock per call, not per request).
            The whole-call fallback decision (_ShortUtterance) is made
            BEFORE any chunk streams; later errors — including
            ValueErrors relayed from the engine — propagate as errors."""
            from pwn_vocoder.generate import _stream_geometry, _stream_plan

            _, _, _, _, WF = _stream_geometry(self.cfg, cf)
            key_np = np.asarray(key, np.uint32)
            self.engine.stream_started()
            try:
                for ws, f_start, off, out_off, trim in _stream_plan(
                        self.cfg, F, cf, True):
                    fut = self.engine.submit(_Job(
                        mel[:, f_start: f_start + WF], key_np,
                        ws, off, out_off, temperature, Future(),
                    ))
                    chunk = fut.result(timeout=600)
                    if trim:
                        chunk = chunk[trim:]
                    if not put(("chunk", chunk)):
                        return
            finally:
                self.engine.stream_done()

        def produce_direct() -> None:
            with self.lock:
                # cover_tail: the final F % cf frames stream as
                # one partial chunk instead of being dropped
                # (up to cf*hop-1 samples — the end of the last
                # word on real speech)
                for chunk in stream_student_chunks(
                    self.cfg, self.params, mel, key=key,
                    chunk_frames=cf, temperature=temperature,
                    cover_tail=True,
                ):
                    if not put(("chunk", chunk[0])):
                        return

        def produce() -> None:
            try:
                try:
                    # whole-call fallback decided BEFORE any chunk
                    # streams, from the same geometry both streaming
                    # paths enforce — so a ValueError relayed later
                    # (e.g. from the batch engine) is a real error,
                    # never silently re-routed to a second synthesis
                    from pwn_vocoder.generate import _stream_geometry

                    WF = _stream_geometry(self.cfg, cf)[4]
                    if Fp < cf or F < WF:
                        raise _ShortUtterance
                    if use_engine:
                        produce_batched()
                    else:
                        produce_direct()
                except _ShortUtterance:
                    # shorter than one overlap window: one-shot
                    # generate_student, which deemphasizes
                    # internally — emitted as "whole" so the
                    # consumer skips its deemphasis filter
                    with self.lock:
                        if not put(("whole", np.asarray(generate_student(
                            self.cfg, self.params, mel, key,
                            temperature=temperature,
                        )))):
                            return
            except Exception as e:  # noqa: BLE001 — relay to client
                put(("error", e))
            put(("done", None))

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise payload
                yield deemph(payload) if kind == "chunk" else payload
        finally:
            abandoned.set()


def _make_handler(service: VocoderService):
    sr = service.cfg.dsp.sample_rate

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # required for chunked transfer

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "device": str(jax.devices()[0]),
                    "sample_rate": sr,
                    "chunk_frames": service.chunk_frames,
                    "requests_served": service.requests_served,
                    "pending": service.pending,
                    "max_pending": service.max_pending,
                    "batch_max": (service.engine.max_batch
                                  if service.engine else 1),
                    "batch_calls": (service.engine.calls
                                    if service.engine else 0),
                    "batch_rows": (service.engine.rows
                                   if service.engine else 0),
                    # realized co-batching occupancy (rows per device
                    # call) + retry count — the production view of the
                    # r4 batching A/B
                    "batch_rows_per_call": (
                        round(service.engine.rows
                              / max(service.engine.calls, 1), 2)
                        if service.engine else None),
                    "batch_retries": (service.engine.retries
                                      if service.engine else 0),
                    "ttfb": service.ttfb_stats(),
                    "draining": service.draining,
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/synthesize":
                self._json(404, {"error": "unknown path"})
                return
            q = parse_qs(url.query)
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self.close_connection = True
                self._json(400, {"error": "bad Content-Length"})
                return
            if n > service.max_body_bytes:
                # drain nothing — answer and close (keep-alive off so the
                # unread body doesn't poison the connection)
                self.close_connection = True
                self._json(413, {
                    "error": f"body {n} bytes exceeds limit "
                             f"{service.max_body_bytes}"
                })
                return
            # shed load BEFORE paying for body decode/resample/mel
            # parse: a saturated server answering 503 late still burns
            # seconds of CPU per shed request on big bodies
            t_admit = time.monotonic()
            if not service.try_admit():
                self.close_connection = True  # body unread
                self.send_response(503)
                self.send_header("Retry-After", "1")
                body = json.dumps({"error": "server busy: "
                                   f"{service.max_pending} syntheses "
                                   "already pending"}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            try:
                mel = None
                try:
                    temperature = float(q.get("temperature", ["1.0"])[0])
                    cf = int(q.get("chunk_frames",
                                   [str(service.chunk_frames)])[0])
                    # per-request batching opt-out (A/B + debugging):
                    # ?batching=off streams via the direct
                    # lock-serialized path
                    batching = q.get("batching", ["on"])[0] != "off"
                    body = self.rfile.read(n)
                    if body[:6] == b"\x93NUMPY":
                        # .npy body = direct mel conditioning (the
                        # production vocoder input; convention
                        # documented at generate.coerce_mel / README)
                        from pwn_vocoder.generate import coerce_mel

                        mel = coerce_mel(service.cfg, np.load(
                            io.BytesIO(body), allow_pickle=False))
                    else:
                        in_sr, data = wavfile.read(io.BytesIO(body))
                        if data.dtype == np.int16:
                            wav = data.astype(np.float32) / 32768.0
                        else:
                            wav = data.astype(np.float32)
                        if wav.ndim == 2:
                            wav = wav.mean(axis=1)
                        if in_sr != sr:
                            g = int(np.gcd(sr, in_sr))
                            wav = resample_poly(wav, sr // g, in_sr // g)
                except Exception as e:
                    self._json(400, {"error": f"bad request: {e!r}"})
                    return
                try:
                    chunks = (
                        service.synthesize_chunks_from_mel(
                            mel, temperature, cf, batching)
                        if mel is not None
                        else service.synthesize_chunks(
                            wav, temperature, cf, batching)
                    )
                    first = next(chunks)  # surface errors before headers
                except Exception as e:
                    self._json(500, {"error": repr(e)})
                    return
                service.observe_ttfb((time.monotonic() - t_admit) * 1e3)
                self.send_response(200)
                self.send_header("Content-Type", "audio/L16")
                self.send_header("X-Sample-Rate", str(sr))
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def send(payload: bytes) -> None:
                    self.wfile.write(f"{len(payload):X}\r\n".encode())
                    self.wfile.write(payload)
                    self.wfile.write(b"\r\n")

                send(_pcm16(first))
                for chunk in chunks:
                    send(_pcm16(chunk))
                self.wfile.write(b"0\r\n\r\n")
            finally:
                service.release()

    return Handler


def make_server(service: VocoderService, host: str = "127.0.0.1",
                port: int = 8600) -> ThreadingHTTPServer:
    """Build (not start) the server; tests drive it from a thread."""
    return ThreadingHTTPServer((host, port), _make_handler(service))


def drain_and_close(service: VocoderService, srv: ThreadingHTTPServer,
                    timeout_s: float = 30.0) -> None:
    """Graceful shutdown (VERDICT r4 item 6): stop admissions (503),
    wait for in-flight streams to finish, then stop the engine thread
    and close the listener — instead of daemon-killing mid-stream."""
    service.draining = True
    deadline = time.monotonic() + timeout_s
    while service.pending > 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    service.close()
    srv.server_close()


def serve_forever(cfg: Config, workdir: str, host: str, port: int,
                  chunk_frames: int = 64, max_pending: int = 4,
                  max_body_bytes: int = 64 * 2 ** 20,
                  batch_max: int = 4,
                  batch_window_ms: float = 3.0) -> None:
    service = VocoderService.from_workdir(
        cfg, workdir, chunk_frames, max_pending=max_pending,
        max_body_bytes=max_body_bytes, batch_max=batch_max,
        batch_window_ms=batch_window_ms,
    )
    # warm the window jit so the first request pays no compile
    warm = np.zeros(
        max((chunk_frames + 8) * cfg.dsp.hop_length * 2,
            cfg.dsp.win_length * 4),
        np.float32,
    )
    for _ in service.synthesize_chunks(warm, temperature=1.0):
        pass
    if service.engine is not None:
        # pre-compile every batch bucket so the first concurrent burst
        # pays no compile (persistent cache makes repeats ~free)
        from pwn_vocoder.generate import (
            _batched_stream_window_fn,
            _stream_geometry,
        )

        _, _, _, _, WF = _stream_geometry(cfg, chunk_frames)
        for B in service.engine.buckets:
            fn = _batched_stream_window_fn(cfg, chunk_frames, B)
            np.asarray(fn(
                service.params,
                np.zeros((B, WF, cfg.dsp.n_mels), np.float32),
                np.zeros((B, 2), np.uint32),
                np.zeros(B, np.int32), np.zeros(B, np.int32),
                np.zeros(B, np.int32), np.ones(B, np.float32),
            ))
    srv = make_server(service, host, port)

    # SIGTERM/SIGINT -> stop accepting, drain in-flight streams, stop
    # the engine thread, close the socket (clean production shutdown)
    import signal

    def _shutdown(signum, frame):
        print(f"signal {signum}: draining "
              f"{service.pending} in-flight streams...", flush=True)
        threading.Thread(target=srv.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _shutdown)

    print(f"serving {cfg.dsp.sample_rate} Hz vocoder on "
          f"http://{host}:{port}  (POST /synthesize, GET /healthz)")
    try:
        srv.serve_forever()
    finally:
        drain_and_close(service, srv)
        print("server stopped", flush=True)
