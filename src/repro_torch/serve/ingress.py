"""Async streaming ingress tier, as ``repro.serve.ingress``: a
stdlib-asyncio HTTP/SSE front end over
:class:`repro_torch.serve.Engine`.

Threading model (three threads, one engine):

* the **engine thread** owns the engine outright. It loops over a
  thread-safe command queue (submits, cancels, shutdown) and calls
  ``engine.step()`` whenever there is work; nothing else touches
  engine, scheduler or cache state, so the single-threaded invariants
  of the serving stack survive concurrent clients. PyTorch's grad mode
  and current CUDA stream are per thread: ``Engine.step`` enters
  ``no_grad`` and the engine's own stream itself, so this thread
  replays the decode graph and launches prefill on the stream that
  ``warmup()`` set up on the thread that built the engine;
* the **asyncio thread** runs the event loop: a hand-rolled HTTP/1.1
  server (stdlib ``asyncio.start_server``) that parses requests,
  enforces admission, and streams tokens out as SSE;
* tokens cross from the engine thread to a per-request
  ``asyncio.Queue`` via ``loop.call_soon_threadsafe`` from the
  request's ``on_token``/``on_done`` callbacks: per-decode-step
  streaming with no polling.

Endpoints:

* ``POST /generate``: JSON body (``prompt`` token ids,
  ``max_new_tokens``, optional ``eos_id`` / ``stop`` / ``temperature``
  / ``top_k`` / ``top_p`` / ``seed``); the response is an SSE stream:
  one ``data:`` event per generated token carrying ``token_id``, the
  token ``offset`` in the output stream, and ``finish_reason`` (null
  until the final event, which carries the reason and no token). The
  ``X-Admission`` response header reports ``accepted`` or ``degraded``.
* ``GET /healthz``: liveness probe (``ok``). Live Prometheus metrics
  stay with ``repro_torch.obs.MetricsServer`` (``--metrics-port``);
  the ingress records into that same registry.

Overload (``IngressOptions.admission_queue`` bounds requests accepted
but not yet finished):

* ``shed_policy="reject"``: 429 with a ``Retry-After`` hint; nothing
  joins the queue;
* ``shed_policy="degrade"``: admit, but clamp ``max_new_tokens`` to
  ``degrade_max_new``: every client gets *some* tokens (a prefix of
  what the unclamped run would have produced, under greedy decoding)
  and the queue drains faster instead of growing.

A client disconnect mid-stream (EOF on the socket, or a failed write)
propagates to ``Engine.cancel`` through the engine-thread command
queue: the request's slot, pages or host pages are released within one
engine step, from whatever stage it was in (``Scheduler.cancel``).

Telemetry, the JAX tier's: the ``repro_ingress_requests_total{outcome}``,
``repro_ingress_disconnects_total``, ``repro_ingress_stream_seconds``,
``repro_ingress_inflight_requests`` and ``repro_ingress_open_streams``
families, and ``STREAM`` B/E spans and ``DISCONNECT`` instants on the
ingress pid (``SHED`` on its tid 0).

:class:`IngressClient` is the matching blocking SSE client (stdlib
socket + hand-rolled HTTP) used by the tests and ``chip_smoke.py``;
owning the socket directly is what lets a test inject a mid-stream
disconnect by closing it. Nothing here binds a socket or starts a thread
before ``IngressServer.start()``.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import json
import queue
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import PID_INGRESS
from repro_torch.serve.request import Request
from repro_torch.serve.sampling import SamplingParams

__all__ = ["IngressClient", "IngressOptions", "IngressServer",
           "SHED_POLICIES", "StreamResult"]

SHED_POLICIES = ("reject", "degrade")

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large", 429: "Too Many Requests",
            500: "Internal Server Error"}


@dataclasses.dataclass
class IngressOptions:
    host: str = "127.0.0.1"
    port: int = 0                  # 0 = ephemeral (tests/benchmarks)
    admission_queue: int = 8       # accepted-but-unfinished bound
    shed_policy: str = "reject"    # "reject" | "degrade"
    degrade_max_new: int = 8       # clamped budget under overload
    retry_after_s: float = 1.0     # 429 Retry-After hint (seconds)
    max_body_bytes: int = 1 << 20


def _sse(token_id: Optional[int], offset: int,
         finish_reason: Optional[str]) -> bytes:
    return b"data: " + json.dumps(
        {"token_id": token_id, "offset": offset,
         "finish_reason": finish_reason},
        separators=(",", ":")).encode() + b"\n\n"


class _ClientGone(Exception):
    """The SSE consumer hung up mid-stream."""


class IngressServer:
    """HTTP/SSE ingress over one :class:`Engine` (module docstring).

    ``start()`` launches the asyncio and engine threads and binds the
    port (``.host`` / ``.port`` / ``.url`` afterwards); ``stop()``
    drains the engine, lets open streams flush, and tears both threads
    down. The engine must already be constructed and, on the card,
    ``warmup()``-ed by the caller (the decode graph is captured before
    any other thread can touch the card); the ingress records its
    metrics and spans into the engine's own ``repro_torch.obs``
    recorder. An exception raised by ``engine.step()`` ends the engine
    thread and is raised again by ``stop()``.
    """

    def __init__(self, engine, *, options: Optional[IngressOptions] = None):
        self.engine = engine
        self.opts = opts = options or IngressOptions()
        assert opts.shed_policy in SHED_POLICIES, opts.shed_policy
        assert opts.admission_queue >= 1, "admission_queue must be >= 1"
        assert opts.degrade_max_new >= 1, "degrade_max_new must be >= 1"
        self.obs = engine.obs
        self.host = opts.host
        self.port = 0
        self._cmds: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._inflight = 0             # accepted, not yet done/cancelled
        self._open_streams = 0         # SSE responses currently open
        self._shutdown = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._engine_thread: Optional[threading.Thread] = None
        self._stop_ev: Optional[asyncio.Event] = None
        self._started = False
        self.error: Optional[BaseException] = None
        reg = self.obs.registry
        self._m_requests = reg.counter(
            "repro_ingress_requests_total",
            "ingress admission outcomes", ["outcome"])
        self._m_disconnects = reg.counter(
            "repro_ingress_disconnects_total",
            "client disconnects mid-stream")
        self._m_stream_s = reg.histogram(
            "repro_ingress_stream_seconds",
            "SSE stream wall time, accept to close")
        self._g_inflight = reg.gauge(
            "repro_ingress_inflight_requests",
            "requests accepted but not yet finished")
        self._g_streams = reg.gauge(
            "repro_ingress_open_streams", "SSE streams currently open")

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "IngressServer":
        assert not self._started, "ingress already started"
        self._started = True
        started = threading.Event()
        self._loop_thread = threading.Thread(
            target=self._loop_main, args=(started,),
            name="ingress-loop", daemon=True)
        self._loop_thread.start()
        started.wait()
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="ingress-engine", daemon=True)
        self._engine_thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Shut down: optionally let the engine finish its in-flight
        work (``drain``), flush open streams, then stop both threads.
        Idempotent. Raises the engine thread's error, if it had one."""
        if not self._started:
            return
        self._started = False
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        self._cmds.put((self._request_shutdown(drain), fut))
        self._engine_thread.join(timeout=timeout)
        deadline = time.perf_counter() + timeout
        while self._open_streams and time.perf_counter() < deadline:
            time.sleep(0.005)          # final SSE events still flushing
        self._loop.call_soon_threadsafe(self._stop_ev.set)
        self._loop_thread.join(timeout=timeout)
        if self.error is not None:
            raise RuntimeError("the ingress's engine thread failed") \
                from self.error

    def _request_shutdown(self, drain: bool):
        def fn():
            self._shutdown = True
            self._drain = drain
        return fn

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- engine thread ---------------------------------------------------
    def _call(self, fn) -> "concurrent.futures.Future":
        """Run ``fn()`` on the engine thread; resolve the future with
        its result (or exception). The only path into engine state."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        self._cmds.put((fn, fut))
        return fut

    def _engine_loop(self) -> None:
        eng = self.engine
        self._drain = True
        while True:
            try:
                # block while idle (nothing to step); just poll the
                # queue between steps otherwise
                cmd = self._cmds.get(block=not eng.has_work,
                                     timeout=0.05)
            except queue.Empty:
                cmd = None
            while cmd is not None:
                fn, fut = cmd
                try:
                    fut.set_result(fn())
                except BaseException as e:      # noqa: BLE001
                    fut.set_exception(e)
                try:
                    cmd = self._cmds.get_nowait()
                except queue.Empty:
                    cmd = None
            if self._shutdown and not (self._drain and eng.has_work):
                break
            if eng.has_work:
                try:
                    eng.step()
                except Exception as e:          # noqa: BLE001
                    self.error = e             # stop() raises it
                    break

    # -- asyncio thread --------------------------------------------------
    def _loop_main(self, started: threading.Event) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._main(started))
        finally:
            self._loop.close()

    async def _main(self, started: threading.Event) -> None:
        self._stop_ev = asyncio.Event()
        server = await asyncio.start_server(
            self._handle, self.opts.host, self.opts.port)
        addr = server.sockets[0].getsockname()
        self.host, self.port = addr[0], int(addr[1])
        started.set()
        async with server:
            await self._stop_ev.wait()
        # the server no longer accepts; cancel any handler that is
        # still around (stop() already waited for streams to flush)
        tasks = [t for t in asyncio.all_tasks()
                 if t is not asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            parts = line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1].split("?", 1)[0]
            headers: Dict[str, str] = {}
            while True:
                hline = await reader.readline()
                if hline in (b"\r\n", b"\n", b""):
                    break
                k, _, v = hline.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            if method == "GET" and path == "/healthz":
                await self._respond(writer, 200, b"ok\n", "text/plain")
            elif method == "POST" and path == "/generate":
                await self._generate(reader, writer, headers)
            else:
                await self._respond(writer, 404, b"not found\n",
                                    "text/plain")
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError, asyncio.CancelledError):
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()

    async def _respond(self, writer, status: int, body: bytes,
                       ctype: str, extra: Tuple[Tuple[str, str], ...] = ()
                       ) -> None:
        head = [f"HTTP/1.1 {status} {_REASONS[status]}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(body)}", "Connection: close"]
        head += [f"{k}: {v}" for k, v in extra]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()

    def _parse_generate(self, body: bytes) -> Dict[str, Any]:
        spec = json.loads(body)
        prompt = np.asarray([int(t) for t in spec["prompt"]], np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        out = {"prompt": prompt,
               "max_new_tokens": int(spec.get("max_new_tokens", 32)),
               "eos_id": (int(spec["eos_id"])
                          if spec.get("eos_id") is not None else None),
               "stop": tuple(tuple(int(t) for t in s)
                             for s in spec.get("stop", ()))}
        sp = SamplingParams(
            temperature=float(spec.get("temperature", 0.0)),
            top_k=int(spec.get("top_k", 0)),
            top_p=float(spec.get("top_p", 1.0)),
            seed=int(spec.get("seed", 0)))
        out["sampling"] = sp
        return out

    async def _generate(self, reader, writer,
                        headers: Dict[str, str]) -> None:
        opts, tracer = self.opts, self.obs.tracer
        t0 = time.perf_counter()
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            n = 0
        if n <= 0 or n > opts.max_body_bytes:
            self._m_requests.labels(outcome="bad_request").inc()
            await self._respond(writer, 413 if n > opts.max_body_bytes
                                else 400, b"bad body\n", "text/plain")
            return
        body = await reader.readexactly(n)
        try:
            spec = self._parse_generate(body)
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            self._m_requests.labels(outcome="bad_request").inc()
            await self._respond(writer, 400, f"{e}\n".encode(),
                                "text/plain")
            return

        # -- admission / load shedding -----------------------------------
        degraded = False
        with self._lock:
            over = self._inflight >= opts.admission_queue
            if over and opts.shed_policy == "reject":
                self._m_requests.labels(outcome="rejected").inc()
                tracer.instant("SHED", pid=PID_INGRESS, tid=0,
                               args={"policy": "reject"})
                retry = max(1, int(-(-opts.retry_after_s // 1)))
                await self._respond(
                    writer, 429, b"overloaded\n", "text/plain",
                    extra=(("Retry-After", str(retry)),))
                return
            if over:                           # degrade: clamp budget
                degraded = True
                spec["max_new_tokens"] = min(spec["max_new_tokens"],
                                             opts.degrade_max_new)
            self._inflight += 1
            self._g_inflight.set(self._inflight)

        loop = asyncio.get_running_loop()
        q: "asyncio.Queue" = asyncio.Queue()

        def post(item) -> None:
            # engine thread -> event loop; the loop may already be
            # gone during shutdown races — drop, the stream is dead
            try:
                loop.call_soon_threadsafe(q.put_nowait, item)
            except RuntimeError:
                pass

        def on_token(tok: int, _req: Request) -> None:
            post(("token", tok))

        def on_done(req: Request) -> None:
            with self._lock:
                self._inflight -= 1
                self._g_inflight.set(self._inflight)
            post(("done", req.finish_reason))

        def do_submit() -> Request:
            return self.engine.submit(
                spec["prompt"], max_new_tokens=spec["max_new_tokens"],
                eos_id=spec["eos_id"], stop=spec["stop"],
                sampling=spec["sampling"], on_token=on_token,
                on_done=on_done)

        try:
            req = await asyncio.wrap_future(self._call(do_submit))
        except ValueError as e:                # over engine capacity
            with self._lock:
                self._inflight -= 1
                self._g_inflight.set(self._inflight)
            self._m_requests.labels(outcome="bad_request").inc()
            await self._respond(writer, 400, f"{e}\n".encode(),
                                "text/plain")
            return
        outcome = "degraded" if degraded else "accepted"
        self._m_requests.labels(outcome=outcome).inc()
        tracer.thread_name(PID_INGRESS, req.rid, f"req {req.rid}")
        tracer.begin("STREAM", pid=PID_INGRESS, tid=req.rid,
                     args={"outcome": outcome,
                           "max_new": spec["max_new_tokens"]})

        self._open_streams += 1
        self._g_streams.set(self._open_streams)
        watcher = asyncio.ensure_future(self._watch_eof(reader))
        offset = 0
        try:
            writer.write((
                "HTTP/1.1 200 OK\r\n"
                "Content-Type: text/event-stream\r\n"
                "Cache-Control: no-cache\r\n"
                f"X-Admission: {outcome}\r\n"
                "Connection: close\r\n\r\n").encode())
            await writer.drain()
            while True:
                getter = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait(
                    {getter, watcher},
                    return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                    raise _ClientGone
                kind, val = getter.result()
                if kind == "token":
                    writer.write(_sse(int(val), offset, None))
                    await writer.drain()
                    offset += 1
                else:                          # ("done", reason)
                    writer.write(_sse(None, offset, val))
                    await writer.drain()
                    break
            self._m_stream_s.observe(time.perf_counter() - t0)
        except (_ClientGone, ConnectionResetError, BrokenPipeError):
            self._m_disconnects.inc()
            # the cancel runs on the engine thread between steps; a
            # request that happens to finish first is a no-op there. It
            # is queued before the instant is stamped, so at most one
            # step starts between DISCONNECT and CANCEL
            self._call(lambda: self.engine.cancel(req))
            tracer.instant("DISCONNECT", pid=PID_INGRESS, tid=req.rid,
                           args={"offset": offset})
        finally:
            tracer.end("STREAM", pid=PID_INGRESS, tid=req.rid)
            watcher.cancel()
            self._open_streams -= 1
            self._g_streams.set(self._open_streams)

    @staticmethod
    async def _watch_eof(reader: asyncio.StreamReader) -> None:
        """Resolve when the client half-closes or resets — stray bytes
        after the request body are drained and ignored."""
        while True:
            try:
                chunk = await reader.read(1024)
            except (ConnectionResetError, BrokenPipeError):
                return
            if not chunk:
                return


# ---------------------------------------------------------------------------
# Blocking SSE client (tests and chip_smoke.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamResult:
    """One client-side request outcome."""
    status: int                    # HTTP status (200 / 429 / 400 / ...)
    tokens: List[int]              # token ids received, in order
    finish_reason: str             # "" unless the final event arrived
    degraded: bool = False         # X-Admission: degraded
    retry_after_s: float = 0.0     # 429 Retry-After hint
    ttft_s: float = 0.0            # send -> first token event
    latency_s: float = 0.0         # send -> stream end (or disconnect)


class IngressClient:
    """Minimal blocking SSE client over a raw socket, so tests and the
    load generator control the connection directly — a mid-stream
    disconnect is just ``disconnect_after=`` (the socket closes with
    the stream unread, which is exactly what a vanished client looks
    like to the server)."""

    def __init__(self, host: str, port: int, *, timeout: float = 60.0):
        self.host, self.port, self.timeout = host, int(port), timeout

    def healthz(self) -> bool:
        with socket.create_connection((self.host, self.port),
                                      self.timeout) as sock:
            sock.sendall((f"GET /healthz HTTP/1.1\r\n"
                          f"Host: {self.host}\r\n"
                          f"Connection: close\r\n\r\n").encode())
            return b" 200 " in sock.makefile("rb").readline()

    def generate(self, prompt, *, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, stop=(),
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 disconnect_after: Optional[int] = None) -> StreamResult:
        """POST /generate and consume the SSE stream.
        ``disconnect_after=N`` closes the socket after the N-th token
        event (N=0: right after the headers), simulating a client that
        went away mid-stream."""
        body = json.dumps({
            "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
            "max_new_tokens": int(max_new_tokens), "eos_id": eos_id,
            "stop": [list(map(int, s)) for s in stop],
            "temperature": temperature, "top_k": top_k, "top_p": top_p,
            "seed": seed}).encode()
        head = (f"POST /generate HTTP/1.1\r\nHost: {self.host}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n").encode()
        t0 = time.perf_counter()
        with socket.create_connection((self.host, self.port),
                                      self.timeout) as sock:
            sock.sendall(head + body)
            f = sock.makefile("rb")
            status = int(f.readline().split()[1])
            headers: Dict[str, str] = {}
            while True:
                line = f.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            res = StreamResult(
                status=status, tokens=[], finish_reason="",
                degraded=(headers.get("x-admission") == "degraded"),
                retry_after_s=float(headers.get("retry-after", 0.0)))
            if status != 200:
                res.latency_s = time.perf_counter() - t0
                return res
            if disconnect_after == 0:
                res.latency_s = time.perf_counter() - t0
                return res                     # close with stream unread
            for event in self._events(f):
                if event.get("finish_reason") is not None:
                    res.finish_reason = event["finish_reason"]
                    break
                res.tokens.append(int(event["token_id"]))
                if len(res.tokens) == 1:
                    res.ttft_s = time.perf_counter() - t0
                if disconnect_after is not None \
                        and len(res.tokens) >= disconnect_after:
                    break                      # hang up mid-stream
            res.latency_s = time.perf_counter() - t0
            return res

    @staticmethod
    def _events(f):
        """Parse ``data:`` SSE events off a socket file object."""
        data: List[bytes] = []
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b"data:"):
                data.append(line[5:].strip())
            elif not line and data:
                yield json.loads(b"\n".join(data))
                data = []
