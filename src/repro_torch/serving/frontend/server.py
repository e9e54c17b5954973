"""Stdlib-asyncio HTTP frontend over :class:`EngineDriver`.

No new runtime dependencies: ``asyncio.start_server`` plus a hand-rolled
HTTP/1.1 request parser (one request per connection, ``Connection:
close`` — SSE holds the connection for the response anyway). Endpoints:

``POST /v1/completions``
    JSON body: ``{"prompt": [token ids], "stream": bool, "tenant": str,
    ...SamplingParams fields...}``. With ``"stream": true`` the response
    is ``text/event-stream``: one ``data:`` event per generated token in
    the engine step that produced it (the driver's per-request queues
    bridged onto the asyncio loop with ``call_soon_threadsafe``), a
    terminal event carrying the ``RequestResult`` summary, then
    ``data: [DONE]``. Without streaming, one JSON body at completion.
    A client that disconnects mid-stream cancels its request (freeing
    the slot without perturbing co-batched neighbors, the v1 guarantee).
``GET /healthz``
    ``engine.health()`` (a ``HealthSnapshot``) as JSON, snapshotted on
    the driver thread so it can never race a step.
``GET /metrics``
    The registry's Prometheus text exposition (v1.3 frozen schema plus
    the frontend additions).

Status mapping (the v1.4 contract): terminal outcomes that occur before
any byte of the body is sent map to HTTP codes — ``"rejected"`` → 429
with ``Retry-After``, ``"timeout"`` → 504, ``"error"`` → 500; malformed
bodies/params → 400; a supervised driver in degraded mode (crash-loop
circuit breaker open) → 503 with ``Retry-After``. Every
``/v1/completions`` response carries
``X-Request-Id: <uid>`` — the id the trace recorder annotates spans
with, so an operator can go from an HTTP error straight to the request's
lifecycle spans. Once streaming has started, late outcomes are reported
in the terminal SSE event instead (HTTP has already committed a 200).

``ThreadedHttpServer`` wraps the server in a daemon thread with its own
event loop — what tests, benches, and the example use to serve and
consume from one process.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import json
import threading
from typing import Any, Dict, Optional, Tuple

from repro_torch.serving.api import (FINISH_ERROR, FINISH_REJECTED,
                                     FINISH_TIMEOUT, SamplingParams)
from repro_torch.serving.frontend.driver import DriverHandle, EngineDriver
from repro_torch.serving.frontend.supervisor import DegradedError

#: terminal finish_reason → HTTP status, when known before the body starts
STATUS_BY_REASON = {
    FINISH_REJECTED: 429,
    FINISH_TIMEOUT: 504,
    FINISH_ERROR: 500,
}

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

#: request-body keys forwarded into SamplingParams
_PARAM_KEYS = ("max_new_tokens", "temperature", "top_k", "top_p", "seed",
               "stop", "deadline_s", "ttft_deadline_s", "tenant")


class _BadRequest(Exception):
    pass


def _parse_body(body: Dict[str, Any]) -> Tuple[list, SamplingParams, bool]:
    if not isinstance(body, dict):
        raise _BadRequest("body must be a JSON object")
    if "prompt" not in body:
        raise _BadRequest("missing 'prompt' (a list of token ids)")
    prompt = body["prompt"]
    if not isinstance(prompt, list) \
            or not all(isinstance(t, int) for t in prompt):
        raise _BadRequest("'prompt' must be a list of token ids — this "
                          "endpoint is pre-tokenized")
    stream = body.get("stream", False)
    if not isinstance(stream, bool):
        raise _BadRequest("'stream' must be a boolean")
    fields = {}
    for k in body:
        if k in ("prompt", "stream"):
            continue
        if k not in _PARAM_KEYS:
            raise _BadRequest(f"unknown field {k!r} (expected one of "
                              f"{sorted(_PARAM_KEYS)})")
        fields[k] = body[k]
    if "stop" in fields:
        stop = fields["stop"]
        if not isinstance(stop, list) \
                or not all(isinstance(t, int) for t in stop):
            raise _BadRequest("'stop' must be a list of token ids")
        fields["stop"] = frozenset(stop)
    try:
        params = SamplingParams(**fields)
    except (TypeError, ValueError) as e:
        raise _BadRequest(str(e)) from e
    return prompt, params, stream


def _result_json(res) -> Dict[str, Any]:
    return {
        "id": res.uid,
        "tokens": list(res.tokens),
        "finish_reason": res.finish_reason,
        "truncated": res.truncated,
        "ttft_s": res.ttft,
        "queue_wait_s": res.queue_wait,
        "error": res.error,
    }


class HttpServer:
    """The asyncio server; all engine access goes through ``driver``."""

    def __init__(self, driver: EngineDriver, host: str = "127.0.0.1",
                 port: int = 0, *, max_body: int = 1 << 22):
        self.driver = driver
        self.host = host
        self.port = port
        self.max_body = max_body
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()

    # ----------------------------------------------------------- lifecycle
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.host, self.port = self._server.sockets[0].getsockname()[:2]

    async def stop(self) -> None:
        """Stop listening and wait for in-flight connections to finish
        (their requests keep running in the engine; only intake stops)."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._conn_tasks:
            await asyncio.gather(*list(self._conn_tasks),
                                 return_exceptions=True)

    # ----------------------------------------------------------- plumbing
    async def _driver_call(self, fn):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, functools.partial(self.driver.call, fn))

    @staticmethod
    async def _write_response(writer, status: int, body: bytes,
                              ctype: str = "application/json",
                              extra: Optional[Dict[str, str]] = None):
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(body)}",
                "Connection: close"]
        for k, v in (extra or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()

    @staticmethod
    async def _write_json(writer, status: int, obj: Any,
                          extra: Optional[Dict[str, str]] = None):
        await HttpServer._write_response(
            writer, status, (json.dumps(obj) + "\n").encode(), extra=extra)

    async def _read_request(self, reader):
        """Parse one HTTP/1.1 request; returns (method, path, headers,
        body) or raises ``_BadRequest`` / ``asyncio.IncompleteReadError``."""
        line = await reader.readline()
        if not line:
            raise asyncio.IncompleteReadError(b"", None)
        try:
            method, path, _version = line.decode("latin-1").split(None, 2)
        except ValueError:
            raise _BadRequest("malformed request line") from None
        headers: Dict[str, str] = {}
        while True:
            raw = await reader.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            if b":" in raw:
                k, v = raw.decode("latin-1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0") or "0")
        if length > self.max_body:
            raise _BadRequest(f"body too large ({length} > {self.max_body})")
        body = await reader.readexactly(length) if length else b""
        return method, path.split("?", 1)[0], headers, body

    # ------------------------------------------------------------ handlers
    async def _handle_conn(self, reader, writer):
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            try:
                method, path, headers, body = await self._read_request(reader)
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            except _BadRequest as e:
                await self._write_json(writer, 400, {"error": str(e)})
                return
            if path == "/healthz":
                await self._handle_healthz(writer, method)
            elif path == "/metrics":
                await self._handle_metrics(writer, method)
            elif path == "/v1/completions":
                await self._handle_completions(reader, writer, method, body)
            else:
                await self._write_json(writer, 404,
                                       {"error": f"no route {path!r}"})
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away mid-response
        finally:
            self._conn_tasks.discard(task)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle_healthz(self, writer, method):
        if method != "GET":
            await self._write_json(writer, 405, {"error": "GET only"})
            return
        # a supervised driver surfaces its recovery state (generation,
        # restarts, degraded, blacklist) alongside the engine snapshot
        status_fn = getattr(self.driver, "supervisor_status", None)
        sup = status_fn() if status_fn is not None else None
        try:
            snap = await self._driver_call(lambda eng: eng.health())
        except RuntimeError as e:  # engine mid-rebuild / permanently dead
            payload = {"ok": False, "error": str(e)}
            if sup is not None:
                payload["supervisor"] = sup
            await self._write_json(writer, 503, payload)
            return
        payload = dataclasses.asdict(snap)
        payload["ok"] = True
        if sup is not None:
            payload["supervisor"] = sup
        await self._write_json(writer, 200, payload)

    async def _handle_metrics(self, writer, method):
        if method != "GET":
            await self._write_json(writer, 405, {"error": "GET only"})
            return
        text = await self._driver_call(
            lambda eng: eng.obs.registry.render_prometheus())
        await self._write_response(
            writer, 200, text.encode(),
            ctype="text/plain; version=0.0.4; charset=utf-8")

    async def _handle_completions(self, reader, writer, method, body):
        if method != "POST":
            await self._write_json(writer, 405, {"error": "POST only"})
            return
        try:
            payload = json.loads(body.decode("utf-8") or "null")
            prompt, params, stream = _parse_body(payload)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            await self._write_json(writer, 400,
                                   {"error": f"invalid JSON: {e}"})
            return
        except _BadRequest as e:
            await self._write_json(writer, 400, {"error": str(e)})
            return
        loop = asyncio.get_running_loop()
        try:
            # executor hop: a supervised submit may park briefly while the
            # engine rebuilds — never block the event loop on it
            handle = await loop.run_in_executor(
                None, functools.partial(self.driver.submit, prompt, params))
        except (TypeError, ValueError) as e:
            await self._write_json(writer, 400, {"error": str(e)})
            return
        except DegradedError as e:  # breaker open: shed with Retry-After
            await self._write_json(
                writer, 503, {"error": str(e), "degraded": True},
                extra={"Retry-After": str(max(int(e.retry_after), 1))})
            return

        events: asyncio.Queue = asyncio.Queue()
        handle.subscribe(
            lambda ev: loop.call_soon_threadsafe(events.put_nowait, ev))
        # EOF on the request socket = the client hung up: cancel the
        # request so its slot frees without touching co-batched neighbors
        gone = asyncio.ensure_future(self._watch_disconnect(reader))
        try:
            if stream:
                await self._stream_response(writer, handle, events, gone)
            else:
                await self._unary_response(writer, handle, events, gone)
        finally:
            gone.cancel()
            if not handle.done:
                # any early exit with the request still running — reader
                # EOF, a write to a closed socket, a handler error — means
                # the client is gone: free the slot
                handle.cancel()

    @staticmethod
    async def _watch_disconnect(reader):
        try:
            while True:
                chunk = await reader.read(4096)
                if not chunk:
                    return
        except (ConnectionError, asyncio.CancelledError):
            return

    async def _next_event(self, events: asyncio.Queue, gone: asyncio.Task,
                          handle: DriverHandle):
        """Next handle event, or ``None`` if the client disconnected
        first (in which case the request has been cancelled)."""
        getter = asyncio.ensure_future(events.get())
        done, _pending = await asyncio.wait(
            {getter, gone}, return_when=asyncio.FIRST_COMPLETED)
        if gone in done:  # disconnect wins even if a token is also ready
            getter.cancel()
            handle.cancel()
            return None
        return getter.result()

    def _error_headers(self, res) -> Dict[str, str]:
        extra = {"X-Request-Id": str(res.uid)}
        if res.finish_reason == FINISH_REJECTED:
            extra["Retry-After"] = "1"
        return extra

    async def _unary_response(self, writer, handle, events, gone):
        while True:
            ev = await self._next_event(events, gone, handle)
            if ev is None:
                return  # disconnected; nothing left to write to
            if ev[0] == "done":
                res = ev[1]
                status = STATUS_BY_REASON.get(res.finish_reason, 200) \
                    if not res.tokens else 200
                await self._write_json(writer, status, _result_json(res),
                                       extra=self._error_headers(res))
                return

    async def _stream_response(self, writer, handle, events, gone):
        # hold the status line until the first event: a request that
        # retires with rejected/timeout/error before producing anything
        # still gets a real HTTP error code instead of an empty 200 stream
        first = await self._next_event(events, gone, handle)
        if first is None:
            return
        if first[0] == "done" and not first[1].tokens:
            res = first[1]
            status = STATUS_BY_REASON.get(res.finish_reason, 200)
            await self._write_json(writer, status, _result_json(res),
                                   extra=self._error_headers(res))
            return
        head = ["HTTP/1.1 200 OK",
                "Content-Type: text/event-stream",
                "Cache-Control: no-store",
                f"X-Request-Id: {handle.uid}",
                "Connection: close"]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
        ev = first
        while True:
            if ev[0] == "token":
                line = {"id": handle.uid, "index": ev[1], "token": ev[2]}
            else:
                line = _result_json(ev[1])
            writer.write(f"data: {json.dumps(line)}\n\n".encode())
            await writer.drain()
            if ev[0] == "done":
                writer.write(b"data: [DONE]\n\n")
                await writer.drain()
                return
            ev = await self._next_event(events, gone, handle)
            if ev is None:
                return  # disconnected mid-stream; request cancelled


class ThreadedHttpServer:
    """Run an :class:`HttpServer` on a daemon thread with a private event
    loop — the in-process deployment shape (tests/benches/examples):

    >>> driver = EngineDriver(engine).start()
    >>> srv = ThreadedHttpServer(driver).start()
    >>> ...  # requests against http://{srv.host}:{srv.port}
    >>> srv.stop(); driver.drain(); driver.close()
    """

    def __init__(self, driver: EngineDriver, host: str = "127.0.0.1",
                 port: int = 0):
        self.server = HttpServer(driver, host, port)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="http-frontend")
        self._ready = threading.Event()
        self._startup_exc: Optional[BaseException] = None

    @property
    def host(self):
        return self.server.host

    @property
    def port(self):
        return self.server.port

    def _run(self):
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self.server.start())
        except BaseException as e:  # port in use, bad host, ...
            self._startup_exc = e
            self._ready.set()
            return
        self._ready.set()
        self._loop.run_forever()
        # drain in-flight connections before the loop is torn down
        self._loop.run_until_complete(self.server.stop())

    def start(self, timeout: float = 10.0) -> "ThreadedHttpServer":
        self._thread.start()
        if not self._ready.wait(timeout):
            raise TimeoutError("HTTP server failed to start")
        if self._startup_exc is not None:
            raise self._startup_exc
        return self

    def stop(self, timeout: float = 10.0) -> None:
        if not self._thread.is_alive():
            return
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout)
        if not self._thread.is_alive() and not self._loop.is_closed():
            self._loop.close()
