"""Selector-based async HTTP front-end (asyncio, stdlib-only).

Port of the JAX package's serving/aio.py; the file is asyncio and numpy
only, so the port changes nothing but its imports.

The threaded front-end (httpd.py) costs one OS thread per connection: at
N concurrent /stream clients that is N handler threads, each doing a
queue.get + socket write + flush per K-frame tick, all contending for the
interpreter lock with the mux pump that dispatches the device work. This
front-end serves the same endpoints from ONE event-loop thread:

- mux-eligible /stream requests never block a thread. The handler
  acquires a mux lane, registers a per-lane sink
  (StreamMultiplexer.set_sink), and the pump's drained audio is written
  straight to the sockets from the loop thread — ONE loop wakeup per
  pump tick for all lanes (the sinks batch into a delivery list), not
  one queue.get + write + flush per lane per thread.
- /synthesize and non-mux /stream (explicit seed, non-default
  temperature — the reproducible per-connection path) run on a small
  thread pool; they hold the device lock anyway, so thread count never
  scales with connections.

Wire contract (status codes, chunked framing, audio/L16 payload) is
identical to httpd.make_server; tests/test_torch_serving_aio.py asserts
the per-connection path is byte-identical across front-ends and drives
the mux path over real sockets.
"""

from __future__ import annotations

import asyncio
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from msnv_tpu_torch.parallel.serve import MeshFailed
from msnv_tpu_torch.serving.common import SAMPLE_RATE, Overloaded
from msnv_tpu_torch.serving.service import VocoderService

_CRLF = b"\r\n"
_REASON = {200: "OK", 400: "Bad Request", 404: "Not Found",
           413: "Payload Too Large", 429: "Too Many Requests",
           500: "Internal Server Error"}


class _Stream:
    """Loop-thread state of one in-flight mux-backed /stream response.

    Deliveries are routed by OBJECT, not lane number: the pump's sink
    closure captures this instance, so audio that was in flight when the
    stream's lane was released can never reach the lane's next occupant
    (the mux's _gen invariant, preserved across the sink path)."""

    __slots__ = ("writer", "remaining", "done", "closed")

    def __init__(self, writer, remaining_bytes: int, done):
        self.writer = writer
        self.remaining = remaining_bytes   # payload bytes still to send
        self.done = done                   # future: all audio written
        self.closed = False                # handler released the lane


class AsyncVocoderServer:
    """asyncio HTTP server over a VocoderService.

    Usage:
        srv = AsyncVocoderServer(service, port=0)
        srv.start()                  # returns once the socket is bound
        host, port = srv.server_address
        ...
        srv.shutdown()

    The event loop runs in a dedicated daemon thread so the construction
    pattern matches httpd.make_server + serve_forever-in-a-thread.
    """

    # abort a connection whose client stopped reading once this much
    # audio is buffered in the transport (a stalled reader would
    # otherwise grow the write buffer without bound)
    MAX_WRITE_BUFFER = 8 << 20

    def __init__(self, service: VocoderService, host: str = "127.0.0.1",
                 port: int = 0, timeout_s: float = 120.0,
                 max_body: int = 64 << 20, pool_workers: int = 4):
        self.service = service
        self.host = host
        self.port = port
        self.timeout_s = float(timeout_s)
        self.max_body = int(max_body)
        self.server_address = None
        self._pool = ThreadPoolExecutor(
            max_workers=pool_workers, thread_name_prefix="msnv-aio")
        self._loop = None
        self._thread = None
        self._stop = None           # loop-side future: set to shut down
        # pump-thread -> loop-thread delivery batch: sinks append here
        # and schedule at most one loop wakeup while the batch is dirty
        self._dlock = threading.Lock()
        self._deliveries = []
        self._wake_scheduled = False

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        started = threading.Event()
        fail = []

        def run():
            try:
                asyncio.run(self._main(started))
            except Exception as e:   # noqa: BLE001 — surfaced to start()
                fail.append(e)
                started.set()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="msnv-aio-loop")
        self._thread.start()
        started.wait()
        if fail:
            raise fail[0]

    def shutdown(self) -> None:
        if self._loop is not None and not self._loop.is_closed():
            try:
                self._loop.call_soon_threadsafe(
                    lambda: self._stop.done() or self._stop.set_result(None))
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._pool.shutdown(wait=False)

    async def _main(self, started: threading.Event) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = self._loop.create_future()
        server = await asyncio.start_server(
            self._handle, self.host, self.port, backlog=512)
        self.server_address = server.sockets[0].getsockname()[:2]
        started.set()
        async with server:
            await self._stop

    # -- pump-side delivery ----------------------------------------------

    def _sink(self, st: _Stream, data: bytes) -> None:
        """Mux sink for one stream; runs on the PUMP thread. Batches the
        tick's deliveries and schedules one loop wakeup. The closure the
        mux holds captures `st`, so routing survives lane recycling."""
        with self._dlock:
            self._deliveries.append((st, data))
            wake = not self._wake_scheduled
            self._wake_scheduled = True
        if wake:
            try:
                self._loop.call_soon_threadsafe(self._flush_deliveries)
            except RuntimeError:
                pass   # loop shut down mid-stream; release() follows

    def _flush_deliveries(self) -> None:
        """Loop thread: write every pending (stream, audio) straight to
        its socket. transport.write is non-blocking (asyncio buffers), so
        this never stalls the loop; a stalled CLIENT is detected via the
        transport write-buffer size and aborted."""
        with self._dlock:
            deliveries, self._deliveries = self._deliveries, []
            self._wake_scheduled = False
        for st, data in deliveries:
            if st.closed:
                continue   # stream finished/aborted between tick & flush
            take = min(len(data), st.remaining)
            st.remaining -= take
            if take:
                try:
                    st.writer.write(b"%X\r\n" % take + data[:take] + _CRLF)
                except (ConnectionError, RuntimeError):
                    st.remaining = 0
            tr = st.writer.transport
            if tr.get_write_buffer_size() > self.MAX_WRITE_BUFFER:
                tr.abort()
                st.remaining = 0
            if st.remaining == 0 and not st.done.done():
                st.done.set_result(None)

    # -- HTTP plumbing ----------------------------------------------------

    async def _handle(self, reader, writer):
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                keep = await self._dispatch(req, writer)
                if not keep:
                    break
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.TimeoutError, asyncio.LimitOverrunError):
            pass
        finally:
            try:
                writer.close()
            except Exception:   # noqa: BLE001 — already torn down
                pass

    async def _read_request(self, reader):
        """-> (method, path, headers, body bytes) | None on clean EOF or
        idle/slow-client timeout. Oversized bodies come back as a _TooBig
        marker WITHOUT being read (the dispatcher answers 413 + close)."""
        try:
            line = await asyncio.wait_for(reader.readline(), self.timeout_s)
        except asyncio.TimeoutError:
            return None
        if not line or line == _CRLF:
            return None
        try:
            method, path, _version = line.decode("latin1").split()
        except ValueError:
            return None
        # headers + body under one deadline: a client that trickles its
        # request (slowloris) must not pin the handler past timeout_s.
        # (wait_for on a helper coroutine, not asyncio.timeout — the
        # package supports Python 3.10, where asyncio.timeout is absent)
        async def rest():
            headers = {}
            while True:
                h = await reader.readline()
                if not h or h == _CRLF:
                    break
                k, _, v = h.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            try:
                length = int(headers.get("content-length", 0))
            except ValueError:
                return (method, path, headers,
                        _Bad("malformed Content-Length"))
            if length > self.max_body:
                return (method, path, headers, _TooBig(length))
            body = await reader.readexactly(length) if length else b""
            return (method, path, headers, body)

        try:
            return await asyncio.wait_for(rest(), self.timeout_s)
        except asyncio.TimeoutError:
            return None

    def _respond(self, writer, code: int, payload: bytes,
                 ctype: str = "application/json", close: bool = False):
        head = (f"HTTP/1.1 {code} {_REASON.get(code, '')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n")
        if close:
            head += "Connection: close\r\n"
        writer.write(head.encode("latin1") + _CRLF + payload)
        return not close

    def _json(self, writer, code: int, obj: dict, close: bool = False):
        return self._respond(writer, code, json.dumps(obj).encode(),
                             close=close)

    async def _dispatch(self, req, writer) -> bool:
        method, path, _headers, body = req
        if isinstance(body, _TooBig):
            return self._json(writer, 413,
                              {"error": f"request body {body.length} bytes "
                                        f"exceeds cap {self.max_body}"},
                              close=True)
        if isinstance(body, _Bad):
            return self._json(writer, 400, {"error": body.reason},
                              close=True)
        if method == "GET":
            if path == "/healthz":
                return self._json(writer, 200, self.service.healthz())
            return self._json(writer, 404,
                              {"error": f"unknown path {path}"})
        if method != "POST":
            return self._json(writer, 404, {"error": f"unknown {method}"})
        try:
            payload = json.loads(body or b"{}")
        except ValueError as e:
            return self._json(writer, 400, {"error": f"bad JSON: {e}"})
        try:
            if path == "/synthesize":
                wav = await self._loop.run_in_executor(
                    self._pool, self.service.synthesize, payload)
                return self._respond(writer, 200, wav, ctype="audio/wav")
            if path == "/stream":
                return await self._stream(writer, payload)
            return self._json(writer, 404,
                              {"error": f"unknown path {path}"})
        except Overloaded as e:
            return self._json(writer, 429, {"error": str(e)})
        except MeshFailed as e:
            return self._json(writer, 500, {"error": str(e)}, close=True)
        except (KeyError, ValueError, TypeError) as e:
            return self._json(writer, 400, {"error": str(e)})

    # -- /stream ----------------------------------------------------------

    def _stream_headers(self, writer):
        writer.write((f"HTTP/1.1 200 OK\r\n"
                      f"Content-Type: audio/L16;rate={SAMPLE_RATE}\r\n"
                      f"Transfer-Encoding: chunked\r\n\r\n"
                      ).encode("latin1"))

    async def _stream(self, writer, payload: dict) -> bool:
        parsed = self.service.parse_stream(payload)
        cond, spk, _t, _s, eligible = parsed
        if not eligible:
            return await self._stream_fallback(writer, payload, parsed)
        mux = self.service._mux
        cond_np = np.asarray(cond, np.float32)
        n = len(cond_np)
        if n == 0:
            # zero-frame request: an immediate empty 200, no lane taken
            # (matches the threaded front-end's behavior)
            self._stream_headers(writer)
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return True
        pad = (-n) % mux.K
        if pad:
            cond_np = np.concatenate(
                [cond_np, np.repeat(cond_np[-1:], pad, axis=0)])
        lane = mux.acquire(spk)          # raises Overloaded -> 429
        st = _Stream(writer, n * self.service.cfg.lookback * 2,
                     self._loop.create_future())
        try:
            mux.set_sink(lane, lambda data, st=st: self._sink(st, data))
            self._stream_headers(writer)
            mux.feed(lane, [cond_np[i:i + mux.K]
                            for i in range(0, len(cond_np), mux.K)])
            # wait for the pump to finish the lane; poll is_closing so a
            # mid-stream disconnect releases the lane promptly (asyncio
            # surfaces disconnects to writes, not waits). The timeout is
            # IDLE-based: any delivered audio resets it, so long streams
            # making continuous progress are never cut (the threaded
            # path's q.get(timeout) semantics), only stalled ones.
            idle, last_remaining = 0.0, st.remaining
            while not st.done.done():
                await asyncio.wait([st.done], timeout=2.0)
                if writer.transport.is_closing():
                    return False
                if st.remaining != last_remaining:
                    last_remaining = st.remaining
                    idle = 0.0
                else:
                    idle += 2.0
                    if idle > self.timeout_s and not st.done.done():
                        writer.transport.abort()
                        return False
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return True
        finally:
            st.closed = True
            mux.release(lane)

    async def _stream_fallback(self, writer, payload: dict,
                               parsed=None) -> bool:
        """Per-connection reproducible path (explicit seed / non-default
        temperature): drive the blocking service.stream generator on the
        pool, chunk-framing each piece. Byte-identical to the threaded
        front-end (same generator, same framing). `parsed` forwards the
        already-parsed request so the (potentially multi-MB) cond payload
        is not decoded twice."""
        chunks = await self._loop.run_in_executor(
            self._pool, lambda: self.service.stream(payload,
                                                    _parsed=parsed))
        try:
            first = await self._loop.run_in_executor(
                self._pool, next, chunks, None)
            self._stream_headers(writer)
            piece = first
            while piece is not None:
                writer.write(b"%X\r\n" % len(piece) + piece + _CRLF)
                await writer.drain()
                piece = await self._loop.run_in_executor(
                    self._pool, next, chunks, None)
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return True
        finally:
            chunks.close()


class _TooBig:
    """Marker for an unread oversized request body."""

    def __init__(self, length: int):
        self.length = length


class _Bad:
    """Marker for a malformed request (answered 400 + close)."""

    def __init__(self, reason: str):
        self.reason = reason


def make_async_server(service: VocoderService, host: str = "127.0.0.1",
                      port: int = 0, timeout_s: float = 120.0,
                      max_body: int = 64 << 20) -> AsyncVocoderServer:
    """Build (not start) the async front-end; .start() binds the socket
    and returns, .server_address then has the bound (host, port)."""
    return AsyncVocoderServer(service, host, port, timeout_s=timeout_s,
                              max_body=max_body)
