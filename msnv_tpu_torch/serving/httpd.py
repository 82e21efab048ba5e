"""HTTP layer: request handler + server factory (stdlib http.server).

Port of the JAX package's serving/httpd.py: HTTP/1.1, no Nagle, 413 before the
body is read, 400/404/429, and /stream's generator primed before the 200.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from msnv_tpu_torch.serving.common import SAMPLE_RATE, Overloaded, _TooLarge
from msnv_tpu_torch.serving.service import VocoderService


class _Handler(BaseHTTPRequestHandler):
    service: VocoderService  # set by make_server
    # chunked transfer (used by /stream) does not exist in HTTP/1.0;
    # version-keyed clients would read the hex chunk framing as audio
    protocol_version = "HTTP/1.1"
    # robustness envelope (make_server overrides): a socket read/write
    # blocking past `timeout` seconds kills the connection instead of
    # pinning its thread forever; request bodies above max_body get 413
    # without being read (1 h of 86-dim conditioners ≈ 25 MB of JSON,
    # so 64 MB is generous)
    timeout = 60.0           # socketserver read timeout (settimeout)
    max_body = 64 << 20

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # one TCP segment per audio chunk: Nagle + delayed-ACK turns a
    # sequence of small writes into ~30-40 ms stalls per chunk
    disable_nagle_algorithm = True

    def _chunk(self, data: bytes):
        # single write so the chunk header/payload/trailer never straddle
        # segments waiting on an ACK
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _json(self, code: int, obj: dict, close: bool = False):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if close:
            self.send_header("Connection", "close")  # sets close_connection
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            self._json(200, self.service.healthz())
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def _body(self):
        length = int(self.headers.get("Content-Length", 0))
        if length > self.max_body:
            raise _TooLarge(length)
        return json.loads(self.rfile.read(length) or b"{}")

    def do_POST(self):
        try:
            body = self._body()
        except _TooLarge as e:
            # don't read the oversized body; close so the client can't
            # keep pumping it into a dead keep-alive connection
            return self._json(413, {"error": f"request body {e.length} "
                                             f"bytes exceeds cap "
                                             f"{self.max_body}"},
                              close=True)
        except (ValueError, json.JSONDecodeError) as e:
            return self._json(400, {"error": f"bad JSON: {e}"})
        try:
            if self.path == "/synthesize":
                wav = self.service.synthesize(body)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(wav)))
                self.end_headers()
                self.wfile.write(wav)
            elif self.path == "/stream":
                chunks = self.service.stream(body)
                try:
                    # prime the generator BEFORE sending headers: request
                    # validation raises at the first iteration, and a 400
                    # must not follow an already-sent 200 + chunked header
                    try:
                        first = next(chunks)
                    except StopIteration:
                        first = None
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     f"audio/L16;rate={SAMPLE_RATE}")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    # a mid-stream failure past this point terminates the
                    # connection without the 0-chunk: clients see a
                    # truncated chunked body (a detectable error), never a
                    # fake 200-OK
                    if first is not None:
                        self._chunk(first)
                        for chunk in chunks:
                            self._chunk(chunk)
                    self.wfile.write(b"0\r\n\r\n")
                finally:
                    # releases the stream slot deterministically
                    # on any handler error (not just at GC time)
                    chunks.close()
            else:
                self._json(404, {"error": f"unknown path {self.path}"})
        except Overloaded as e:
            self._json(429, {"error": str(e)})
        except (KeyError, ValueError, TypeError) as e:
            self._json(400, {"error": str(e)})


def make_server(service: VocoderService, host: str = "127.0.0.1",
                port: int = 0, timeout_s: float = 60.0,
                max_body: int = 64 << 20) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; .server_address has the bound
    port when port=0. Call .serve_forever() (e.g. in a thread)."""
    handler = type("BoundHandler", (_Handler,),
                   {"service": service,
                    "timeout": float(timeout_s),
                    "max_body": int(max_body)})

    class _Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: a connect stampede
        # overflows it and the kernel resets the overflow
        request_queue_size = 512

    return _Server((host, port), handler)
