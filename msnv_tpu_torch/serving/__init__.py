"""HTTP serving front-end of the port (stdlib-only, no web framework).

  common.py   — SAMPLE_RATE, error types, the _armed generator wrapper
  batcher.py  — _Batcher: leader-follower dynamic batching for /synthesize
  mux.py      — StreamMultiplexer: lane-batched /stream, one device carry
  service.py  — VocoderService: model + generation callables + requests
  httpd.py    — _Handler + make_server: the threaded stdlib HTTP layer
  aio.py      — AsyncVocoderServer + make_async_server: the asyncio layer
  cli.py      — `msnv-serve-torch` / `python -m msnv_tpu_torch.serving`

See service.py's docstring for the endpoint contract and kernel dispatch.
"""

from msnv_tpu_torch.serving.aio import AsyncVocoderServer, make_async_server
from msnv_tpu_torch.serving.cli import main
from msnv_tpu_torch.serving.common import SAMPLE_RATE, Overloaded
from msnv_tpu_torch.serving.httpd import make_server
from msnv_tpu_torch.serving.mux import StreamMultiplexer
from msnv_tpu_torch.serving.service import VocoderService

__all__ = [
    "SAMPLE_RATE",
    "AsyncVocoderServer",
    "Overloaded",
    "StreamMultiplexer",
    "VocoderService",
    "main",
    "make_async_server",
    "make_server",
]
