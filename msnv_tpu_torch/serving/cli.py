"""`msnv-serve-torch` CLI: serve a checkpoint over HTTP."""

from __future__ import annotations

import signal
import threading


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None):
    """CLI: serve a checkpoint.

    python -m msnv_tpu_torch.serving \
        --model results/<tag>/checkpoints/ep...npz \
        [--host 0.0.0.0] [--port 8000] [--temperature 1.0] [--device cuda]
        [--mux_lanes N] [--frontend {aio,threaded}] [--artifact a.msnvt]
    torchrun --nproc_per_node N -m msnv_tpu_torch.serving --mesh_data N ...

    The experiment tag (the results directory name) rebuilds the config;
    the checkpoint is a `.npz` (the JAX trainer's), a `.dcp` or an `.orbax`
    directory (training/checkpoint.py, load_any).

    --mesh_data N > 1 serves over an N x 1 ('data', 'model') mesh, one
    process per GPU: under torchrun the process group is made from the
    launcher's environment (a group the caller made is used as it is), and
    its world must be N. Every rank loads and builds the service; rank 0
    serves HTTP and the other ranks follow it (parallel/serve.py). SIGINT
    or SIGTERM to rank 0 stops its front and closes the service, which
    stops the other ranks; every rank then leaves the process group it
    made and returns. A failed rank fails every rank: rank 0 stops serving
    and raises.
    """
    import argparse

    import torch.distributed as dist

    from msnv_tpu_torch.config import parse_tag, tag_from_checkpoint_path
    from msnv_tpu_torch.export import load_artifact
    from msnv_tpu_torch.models.samplernn import init_params
    from msnv_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                              rank_device)
    from msnv_tpu_torch.parallel.serve import follow
    from msnv_tpu_torch.serving.service import VocoderService
    from msnv_tpu_torch.training.checkpoint import load_any

    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--frames_per_push", type=int, default=1)
    p.add_argument("--max_batch", type=int, default=1,
                   help=">1: dynamically batch concurrent /synthesize "
                        "requests into one device call")
    p.add_argument("--linger_ms", type=float, default=10.0,
                   help="max wait for co-batchable requests")
    p.add_argument("--max_streams", type=int, default=8,
                   help="concurrent /stream cap (excess gets 429)")
    p.add_argument("--mux_lanes", type=int, default=0,
                   help=">0: lane-batched /stream multiplexer — N "
                        "concurrent default-temperature streams share one "
                        "device carry and advance together per push "
                        "(per-request seed is ignored on this path)")
    p.add_argument("--mesh_data", type=int, default=0,
                   help=">1: shard /synthesize request lanes and mux lanes "
                        "over a ('data','model') mesh of this many data "
                        "shards, one process per GPU (torchrun "
                        "--nproc_per_node N); params replicate, each rank "
                        "generates its lane shard with a per-shard folded "
                        "generator. 0/1 = single device.")
    p.add_argument("--frontend", choices=("aio", "threaded"),
                   default="aio",
                   help="HTTP front-end: 'aio' (one event-loop thread "
                        "serves all /stream connections — the many-stream "
                        "default) or 'threaded' (stdlib "
                        "thread-per-connection)")
    p.add_argument("--timeout_s", type=float, default=60.0,
                   help="per-connection socket read/write timeout")
    p.add_argument("--max_body_mb", type=float, default=64.0,
                   help="request body size cap (413 beyond it)")
    p.add_argument("--frame_bucket", type=int, default=16,
                   help="pad request frame counts to this multiple (must "
                        "match msnv-export-torch --frame_bucket for "
                        "artifact dispatch)")
    p.add_argument("--artifact", default=None,
                   help="serving artifact from msnv-export-torch: matching "
                        "requests run its programs, others the live path. "
                        "Checked against the served model and device at "
                        "startup.")
    args = p.parse_args(argv)

    device = rank_device(args.device)
    shards = max(args.mesh_data, 1)
    made_group = not dist.is_initialized()
    world = init_distributed(False, device)
    made_group = made_group and dist.is_initialized()
    try:
        if world != shards:
            raise ValueError(f"--mesh_data {args.mesh_data} serves over "
                             f"{shards} processes, but the world has "
                             f"{world}")
        tag = tag_from_checkpoint_path(args.model)
        cfg = parse_tag(tag)
        state, _ = load_any(
            args.model, {"params": init_params(cfg.model, device="meta")},
            device=device)
        params = state["params"]
        mesh = make_mesh(shards, 1, device=device) if shards > 1 else None
        artifact = load_artifact(args.artifact) if args.artifact else None
        service = VocoderService(params, cfg.model, artifact=artifact,
                                 temperature_default=args.temperature,
                                 frame_bucket=args.frame_bucket,
                                 frames_per_push=args.frames_per_push,
                                 max_batch=args.max_batch,
                                 linger_ms=args.linger_ms,
                                 max_streams=args.max_streams, name=tag,
                                 mux_lanes=args.mux_lanes, mesh=mesh)
        try:
            if mesh is not None and mesh.data_index > 0:
                follow(service)
            else:
                _serve(service, args, tag, device)
        finally:
            service.close()
    finally:
        if made_group:
            dist.destroy_process_group()


def _serve(service, args, tag, device) -> None:
    """Rank 0 (or the one process): the HTTP front until SIGINT or
    SIGTERM, or until the serving mesh fails (then raise)."""
    from msnv_tpu_torch.serving.aio import make_async_server
    from msnv_tpu_torch.serving.httpd import make_server

    max_body = int(args.max_body_mb * (1 << 20))
    if args.frontend == "aio":
        server = make_async_server(service, args.host, args.port,
                                   timeout_s=args.timeout_s,
                                   max_body=max_body)
        server.start()
        serve, stop = server._thread.join, server.shutdown
    else:
        server = make_server(service, args.host, args.port,
                             timeout_s=args.timeout_s, max_body=max_body)
        serve, stop = server.serve_forever, server.server_close
    if service._channel is not None:
        # a failed mesh stops the front from whichever thread saw it
        service._channel.on_failure = lambda e: threading.Thread(
            target=server.shutdown, daemon=True).start()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _interrupt)
    print(f"serving {tag} on http://{args.host}:"
          f"{server.server_address[1]} ({device}, {args.frontend} "
          f"front-end, mesh shards {service._mesh_shards})", flush=True)
    try:
        serve()
    except KeyboardInterrupt:
        pass
    finally:
        stop()
    if service._channel is not None and service._channel.failed:
        raise RuntimeError("the serving mesh failed") from \
            service._channel.failed


if __name__ == "__main__":
    main()
