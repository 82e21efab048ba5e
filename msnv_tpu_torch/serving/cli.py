"""`msnv-serve-torch` CLI: serve a JAX-trainer checkpoint over HTTP."""

from __future__ import annotations


def main(argv=None):
    """CLI: serve a checkpoint.

    python -m msnv_tpu_torch.serving \
        --model results/<tag>/checkpoints/ep...npz \
        [--host 0.0.0.0] [--port 8000] [--temperature 1.0] [--device cuda]
        [--mux_lanes N] [--frontend {aio,threaded}] [--artifact a.msnvt]

    The experiment tag (the results directory name) rebuilds the config;
    the `.npz` is read with numpy alone (msnv_tpu_torch/interop.py).
    """
    import argparse

    from msnv_tpu_torch.config import parse_tag, tag_from_checkpoint_path
    from msnv_tpu_torch.export import load_artifact
    from msnv_tpu_torch.interop import load_npz_params
    from msnv_tpu_torch.serving.aio import make_async_server
    from msnv_tpu_torch.serving.httpd import make_server
    from msnv_tpu_torch.serving.service import VocoderService

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
                   help="multi-device serving: not ported yet (raises)")
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
    if args.mesh_data > 1:
        raise NotImplementedError(
            "multi-device serving (--mesh_data) is not ported yet (ROADMAP "
            "queue 1, item 7.4)")

    tag = tag_from_checkpoint_path(args.model)
    cfg = parse_tag(tag)
    params = load_npz_params(args.model, cfg.model, device=args.device)
    artifact = load_artifact(args.artifact) if args.artifact else None
    service = VocoderService(params, cfg.model, artifact=artifact,
                             temperature_default=args.temperature,
                             frame_bucket=args.frame_bucket,
                             frames_per_push=args.frames_per_push,
                             max_batch=args.max_batch,
                             linger_ms=args.linger_ms,
                             max_streams=args.max_streams, name=tag,
                             mux_lanes=args.mux_lanes)
    max_body = int(args.max_body_mb * (1 << 20))
    try:
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
        device = params["mlp"]["embedding"].device
        print(f"serving {tag} on http://{args.host}:"
              f"{server.server_address[1]} ({device}, {args.frontend} "
              f"front-end)", flush=True)
        try:
            serve()
        finally:
            stop()
    finally:
        service.close()


if __name__ == "__main__":
    main()
