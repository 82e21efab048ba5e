"""`msnv-serve-torch` CLI: serve a JAX-trainer checkpoint over HTTP."""

from __future__ import annotations


def main(argv=None):
    """CLI: serve a checkpoint.

    python -m msnv_tpu_torch.serving \
        --model results/<tag>/checkpoints/ep...npz \
        [--host 0.0.0.0] [--port 8000] [--temperature 1.0] [--device cuda]

    The experiment tag (the results directory name) rebuilds the config;
    the `.npz` is read with numpy alone (msnv_tpu_torch/interop.py).
    """
    import argparse

    from msnv_tpu_torch.config import parse_tag, tag_from_checkpoint_path
    from msnv_tpu_torch.interop import load_npz_params
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
    p.add_argument("--frontend", choices=("threaded",), default="threaded",
                   help="HTTP front-end: stdlib thread-per-connection "
                        "(the selector-based front-end is not ported yet)")
    p.add_argument("--timeout_s", type=float, default=60.0,
                   help="per-connection socket read/write timeout")
    p.add_argument("--max_body_mb", type=float, default=64.0,
                   help="request body size cap (413 beyond it)")
    p.add_argument("--frame_bucket", type=int, default=16,
                   help="pad request frame counts to this multiple")
    args = p.parse_args(argv)

    tag = tag_from_checkpoint_path(args.model)
    cfg = parse_tag(tag)
    params = load_npz_params(args.model, cfg.model, device=args.device)
    service = VocoderService(params, cfg.model,
                             temperature_default=args.temperature,
                             frame_bucket=args.frame_bucket,
                             frames_per_push=args.frames_per_push,
                             max_batch=args.max_batch,
                             linger_ms=args.linger_ms,
                             max_streams=args.max_streams, name=tag)
    server = make_server(service, args.host, args.port,
                         timeout_s=args.timeout_s,
                         max_body=int(args.max_body_mb * (1 << 20)))
    print(f"serving {tag} on http://{args.host}:"
          f"{server.server_address[1]} ({params['mlp']['embedding'].device})",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
