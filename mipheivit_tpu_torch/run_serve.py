"""Online inference daemon on PyTorch: serve a trained generator over HTTP
(the root ``run_serve.py`` on the port).

Usage:
  python -m mipheivit_tpu_torch.run_serve --checkpoint_dir D [--port 8000]
         [--batch_size 32] [--tile_size 256] [--max_delay_ms 5] [--dtype bfloat16]
         [--device cuda]

Reads ``D/config.yaml`` (the resolved run config saved beside the
checkpoint) like the other drivers. Concurrent requests are micro-batched
into fixed-shape device batches (``infer/serve.py``). Runs on the card
unless ``--device cpu`` is given; without a card it raises.

  POST /v1/predict   .npy uint8 [H,W,3] H&E tile -> .npy uint8 [H,W,C] mIF
  GET  /healthz      readiness (model warmed up)
  GET  /stats        latency percentiles + batch occupancy
"""

import argparse
import logging


def main(argv=None) -> None:
    from .infer import TileServer

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", default=8000, type=int)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--tile_size", default=256, type=int)
    parser.add_argument("--max_delay_ms", default=5.0, type=float,
                        help="max time the oldest request waits for the "
                             "batch to fill before a partial batch runs")
    parser.add_argument("--dtype", default=None,
                        help="compute dtype (default: bfloat16 on the card, float32 on the CPU)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without a card, "
                             "pass cpu to run on the CPU)")
    args = parser.parse_args(argv)

    server = TileServer.from_checkpoint(
        args.checkpoint_dir, tile_size=args.tile_size,
        batch_size=args.batch_size, max_delay_ms=args.max_delay_ms,
        host=args.host, port=args.port, dtype=args.dtype, device=args.device)
    server.serve_forever()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
