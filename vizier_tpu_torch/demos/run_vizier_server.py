"""Standalone Vizier server demo: starts the port's DefaultVizierServer and blocks.

The port's counterpart of the JAX package's ``demos/run_vizier_server.py``.

Usage::

  python -m vizier_tpu_torch.demos.run_vizier_server [--host localhost]
      [--port 28080] [--database_url sqlite:////tmp/vizier.db]
      [--platform cuda|cpu] [--seconds N]

The server's designers run on ``--platform`` (``cuda`` by default, which
needs a GPU). ``--seconds`` stops the server after N seconds (0: serve until
interrupted).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--database_url", default=None)
    parser.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--seconds", type=float, default=0.0)
    args = parser.parse_args(argv)

    from vizier_tpu_torch.service.vizier_server import DefaultVizierServer

    server = DefaultVizierServer(
        host=args.host, port=args.port, database_url=args.database_url, device=args.platform
    )
    print(f"Vizier server listening at {server.endpoint}", flush=True)
    try:
        if args.seconds > 0:
            time.sleep(args.seconds)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop(0)


if __name__ == "__main__":
    main()
