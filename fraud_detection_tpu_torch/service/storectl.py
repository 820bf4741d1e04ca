"""Operator CLI for the network store tier.

The port's own copy of the JAX package's ``service/storectl.py``; it talks
to the store servers and sentinels of either package.

The ``redis-cli``/``pg_isready`` analogue for this build's store servers and
sentinels (netserver.py, sentinel.py): one-shot commands over the framed-JSON
protocol, authenticated via ``FRAUD_STORE_TOKEN`` like every other client.

Commands:

- ``ping host:port``      — exit 0 when the server answers (container
  healthchecks: ``python -m fraud_detection_tpu_torch.service.storectl ping
  store-primary:7600``);
- ``info host:port``      — print the server's info JSON (role, seq,
  replication depth, queue depth);
- ``get-master host:port [name]`` — ask a sentinel for the current primary;
- ``promote host:port``   — manual promotion (runbook escape hatch; normal
  failover is the sentinels' job);
- ``demote host:port primary-host:port`` — manual demote/re-point.
"""

from __future__ import annotations

import argparse
import json
import sys

from fraud_detection_tpu_torch.service.sentinel import _call
from fraud_detection_tpu_torch.service.wire import parse_hostport


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=["ping", "info", "get-master", "promote", "demote"])
    ap.add_argument("endpoint", help="host:port of a store server or sentinel")
    ap.add_argument("arg", nargs="?", default=None,
                    help="master name (get-master) or primary host:port (demote)")
    ap.add_argument("--timeout", type=float, default=2.0)
    args = ap.parse_args(argv)
    ep = parse_hostport(args.endpoint, 7600)
    try:
        if args.command == "ping":
            result = _call(ep, "ping", timeout=args.timeout)
        elif args.command == "info":
            result = _call(ep, "info", timeout=args.timeout)
        elif args.command == "get-master":
            result = _call(
                ep, "s.get-master", timeout=args.timeout,
                name=args.arg or "mymaster",
            )
        elif args.command == "promote":
            result = _call(ep, "promote", timeout=args.timeout)
        else:  # demote
            if not args.arg:
                print("demote requires the new primary's host:port", file=sys.stderr)
                return 2
            result = _call(
                ep, "demote", timeout=args.timeout, replicate_from=args.arg
            )
    except OSError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
