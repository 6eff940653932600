"""CLI: check exported Chrome trace files against the span contract.

    python -m repro_torch.obs.validate DIR/*.trace.json [--require-spec]
    python -m repro_torch.obs.validate DIR/*.trace.json --train

Exit 0 when every file parses as a trace-event document and every
completed request carries its queue, prefill and decode spans (and, with
``--require-spec``, a spec span); exit 1 otherwise. ``--train`` checks
the training-trace contract instead: ``train_step`` spans and the
required ``numerics/*`` counter tracks. The documents are those of the
JAX package, so either package's exports pass either validator.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.numerics import validate_train_trace
from repro_torch.obs.spans import validate_chrome_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="exported *.trace.json files")
    ap.add_argument("--require-spec", action="store_true",
                    help="completed requests must also carry spec spans")
    ap.add_argument("--train", action="store_true",
                    help="check the training-trace contract (train_step "
                         "spans and numerics counter tracks)")
    args = ap.parse_args(argv)
    status = 0
    for path in args.paths:
        try:
            with open(path) as f:
                doc = json.load(f)
            if args.train:
                info = validate_train_trace(doc)
            else:
                per_request = validate_chrome_trace(
                    doc, require_spec=args.require_spec)
        except (OSError, ValueError) as e:  # JSONDecodeError is a ValueError
            print(f"[obs] FAIL {path}: {e}")
            status = 1
            continue
        if args.train:
            print(f"[obs] ok {path}: {info['steps']} train steps, "
                  f"{info['counter_events']} counter events over "
                  f"{len(info['tracks'])} tracks ({info['series']} series)")
        else:
            spans = sum(sum(v.values()) for v in per_request.values())
            print(f"[obs] ok {path}: {len(per_request)} completed requests, "
                  f"{spans} request spans, "
                  f"{len(doc['traceEvents'])} events")
    return status


if __name__ == "__main__":
    sys.exit(main())
