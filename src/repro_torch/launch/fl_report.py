"""Render a telemetry JSONL trace into a straggler/health report: the
port's twin of the reference's ``scripts/fl_report.py``, with the same
flags, exit codes and messages, importing neither JAX nor ``repro``.

Consumes the per-round RoundRecord lines written by ``fl_train
--metrics-out`` (or any ``repro_torch.obs.sinks.JsonlSink``), validates
every line against the schema, and renders the markdown report from
``repro_torch.obs.report``.

  PYTHONPATH=src python -m repro_torch.launch.fl_report run.jsonl
  PYTHONPATH=src python -m repro_torch.launch.fl_report run.jsonl \
      --out report.md
  PYTHONPATH=src python -m repro_torch.launch.fl_report run.jsonl \
      --validate --expect-rounds 64     # schema + row count only

Exits non-zero when a line fails schema validation or --expect-rounds
does not match.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.report import render_report
from repro_torch.obs.schema import SchemaError, read_jsonl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="telemetry JSONL file (fl_train "
                                 "--metrics-out)")
    ap.add_argument("--out", default=None,
                    help="write the report here instead of stdout")
    ap.add_argument("--validate", action="store_true",
                    help="validate only (schema + --expect-rounds); no "
                         "report is rendered")
    ap.add_argument("--expect-rounds", type=int, default=None,
                    help="fail unless exactly this many round records are "
                         "present")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the least-reliable-clients table")
    args = ap.parse_args(argv)

    try:
        meta, records = read_jsonl(args.path)
    except SchemaError as e:
        print(f"fl_report: INVALID — {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"fl_report: cannot read {args.path}: {e}", file=sys.stderr)
        return 1

    if args.expect_rounds is not None and len(records) != args.expect_rounds:
        print(f"fl_report: INVALID — expected {args.expect_rounds} round "
              f"records, found {len(records)}", file=sys.stderr)
        return 1
    if args.validate:
        print(f"fl_report: OK — {len(records)} valid round records"
              + (f", meta keys {sorted(meta)}" if meta else ""))
        return 0

    report = render_report(meta, records, top=args.top)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report)
        print(f"fl_report: wrote {args.out} ({len(records)} rounds)")
    else:
        sys.stdout.write(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
