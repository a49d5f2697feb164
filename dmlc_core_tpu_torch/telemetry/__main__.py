"""CLI: ``python -m dmlc_core_tpu_torch.telemetry {report,trace} <dir> [...]``.

Counterpart of ``dmlc_core_tpu/telemetry/__main__.py`` (a copy).
"""

from __future__ import annotations

import argparse
import sys

from dmlc_core_tpu_torch.telemetry import report, traceview


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.telemetry",
        description="telemetry snapshot tooling")
    sub = parser.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser(
        "report", help="aggregate rank snapshots from a DMLC_TELEMETRY_DIR")
    rep.add_argument("dir", help="directory holding metrics-*.json snapshots")
    rep.add_argument("--json", action="store_true",
                     help="emit the merged result as JSON instead of a table")
    tr = sub.add_parser(
        "trace", help="assemble per-process span files + flight dumps into "
                      "one merged trace; critical path per trace_id")
    tr.add_argument("dir", help="directory holding trace-*.trace.json / "
                                "flight-*.json files")
    tr.add_argument("--out", default=None,
                    help="write the merged Perfetto trace JSON here")
    tr.add_argument("--json", action="store_true",
                    help="emit the assembly report as JSON")
    tr.add_argument("--top", type=int, default=10,
                    help="slowest-traces table length (default 10)")
    tr.add_argument("--fail-on-orphans", action="store_true",
                    help="exit 2 when any span's recorded parent is missing "
                         "from the merged set (the CI propagation gate)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "report":
        return report.main(args.dir, as_json=args.json)
    if args.cmd == "trace":
        return traceview.main(args.dir, out=args.out, as_json=args.json,
                              top=args.top,
                              fail_on_orphans=args.fail_on_orphans)
    return 2


if __name__ == "__main__":
    sys.exit(main())
