"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, traced also
``breakdown``; the numbers compared with their limits last, under
``checks``); the last lines of standard error give the same numbers beside
their limits. Without a card, or with fewer than the cell needs, it exits 3
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def result_line(result: dict) -> str:
    """The result as one JSON line, with ``checks`` its last key."""
    out = {k: v for k, v in result.items() if k != "checks"}
    out["checks"] = result["checks"]
    return json.dumps(out)


def check_lines(result: dict) -> list:
    """The numbers compared, each beside its limit, one a line."""
    return [f"check {k} {v['value']} limit {v['limit']}" for k, v in result["checks"].items()]


def main(argv=None) -> int:
    started = harness.process_start()
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             started=started)
    except harness.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    except Exception:  # noqa: BLE001 - any fault ends the run without a result
        traceback.print_exc()
        return 1
    sys.stderr.flush()
    print(result_line(result), flush=True)
    print("\n".join(check_lines(result)), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
