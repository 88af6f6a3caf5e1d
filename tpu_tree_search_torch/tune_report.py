"""Render a tuning-cache directory (`tune/cache.TuningCache`) as a table.

Port of `tools/tune_report.py`: one row per entry (the tuning key, the
winning chunk and balance period, the measured evals/s, the probe count
and sweep seconds, and the fingerprint the entry is pinned to), and the
quarantined `*.corrupt` files listed below. It reads entries of either
package through `tune/cache.decode`, so an entry the tuner would
quarantine (bad magic, truncated, a CRC mismatch) is an UNREADABLE row;
it checks no fingerprint: it is a report, not a consumer.

    python -m tpu_tree_search_torch.tune_report <cache-dir>
    python -m tpu_tree_search_torch.tune_report <cache-dir> --json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .tune.cache import QUARANTINE_SUFFIX, decode


def read_entry(path: str) -> dict:
    """One entry's header and payload (`cache.decode`: magic, length and
    CRC checked), or an {"error": ...} row for a damaged file."""
    try:
        with open(path, "rb") as f:
            header, payload = decode(f.read())
        return {"file": os.path.basename(path), "header": header,
                "payload": payload}
    except Exception as e:  # noqa: BLE001 — a torn entry is a row
        return {"file": os.path.basename(path), "error": repr(e)}


def render(entries: list[dict], corrupt: list[str]) -> str:
    lines = ["# Tuning cache", "",
             f"{len(entries)} entr(y/ies), {len(corrupt)} quarantined",
             "",
             "| key | chunk | balance_period | evals/s | probes | "
             "sweep_s | platform | devices |",
             "|---|---|---|---|---|---|---|---|"]
    for e in entries:
        if "error" in e:
            lines.append(f"| {e['file']} | - | - | - | - | - | "
                         f"UNREADABLE: {e['error']} | - |")
            continue
        hdr, pay = e["header"], e["payload"]
        fp = hdr.get("fingerprint") or {}
        rate = pay.get("evals_per_s")
        rate_s = (f"{rate:.4g}" if isinstance(rate, (int, float))
                  else "-")
        lines.append(
            f"| {hdr.get('key') or e['file']} | {pay.get('chunk')} "
            f"| {pay.get('balance_period')} | {rate_s} "
            f"| {len(pay.get('probes') or [])} "
            f"| {pay.get('sweep_seconds', '-')} "
            f"| {fp.get('platform', '-')} "
            f"| {fp.get('device_count', '-')}x"
            f"{'/'.join(fp.get('device_kinds') or ['-'])} |")
    if corrupt:
        lines += ["", "Quarantined (never loaded):"]
        lines += [f"- {c}" for c in corrupt]
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render a tune/cache.TuningCache directory")
    ap.add_argument("cache_dir")
    ap.add_argument("--json", action="store_true",
                    help="dump the parsed entries as JSON")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.cache_dir):
        print(f"error: {args.cache_dir} is not a directory",
              file=sys.stderr)
        return 2
    names = sorted(os.listdir(args.cache_dir))
    entries = [read_entry(os.path.join(args.cache_dir, n))
               for n in names if n.endswith(".tune")]
    corrupt = [n for n in names if n.endswith(QUARANTINE_SUFFIX)]
    if args.json:
        print(json.dumps({"entries": entries, "quarantined": corrupt},
                         indent=1))
    else:
        print(render(entries, corrupt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
