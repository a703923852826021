"""Training-log parser — the tools/extra/parse_log.py analog
(caffe/tools/extra/parse_log.py): extracts per-iteration scalars from
stderr.log / console logs into CSV for plotting. The port's copy of
``smallhardface_tpu/tools/parse_log.py``; it reads either package's logs
(both write the same "iter" line and the ``__main__.LOG_DATEFMT`` stamp).

Usage: python -m smallhardface_tpu_torch.tools.parse_log stderr.log [out.csv]
       python -m smallhardface_tpu_torch.tools.parse_log --buckets stderr.log

`--buckets` summarizes a multi-scale run: per-bucket line counts/shares
and the windowed iter/s trajectory (incremental rate between consecutive
log lines). Each log line reports the bucket of its LAST iteration only,
so windowed rates mix buckets when consecutive steps switch.
"""

from __future__ import annotations

import csv
import json
import re
import sys
from datetime import datetime

LINE_RE = re.compile(
    r"iter (\d+)/(\d+) cls_loss: ([\d.eE+-]+) reg_loss: ([\d.eE+-]+) "
    r"(?:smoothed_loss: ([\d.eE+-]+) )?"
    r"accuracy: ([\d.eE+-]+) lr: ([\d.eE+-]+)"
    r"(?: bucket: (\([^)]*\)))?"
    r".*?speed: ([\d.eE+-]+) iter/s")

# "08-20-2026:04:19:00,203" — the stderr.log stamp.
TS_RE = re.compile(r"^(\d{2}-\d{2}-\d{4}:\d{2}:\d{2}:\d{2},\d+)")


def _wall_ts(line):
    m = TS_RE.match(line)
    if not m:
        return None
    return datetime.strptime(m.group(1), "%m-%d-%Y:%H:%M:%S,%f").timestamp()


def parse(path):
    rows = []
    with open(path) as f:
        for line in f:
            m = LINE_RE.search(line)
            if m:
                (it, total, cls_l, reg_l, smoothed, acc, lr, bucket,
                 speed) = m.groups()
                rows.append({
                    "iteration": int(it),
                    "cls_loss": float(cls_l),
                    "reg_loss": float(reg_l),
                    "total_loss": float(cls_l) + float(reg_l),
                    "smoothed_loss": (float(smoothed) if smoothed
                                      else float(cls_l) + float(reg_l)),
                    "accuracy": float(acc),
                    "lr": float(lr),
                    "bucket": bucket or "",
                    "speed_iter_per_s": float(speed),
                    "wall_ts": _wall_ts(line),
                })
    return rows


def bucket_summary(rows):
    """Per-bucket counts + the windowed iter/s trajectory."""
    per = {}
    windows = []
    for prev, cur in zip(rows, rows[1:]):
        d_it = cur["iteration"] - prev["iteration"]
        if (cur["wall_ts"] is not None and prev["wall_ts"] is not None
                and d_it > 0):
            dt = cur["wall_ts"] - prev["wall_ts"]
            if dt > 0:
                windows.append({"iteration": cur["iteration"],
                                "bucket": cur["bucket"],
                                "iter_per_s": d_it / dt})
    for r in rows:
        b = r["bucket"] or "(unlabelled)"
        per.setdefault(b, 0)
        per[b] += 1
    n = max(len(rows), 1)
    tail = [w["iter_per_s"] for w in windows[len(windows) // 2:]]
    tail.sort()
    return {
        "lines": len(rows),
        "buckets": {b: {"lines": c, "share": round(c / n, 4)}
                    for b, c in sorted(per.items())},
        "windowed_iter_per_s": windows,
        "steady_state_iter_per_s": (
            tail[len(tail) // 2] if tail else None),
    }


def main():
    argv = sys.argv[1:]
    buckets = "--buckets" in argv
    argv = [a for a in argv if a != "--buckets"]
    if not argv:
        print(__doc__)
        sys.exit(1)
    rows = parse(argv[0])
    if buckets:
        s = bucket_summary(rows)
        # trajectory is bulky — print the summary with a thinned tail
        s["windowed_iter_per_s"] = s["windowed_iter_per_s"][-12:]
        print(json.dumps(s, indent=1))
        return
    out = argv[1] if len(argv) > 1 else None
    fields = ["iteration", "cls_loss", "reg_loss", "total_loss",
              "smoothed_loss", "accuracy", "lr", "bucket",
              "speed_iter_per_s"]
    fp = open(out, "w", newline="") if out else sys.stdout
    writer = csv.DictWriter(fp, fieldnames=fields, extrasaction="ignore")
    writer.writeheader()
    writer.writerows(rows)
    if out:
        fp.close()
        print(f"wrote {len(rows)} rows to {out}")


if __name__ == "__main__":
    main()
