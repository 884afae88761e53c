"""Render the EMA-against-raw AP table from a training run's
metrics.jsonl — counterpart of ``tools/misc/ema_ab_table.py``, with the
same output.

The EMA on/off A/B runs as ONE training run: with ``python -m
yunet_tpu_torch.tools.train --eval-both-params`` every in-training eval
scores both the EMA shadow and the raw optimizer params. The EMA shadow
never feeds back into the update, so the raw columns ARE the no-EMA
trajectory: same batches, same seeds, no confounds.

  python -m yunet_tpu_torch.tools.ema_ab_table \\
      work_dirs/rehearsal/metrics.jsonl --markdown

Host only (json and print); no device.
"""

from __future__ import annotations

import argparse
import json
import sys


def load_val_records(path: str):
    recs = []
    with open(path) as f:
        for ln in f:
            try:
                r = json.loads(ln)
            except json.JSONDecodeError:
                continue  # truncated line from a killed run
            if r.get("mode") == "val" and "raw_hard" in r:
                recs.append(r)
    # auto-resume replays steps; keep the LAST record per step
    by_step = {r["step"]: r for r in recs}
    return [by_step[s] for s in sorted(by_step)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("metrics", help="metrics.jsonl with --eval-both-params "
                    "val records")
    ap.add_argument("--markdown", action="store_true",
                    help="emit a GitHub-markdown table")
    args = ap.parse_args(argv)

    recs = load_val_records(args.metrics)
    if not recs:
        print("no --eval-both-params val records found", file=sys.stderr)
        return 1

    sep = " | " if args.markdown else "  "
    edge = "| " if args.markdown else ""
    cols = ["step", "EMA easy", "EMA med", "EMA hard",
            "raw easy", "raw med", "raw hard", "hard Δ(EMA-raw)"]
    print(edge + sep.join(cols) + (" |" if args.markdown else ""))
    if args.markdown:
        print("|" + "|".join(["---"] * len(cols)) + "|")
    for r in recs:
        row = [str(r["step"])] + [
            f"{r[k]:.4f}" for k in ("easy", "medium", "hard",
                                    "raw_easy", "raw_medium", "raw_hard")
        ] + [f"{r['hard'] - r['raw_hard']:+.4f}"]
        print(edge + sep.join(row) + (" |" if args.markdown else ""))

    last = recs[-1]
    d = last["hard"] - last["raw_hard"]
    winner = "EMA" if d > 0 else "raw (no-EMA)"
    print(f"\nendpoint (step {last['step']}): hard EMA {last['hard']:.4f} "
          f"vs raw {last['raw_hard']:.4f} -> {winner} by {abs(d):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
