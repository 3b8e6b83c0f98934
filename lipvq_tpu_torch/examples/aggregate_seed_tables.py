"""Aggregate per-seed suite success tables into mean +/- range rows (the
port's twin of the JAX package's ``examples/aggregate_seed_tables.py``: the
same rows from the same ``success_table.json`` files).

Round-4's headline tables were single training seeds with demonstrated
+/-0.4/task retrain variance (VERDICT r4 weak #1); round-5 headline
claims are made over >=3 seeds via this aggregator.

    python -m lipvq_tpu_torch.examples.aggregate_seed_tables \
        /tmp/suite_dwell_big/success_table.json \
        /tmp/r5_s2/success_table.json /tmp/r5_s3/success_table.json
"""

from __future__ import annotations

import json
import sys


def main(paths):
    tables = []
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        tables.append((p, d.get("train_seed", "?"), d["per_task"],
                       d.get("mean")))
    tasks = sorted(set.intersection(*(set(t[2]) for t in tables)))
    print(f"{'task':24s} " + " ".join(f"{'s' + str(t[1]):>5}"
                                      for t in tables) + "   mean  range")
    pooled = []
    for task in tasks:
        vals = [t[2][task] for t in tables]
        mean = sum(vals) / len(vals)
        rng = max(vals) - min(vals)
        pooled.append(mean)
        print(f"{task:24s} " + " ".join(f"{v:5.2f}" for v in vals)
              + f"   {mean:.3f}  {rng:.2f}")
    means = [sum(t[2][k] for k in tasks) / len(tasks) for t in tables]
    gmean = sum(means) / len(means)
    print(f"{'MEAN':24s} " + " ".join(f"{m:5.3f}" for m in means)
          + f"   {gmean:.3f}  {max(means) - min(means):.2f}")
    out = {
        "seeds": [t[1] for t in tables],
        "per_task": {k: {"values": [t[2][k] for t in tables]}
                     for k in tasks},
        "per_seed_mean": means,
        "pooled_mean": gmean,
        "mean_range": max(means) - min(means),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
