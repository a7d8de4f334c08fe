"""Re-derive ``parsed`` and ``collectives`` of the dry-run's records from
their saved op logs, with no retrace. Run after changing the accounting
rules of ``launch/hlo_analysis.py``:

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [--out DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import ARTIFACT_DIR, load_log
from repro_torch.launch.hlo_analysis import (collective_stats,
                                             hlo_compute_stats)


def reanalyze(out_dir: str = ARTIFACT_DIR) -> tuple:
    """(records updated, records without an op log)."""
    updated = missing = 0
    for jpath in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        lpath = jpath[:-len(".json")] + ".ops.jsonl.gz"
        with open(jpath) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        if not os.path.exists(lpath):
            missing += 1
            continue
        log = load_log(lpath)
        rec["parsed"] = hlo_compute_stats(log)
        rec["collectives"] = collective_stats(log)
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        updated += 1
    return updated, missing


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=ARTIFACT_DIR)
    updated, missing = reanalyze(ap.parse_args(argv).out)
    print(f"updated {updated}, missing op log for {missing}")


if __name__ == "__main__":
    main()
