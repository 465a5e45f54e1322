"""Run export: CSV / JSON serialisation of recorded metrics.

Counterpart of the reference's client-side export path
(sphereisaiahmin-dev/sph-pie `public/app.js:4156-4167, 5558-5580`,
EXPORT_COLUMNS discipline), done server-side.
"""

from __future__ import annotations

import json

from sph_pie_torch.service.metrics import METRIC_COLUMNS, aggregate_run_stats
from sph_pie_torch.service.webhook import build_csv


def run_to_csv(run: dict) -> str:
    rows = [
        [s.get(c, "") for c in METRIC_COLUMNS]
        for s in sorted(run.get("steps", []), key=lambda s: s.get("step", 0))
    ]
    return build_csv(METRIC_COLUMNS, rows)


def run_to_json(run: dict) -> str:
    doc = dict(run)
    doc["stats"] = aggregate_run_stats(run.get("steps", []))
    return json.dumps(doc, indent=2, sort_keys=True)
