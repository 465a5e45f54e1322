"""Archive analytics: grouped time series over archived runs.

Counterpart of the reference's largest client subsystem — the archive
stats/chart engine (sphereisaiahmin-dev/sph-pie `public/app.js:2082-4167`:
per-show stats, daily groups keyed by date midpoints, per-metric series
with filters, day-detail drilldown) — computed server-side over archived
run records. The browser gets ready-to-plot series instead of re-deriving
them per tab.
"""

from __future__ import annotations

from sph_pie_torch.service.metrics import aggregate_run_stats

# Metric definitions: key -> how to extract a per-run scalar from its
# aggregated stats (the ARCHIVE_METRIC_DEFS analogue, public/app.js:21-86).
METRIC_DEFS = {
    "runs": lambda run, stats: 1,
    "samples": lambda run, stats: stats.get("samples", 0),
    "kinetic_energy_avg": lambda run, stats: stats.get("kinetic_energy_avg"),
    "kinetic_energy_max": lambda run, stats: stats.get("kinetic_energy_max"),
    "max_speed": lambda run, stats: stats.get("max_speed_max"),
    "mean_density_avg": lambda run, stats: stats.get("mean_density_avg"),
    "max_density": lambda run, stats: stats.get("max_density_max"),
    "n_active_max": lambda run, stats: stats.get("n_active_max"),
    "momentum_drift": lambda run, stats: (
        abs(stats.get("momentum_x_max", 0) - stats.get("momentum_x_min", 0))
        if stats.get("samples")
        else None
    ),
}


def run_stats(run: dict) -> dict:
    """Per-run stat block (computeArchiveShowStats analogue)."""
    stats = aggregate_run_stats(run.get("steps", []))
    return {
        "id": run.get("id"),
        "name": run.get("name"),
        "scene": run.get("scene"),
        "runDate": run.get("runDate"),
        "stats": stats,
        "metrics": {
            k: fn(run, stats) for k, fn in METRIC_DEFS.items()
        },
    }


def _matches(run: dict, scenes=None, operators=None, date_from=None, date_to=None):
    if scenes and run.get("scene") not in scenes:
        return False
    if operators:
        ops = {s.get("operator") for s in run.get("steps", [])}
        if not (set(operators) & ops):  # intersection semantics (app.js:3262)
            return False
    d = run.get("runDate", "")
    if date_from and d < date_from:
        return False
    if date_to and d > date_to:
        return False
    return True


def daily_series(
    archived_runs: list[dict],
    metrics: list[str] | None = None,
    scenes: list[str] | None = None,
    operators: list[str] | None = None,
    date_from: str | None = None,
    date_to: str | None = None,
) -> dict:
    """Per-date grouped metric series with filters.

    Returns {dates: [...], series: {metric: [value-per-date]},
    groups: {date: {runs, per-run stats}}}. Averages within a date group
    (sum for counters) — the buildArchiveDailyGroups analogue.
    """
    metrics = [m for m in (metrics or list(METRIC_DEFS)) if m in METRIC_DEFS]
    filtered = [
        r
        for r in archived_runs
        if _matches(r, scenes, operators, date_from, date_to)
    ]
    groups: dict[str, list[dict]] = {}
    for r in filtered:
        groups.setdefault(r.get("runDate", ""), []).append(run_stats(r))
    dates = sorted(groups)
    series: dict[str, list] = {m: [] for m in metrics}
    for d in dates:
        rows = groups[d]
        for m in metrics:
            vals = [r["metrics"].get(m) for r in rows]
            vals = [v for v in vals if isinstance(v, (int, float))]
            if not vals:
                series[m].append(None)
            elif m in ("runs", "samples"):
                series[m].append(sum(vals))
            else:
                series[m].append(sum(vals) / len(vals))
    return {
        "dates": dates,
        "series": series,
        "groups": {d: groups[d] for d in dates},
        "totalRuns": len(filtered),
    }
