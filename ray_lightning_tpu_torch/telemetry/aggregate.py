"""Fleet aggregation: merge the ranks' telemetry snapshots on the driver
(``ray_lightning_tpu/telemetry/aggregate.py``, copied).

Every worker's snapshot rides its result package; the driver merges them
into ``Trainer.telemetry_report``: min/max/mean views across the ranks,
whose *skew* is the straggler signal.
"""

from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["merge_snapshots"]

def _summable(name: str) -> bool:
    """Whether a cross-rank ``sum`` view makes sense for a counter.
    Every ``grad_sync_*`` stat is an analytic per-device constant
    (bytes, ratio, buckets, block size, devices) — identical on every
    rank, so a sum would misread as a fleet total."""
    return not name.startswith("grad_sync_")


def _stat_view(values: List[float]) -> Dict[str, float]:
    mean = sum(values) / len(values)
    view = {
        "min": min(values),
        "max": max(values),
        "mean": mean,
    }
    if mean:
        # Relative spread across ranks: the straggler metric.
        view["skew_pct"] = 100.0 * (view["max"] - view["min"]) / abs(mean)
    return view


def merge_snapshots(snapshots: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-rank snapshots into the driver-side telemetry report.

    Numeric ``step_stats`` keys and counters get min/max/mean(+skew)
    views; non-numeric metadata (tier, modes) is taken from rank 0.
    ``per_rank`` keeps the raw snapshots — they are small dicts, and the
    report must let a human drill from "rank skew 40%" to "which rank".
    """
    snaps = [s for s in snapshots if s]
    if not snaps:
        return {}
    snaps = sorted(snaps, key=lambda s: s.get("rank", 0))
    report: Dict[str, Any] = {
        "world_size": len(snaps),
        "tier": snaps[0].get("tier"),
        "per_rank": snaps,
    }

    def merge_numeric(section: str, pad_missing: bool = False):
        keys: Dict[str, List[float]] = {}
        for s in snaps:
            for k, v in (s.get(section) or {}).items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                keys.setdefault(k, []).append(float(v))
        out = {}
        for k, vals in keys.items():
            if len(vals) < len(snaps):
                if not pad_missing:
                    continue  # only fleet-complete metrics
                # Rank-0-only counters (checkpoint_writes — file I/O is
                # rank-guarded) and subset events (nonfinite_logs on the
                # one poisoned rank) must SURVIVE the merge: a missing
                # rank contributed zero, it didn't opt out.
                vals = vals + [0.0] * (len(snaps) - len(vals))
            view = _stat_view(vals)
            if len(keys[k]) < len(snaps):
                view["ranks_reporting"] = len(keys[k])
            out[k] = view
        return out

    report["step_stats"] = merge_numeric("step_stats")
    counters = merge_numeric("counters", pad_missing=True)
    for name, view in counters.items():
        if _summable(name):
            view["sum"] = view["mean"] * len(snaps)
    report["counters"] = counters
    meta = snaps[0].get("meta") or {}
    if meta:
        report["meta"] = dict(meta)
    # Non-numeric step_stats fields fall out of the min/max/mean merge
    # above; the MFU basis ("analytic" vs "measured") is the one a
    # report reader needs to interpret the mfu view, so it rides meta.
    basis = (snaps[0].get("step_stats") or {}).get("mfu_basis")
    if basis:
        report.setdefault("meta", {})["mfu_basis"] = basis
    return report
