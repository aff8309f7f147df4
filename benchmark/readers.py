"""Helpers the metric readers share: a layer's seconds or count a job,
averaged over the jobs of the window that reached it, and the route a
``rem`` job took."""

from __future__ import annotations

# the modules whose LAST_STATS tell rem's route (a reader that filters by
# route names them in its STATS)
ROUTE_STATS = ("reveal_tpu_torch.index.devloop",
               "reveal_tpu_torch.index.devloop_multi",
               "reveal_tpu_torch.index.devfrontier")


def mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def span_mean(run, label):
    """Seconds a job in the span ``label`` (jobs without it count 0); None
    when no job entered it."""
    if not any(label in j["spans"] for j in run.jobs):
        return None
    return mean([j["spans"].get(label, 0.0) for j in run.jobs])


def stat_mean(run, module, key, route=None):
    """The mean of ``LAST_STATS[key]`` of ``module`` (its last name) over
    the jobs (of the route ``route`` if given) that recorded it."""
    return mean([j["stats"].get(module, {}).get(key) for j in run.jobs
                 if route is None or j["route"] == route])


def route_of(stats):
    """The route a ``rem`` job took, from the program's counters (those
    that the run collected)."""
    multi = stats.get("devloop_multi", {})
    front = stats.get("devfrontier", {})
    loop = stats.get("devloop", {})
    if multi and multi.get("fallback") is None and "loop_seconds" in multi:
        return "multi"
    if front:
        why = front.get("fallback")
        return "frontier" + (" (declined: %s)" % why if why else "")
    if "forest_seconds" in loop and loop.get("fallback") is None:
        return "forest"
    if "loop_seconds" in loop:  # the single-root loop took it
        why = loop.get("fallback")
        return "single_root" + (" (declined: %s)" % why if why else "")
    return "unknown"
