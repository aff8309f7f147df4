"""forest_s (s a job; layer index.devloop): the deferred forest on the
card, ``devloop.LAST_STATS["forest_seconds"]``, over the jobs that took
it.  Its clock closes after the forest's copies to the host, which wait
for the card."""

from benchmark.readers import ROUTE_STATS, stat_mean

STATS = ROUTE_STATS


def read(run):
    return stat_mean(run, "devloop", "forest_seconds", route="forest")
