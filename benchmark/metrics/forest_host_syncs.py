"""forest_host_syncs (count a job; layer index.devloop): the device
forest's reads from the card to the host, ``devloop.LAST_STATS
["host_syncs"]`` (each one waits for the card), over the jobs that took
the forest."""

from benchmark.readers import ROUTE_STATS, stat_mean

STATS = ROUTE_STATS


def read(run):
    return stat_mean(run, "devloop", "host_syncs", route="forest")
