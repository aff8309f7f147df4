"""multi_host_syncs (count a job; layer index.devloop_multi): the multi
loop's reads from the card to the host, ``devloop_multi.LAST_STATS
["host_syncs"]`` (each one waits for the card)."""

from benchmark.readers import ROUTE_STATS, stat_mean

STATS = ROUTE_STATS


def read(run):
    return stat_mean(run, "devloop_multi", "host_syncs", route="multi")
