"""mbp_per_s (Mbp/s, higher is better; host clock): the input bases of
every job finished in the window, over the seconds from the start of the
first timed job to the end of the last.  A job's input bases are the sum
of its fastas' sequence lengths."""


def read(run):
    if not run.jobs:
        return None
    return sum(j["bases"] for j in run.jobs) / 1e6 / run.window_s
