"""The job ``rem``: the CLI's recursive exact-match alignment of the
cell's fastas into a GFA, and the plain reference's graph of the same.

A configuration's ``options`` are ``rem``'s options by the names of the
reference's ``PickerConfig`` (``minlength``, ``minn``, ``maxmums``,
``wpen``, ``wscore``, ``seedsize``, ``pcutoff``, ``gcmodel``,
``maxsize``, ``trim``); both sides get every one of them.
"""

from __future__ import annotations

OUTPUT = ".gfa.gz"
# option -> the CLI's flag; a boolean option is a pair of flags, the
# first for True (None: the CLI's default, no flag) and the second for
# False
FLAGS = {"minlength": "--minlength", "minn": "--minn",
         "maxmums": "--maxmums", "wpen": "--wpen", "wscore": "--wscore",
         "seedsize": "--seedsize", "pcutoff": "--pcutoff",
         "gcmodel": "--gcmodel", "maxsize": "--maxsize",
         "trim": (None, "--notrim")}


def option_args(options):
    """The CLI's arguments for ``options``; an option it has no flag for
    is refused."""
    out = []
    for name, value in options.items():
        if name not in FLAGS:
            raise KeyError("rem has no option %r" % name)
        flag = FLAGS[name]
        if isinstance(flag, tuple):
            chosen = flag[0] if value else flag[1]
            out += [chosen] if chosen else []
        elif value is not None:
            out += [flag, repr(value) if isinstance(value, float)
                    else str(value)]
    return out


def argv(fastas, prefix, options, extra=(), device="cuda"):
    """``rem -o <prefix> <options> <extra> <fastas>``, as a user types it
    (``--device`` only off the card)."""
    dev = [] if device == "cuda" else ["--device", device]
    return ["rem", "-o", prefix, *option_args(options), *extra, *dev,
            *fastas]


def reference(fastas, out, options):
    """The plain reference's GFA (text bytes) of the same job."""
    from benchmark.reference import engine

    return engine.rem_gfa(fastas, out, **options)
