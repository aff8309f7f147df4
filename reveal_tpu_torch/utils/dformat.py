"""dformat: rewrite fasta names to daligner-compatible read names.

Port of utils/dformat.py:
``>template/well/start_end/length`` naming, 100-column wrapping.
Run: python -m reveal_tpu_torch.utils.dformat reads.fa > formatted.fa
"""

from __future__ import annotations

import argparse
import os
import sys

from ..core.io_fasta import fasta_reader


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="dformat",
        description="Convert fasta names to daligner-compatible naming "
        "(>name/well/start_end/length).",
    )
    parser.add_argument("fasta")
    args = parser.parse_args(argv)

    template = (
        os.path.basename(args.fasta)
        .replace(".fasta", "")
        .replace(".fa", "")
        .replace(".fna", "")
        .replace(" ", "")
        .replace(".", "")
    )
    for c, (name, seq) in enumerate(fasta_reader(args.fasta, toupper=False)):
        l = len(seq)
        sys.stdout.write(">%s/%d/%d_%d/%d\n" % (template, c, 0, l, l))
        for i in range(0, l, 100):
            sys.stdout.write(seq[i : i + 100] + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
