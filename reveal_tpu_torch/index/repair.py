"""One boundary-repair pass of the pairwise device forest, in one launch.

``repair_segments`` applies the crossing suffixes ``cq[:min(rc, CCAP)]``
of a pass to ``SA``, ``LCP`` and ``BWT``.  On a CUDA tensor it launches
the CUDA kernel ``csrc/repair_pass.cu``, which runs each segment's
candidates in ascending slot order in one thread block (segments in
parallel) and edits the three arrays in place, with no host sync; on a
CPU tensor it runs the plain version, ``devloop.repair_rounds_plain``
(the batched rounds of the JAX kernel's ``rbody``), which returns new
tensors.  There is no other route between the two.  Both give the same
``(SA, LCP, BWT)`` bit for bit.
"""

from __future__ import annotations

import torch

from ..kernels import build

# kernel launches made by repair_segments (CUDA tensors only)
LAUNCHES = 0

# blocks a streaming multiprocessor runs at once (256 threads each)
_BLOCKS_PER_SM = 8


def _check(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, stats):
    npad = SA.shape[0]
    for name, t, n in (("SA", SA, npad), ("LCP", LCP, npad),
                       ("BWT", BWT, npad), ("SEG", SEG, npad),
                       ("beg", beg, npad), ("cq", cq, cq.shape[0]),
                       ("centry_next", centry_next, cq.shape[0])):
        if t.dtype != torch.int32:
            raise TypeError("%s must be int32, got %s" % (name, t.dtype))
        if t.shape != (n,):
            raise ValueError("%s has shape %s, expected (%d,)"
                             % (name, tuple(t.shape), n))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if rc.dtype != torch.int32 or rc.numel() != 1:
        raise ValueError("rc must be one int32, got %s %s"
                         % (rc.dtype, tuple(rc.shape)))
    if stats.dtype != torch.int64 or stats.shape != (3,):
        raise ValueError("stats must be (3,) int64, got %s %s"
                         % (stats.dtype, tuple(stats.shape)))
    for name, t in (("LCP", LCP), ("BWT", BWT), ("SEG", SEG), ("beg", beg),
                    ("cq", cq), ("centry_next", centry_next), ("rc", rc),
                    ("stats", stats)):
        if t.device != SA.device:
            raise ValueError("%s is on %s, SA on %s"
                             % (name, t.device, SA.device))
    if npad < 1 or npad >= 2**31:
        raise ValueError("npad %d out of range" % npad)


def repair_segments(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, SMAX,
                    stats):
    """Apply one pass's crossing suffixes.

    ``SA``, ``LCP``, ``BWT``, ``SEG``, ``beg``: (npad,) int32; ``cq``:
    (CCAP,) slots of the candidates, ascending; ``centry_next``: (CCAP,)
    ``LCP[cq + 1]`` at the start of the pass; ``rc``: 0-d int32, the
    number of crossing suffixes (only ``min(rc, CCAP)`` are applied);
    ``stats``: (3,) int64 counters, added to (candidates applied, the
    longest run of one segment, the sum of ``q - x`` over the movers).
    Returns ``(SA, LCP, BWT, steps)``: steps is the number of batched
    rounds on the CPU, 1 (the launch) on the card."""
    global LAUNCHES
    _check(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, stats)
    if SA.device.type == "cpu":
        # the plain version sits with the forest's other stages
        from .devloop import repair_rounds_plain

        return repair_rounds_plain(SA, LCP, BWT, SEG, beg, cq, centry_next,
                                   rc, SMAX, stats)
    if SA.device.type != "cuda":
        raise ValueError("unsupported device %s" % SA.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=SA.device)
    lib = build.load_library()
    with torch.cuda.device(SA.device):
        sms = torch.cuda.get_device_properties(SA.device).multi_processor_count
        stream = torch.cuda.current_stream(SA.device).cuda_stream
        err = lib.rtt_repair_pass_i32(
            SA.data_ptr(), LCP.data_ptr(), BWT.data_ptr(), SEG.data_ptr(),
            beg.data_ptr(), cq.data_ptr(), centry_next.data_ptr(),
            rc.data_ptr(), ticket.data_ptr(), stats.data_ptr(),
            SA.shape[0], cq.shape[0], sms * _BLOCKS_PER_SM, stream,
        )
    build.check(err, "repair_segments")
    LAUNCHES += 1
    return SA, LCP, BWT, 1
