"""Pair-HMM forward/backward DP and the batched posterior.

Counterpart of ``reveal_tpu/hmm/pallas_pairhmm.py``.  ``fwd_dp`` and
``bwd_dp`` are the wrappers of the two DP kernels: on a CUDA tensor they
launch the CUDA kernels of ``csrc/pairhmm_dp.cu`` (the ports of the Pallas
TPU kernels ``fwd_kernel`` and ``bwd_kernel``), on a CPU tensor they run
``fwd_dp_plain`` / ``bwd_dp_plain``, the same functions as a Python loop
over rows with the in-row recurrence written out as a doubling scan.  There
is no other route between the two, and a failed build or launch raises.

``posterior_batch`` combines them as the reference's ``posterior_batch``
does: the total from the snapshot of row ``lx`` at column ``ly``, the
backward pass on sequences reversed within their lengths, the backward
matrix brought to forward coordinates (``B0[b, i, j] = G0[b, lx-i, ly-j]``,
written in place by the backward wrapper instead of a flip and a roll),
and ``p = exp(min(0, M + B0 - total))`` masked to ``1..lx x 1..ly``.
``batch_posteriors_dp`` buckets string pairs by padded shape as
``batch_posteriors_pallas`` does.  The batch size of a bucket is bounded
by memory alone.

How a batch is laid over the card is ``launch_plan``'s choice, a pure
function of (B, L1p, L2p): a lane owns a strip of C columns in registers,
lanes run a skewed wavefront over the rows (lane t is t rows behind lane
0), narrow rows pack several pairs into a warp, wide rows are split into
panels of one warp each, which hand a panel's right edge on through
tagged records in global memory.  The kernels spend the 14 exp/log a cell
the function needs and no block barrier a row; what bounds them is the
instruction throughput around those special functions, and at small batches
the number of warps the plan can put on the card's 528 schedulers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from .pairhmm import (
    PairHMMParams,
    _bucket,
    _pad_with_dummy,
    default_params,
)

LOG_ZERO = -2e20

# kernel launches made by fwd_dp / bwd_dp (CUDA tensors only)
LAUNCHES = {"fwd": 0, "bwd": 0}

# ---------------------------------------------------------------------------
# class mapping: A C G T N other  (case-insensitive); the emission tables
# per class are pairhmm._class_tables, carried in PairHMMParams
# ---------------------------------------------------------------------------

_CLS = np.full(256, 5, dtype=np.uint8)
for _i, _ch in enumerate("ACGTN"):
    _CLS[ord(_ch)] = _i
    _CLS[ord(_ch.lower())] = _i

# posterior cells (B * L1p * L2p) of one batch: three float32 arrays of
# that size are live at the peak (M, the backward matrix and a temporary
# of the cut)
MAX_BATCH_CELLS = {"cuda": 1 << 29, "cpu": 1 << 24}
MAX_BATCH = 1024


def _round_up(x, m):
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

# columns a lane may own: the kernels are compiled for these strip widths.
# The register cap: a strip of C columns keeps 5 C (forward) or 3 C
# (backward) states, C emissions and C / 4 packed classes in registers:
# about 100 and 128 registers a thread at 4 and 8 columns (ptxas -v).
# Strips of 16 columns took 247 and were the fastest at no shape measured.
PLAN_COLUMNS = (4, 8)
MAX_COLUMNS = max(PLAN_COLUMNS)
# static shared memory of either kernel: the 102 parameters (padded to
# 16 bytes) and two 64-byte slots for edge records (a block is one warp)
PLAN_SHARED_BYTES = 416 + 128
# 32-bit words of an edge record a row (value and tag per state) and of
# the scratch's head (the ticket), as in csrc/pairhmm_dp.cu
EDGE_WORDS = {"fwd": 16, "bwd": 12}
SCRATCH_HEAD = 4
# warp schedulers of the card (132 SMs of 4): the measure of a full card
SCHEDULERS = 132 * 4
# steps by which a panel follows the panel to its left: the 32 lanes of
# the wavefront and the record's way through the L2 cache
PANEL_LAG = 64


def _ceil_div(a, b):
    return -(-a // b)


def make_plan(B: int, L1p: int, L2p: int, C: int) -> dict:
    """The layout with strips of C columns: G lanes a panel, P panels a
    row, one warp a panel and a block."""
    lanes = _ceil_div(L2p, C)
    if lanes <= 32:
        G = 1
        while G < lanes:
            G *= 2
        P = 1
    else:
        G = 32
        P = _ceil_div(L2p, 32 * C)
    ppw = 32 // G
    warps = _ceil_div(B, ppw) if P == 1 else B * P
    return dict(C=C, G=G, P=P, pairs_per_warp=ppw, warps_per_block=1,
                threads=32, blocks=warps, shared_bytes=PLAN_SHARED_BYTES)


def launch_plan(B: int, L1p: int, L2p: int) -> dict:
    """How the DP kernels lay B pairs of L1p x L2p over the card.

    Returns C (columns a lane), G (lanes a panel: a power of two), P
    (panels a row, each a warp of its own), pairs_per_warp (32 // G, above
    1 only when P == 1), warps_per_block (1), threads, blocks and
    shared_bytes.  Panels cover columns [p G C, (p + 1) G C): every column
    of the row lies in exactly one lane's strip.

    The rule is what ``scripts/torch_pairhmm_tune.py plans`` measured on
    an NVIDIA H100 80GB HBM3 (700 W), forward + backward a call;
    ``tests/test_torch_pairhmm.py`` holds it to the faster plan of every
    shape in that table.

    - A row of at most 256 columns is one panel of strips of 8, and pairs
      share a warp (1,024 pairs of 17 x 128: 0.063 ms against 0.089 with
      strips of 4).
    - Strips of 4 while that leaves at most two warps a scheduler: a warp
      that has its scheduler nearly to itself is bound by its own latency,
      and narrow strips make more and shorter warps (128 pairs of 513 x
      640: 1.31 ms against 1.36; 32 of 2049 x 2176: 4.90 against 5.23; 60
      of 1025 x 1152: 2.43 against 2.61).  Beyond that strips of 8, which
      spend fewer of a step's fixed instructions a cell (960 of 513 x
      640: 4.58 ms against 5.72; 120 of 2049 x 2176: 8.90 against 10.27).
    - Strips of 8 also where the chain of panels is longer than the rows
      that feed it: the last panel then starts after the first has ended,
      and half as many panels start sooner (2 pairs of 65 x 8320: 2.14
      ms against 2.91; 64 of 33 x 2176: 0.71 against 0.93)."""
    if L2p <= 32 * MAX_COLUMNS:
        return make_plan(B, L1p, L2p, MAX_COLUMNS)
    P4 = _ceil_div(L2p, 32 * 4)
    fed = (P4 - 1) * PANEL_LAG <= L1p + 31
    C = 4 if fed and B * P4 <= 2 * SCHEDULERS else 8
    return make_plan(B, L1p, L2p, C)


def scratch_words(direction: str, B: int, L1p: int, P: int) -> int:
    """32-bit words of zeroed scratch a launch needs: the ticket and one
    edge record a row for each of the P - 1 panel borders of a pair."""
    if P <= 1:
        return 0
    return SCRATCH_HEAD + B * (P - 1) * L1p * EDGE_WORDS[direction]


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------

def _lse(*xs):
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x)
    s = sum(torch.exp(x - m) for x in xs)
    out = m + torch.log(s)
    return torch.where(m <= LOG_ZERO / 2, torch.full_like(out, LOG_ZERO), out)


def _lse2(x, y):
    """2-argument lse as max + log1p(exp(-|x-y|)); no LOG_ZERO guard:
    LOG_ZERO + log 2 rounds back to LOG_ZERO in float32."""
    m = torch.maximum(x, y)
    return m + torch.log1p(torch.exp(torch.minimum(x, y) - m))


def _shift(x, k, fill):
    """Shift right along the last axis by k, filling with ``fill``."""
    out = torch.full_like(x, fill)
    if k < x.shape[-1]:
        out[..., k:] = x[..., : x.shape[-1] - k]
    return out


def _linrec(a, c):
    """Z[j] = lse(a[j], Z[j-1] + c[j]) along the last axis by doubling
    over log-space affine maps (M,B)o(M',B') = (M+M', lse(B', B+M'))."""
    Bv, Mv = a, c
    k = 1
    L = a.shape[-1]
    while k < max(L, 2):
        Bs = _shift(Bv, k, LOG_ZERO)
        Ms = _shift(Mv, k, 0.0)  # identity M = 0
        Bv = _lse2(Bv, Bs + Mv)
        Mv = Ms + Mv
        k *= 2
    return Bv


def _tables(params, xcls, ycls):
    xl = xcls.long()
    yl = ycls.long()
    e1_all = params.single[xl]  # (B, L1p)
    e2 = params.single[yl]      # (B, L2p)
    return xl, yl, e1_all, e2


def fwd_dp_plain(xcls, ycls, lx, params: PairHMMParams):
    """Forward DP of B pairs, row by row.  xcls (B, L1p), ycls (B, L2p)
    uint8 classes (dummy at index 0), lx (B,) int32.  Returns the M grid
    (B, L1p, L2p), LOG_ZERO in the rows beyond lx[b] (``combine`` masks
    them; the kernel does not compute them), and the five states at row
    lx[b] (B, 5, L2p)."""
    B, L1p = xcls.shape
    L2p = ycls.shape[1]
    dev = xcls.device
    li = [float(v) for v in params.init.tolist()]
    lt = [[float(v) for v in row] for row in params.trans.tolist()]
    xl, yl, e1_all, e2 = _tables(params, xcls, ycls)
    NEG = LOG_ZERO
    neg = torch.full((B, L2p), NEG, dtype=torch.float32, device=dev)
    lane = torch.arange(L2p, device=dev)[None, :].expand(B, L2p)
    state = [neg.clone() for _ in range(5)]
    snap = torch.full((B, 5, L2p), NEG, dtype=torch.float32, device=dev)
    m_out = torch.empty((B, L1p, L2p), dtype=torch.float32, device=dev)
    for i in range(L1p):
        prev_m, prev_ix1, prev_iy1, prev_ix2, prev_iy2 = state
        e_match = params.pair[xl[:, i, None], yl]  # (B, L2p)
        e1 = e1_all[:, i, None]
        if i == 0:
            m = neg.clone()
            ix1 = neg.clone()
            ix2 = neg.clone()
        else:
            m = e_match + _lse(
                _shift(prev_m, 1, NEG) + lt[0][0],
                _shift(prev_ix1, 1, NEG) + lt[1][0],
                _shift(prev_iy1, 1, NEG) + lt[2][0],
                _shift(prev_ix2, 1, NEG) + lt[3][0],
                _shift(prev_iy2, 1, NEG) + lt[4][0],
            )
            ix1 = e1 + _lse2(prev_m + lt[0][1], prev_ix1 + lt[1][1])
            ix2 = e1 + _lse2(prev_m + lt[0][3], prev_ix2 + lt[3][3])
            if i == 1:
                # init cells (1,1) of M and (1,0) of Ix
                m = torch.where(lane == 1, li[0] + e_match, m)
                ix1 = torch.where(lane == 0, li[1] + e1, ix1)
                ix2 = torch.where(lane == 0, li[3] + e1, ix2)
            m = torch.where(lane == 0, neg, m)
        # Iy[j] = lse(g[j] + e2[j], Iy[j-1] + ext + e2[j]); the seeds sit
        # at (0,1), where M[0] is LOG_ZERO: a select, not an lse
        mshift = _shift(m, 1, NEG)
        g1 = mshift + lt[0][2]
        g2 = mshift + lt[0][4]
        if i == 0:
            g1 = torch.where(lane == 1, torch.full_like(neg, li[2]), g1)
            g2 = torch.where(lane == 1, torch.full_like(neg, li[4]), g2)
        a1 = g1 + e2
        a2 = g2 + e2
        iy1 = _linrec(a1, e2 + lt[2][2])
        iy2 = _linrec(a2, e2 + lt[4][4])
        iy1 = torch.where(lane == 0, neg, iy1)
        iy2 = torch.where(lane == 0, neg, iy2)
        state = [m, ix1, iy1, ix2, iy2]
        m_out[:, i] = m
        at_last = (lx == i)[:, None, None]
        snap = torch.where(at_last, torch.stack(state, dim=1), snap)
    beyond = torch.arange(L1p, device=dev)[None, :] > lx[:, None]
    m_out.masked_fill_(beyond[:, :, None], NEG)
    return m_out, snap


def bwd_dp_plain(xcls, ycls, params: PairHMMParams):
    """The matching backward DP on sequences reversed within their
    lengths; returns the G0 grid (B, L1p, L2p) in its own (reversed)
    coordinates: ``flip_within`` brings it to forward coordinates."""
    B, L1p = xcls.shape
    L2p = ycls.shape[1]
    dev = xcls.device
    li = [float(v) for v in params.init.tolist()]
    lt = [[float(v) for v in row] for row in params.trans.tolist()]
    xl, yl, e1_all, e2 = _tables(params, xcls, ycls)
    NEG = LOG_ZERO
    neg = torch.full((B, L2p), NEG, dtype=torch.float32, device=dev)
    lane = torch.arange(L2p, device=dev)[None, :].expand(B, L2p)
    prev_g0, prev_gx1, prev_gx2 = neg, neg, neg
    g_out = torch.empty((B, L1p, L2p), dtype=torch.float32, device=dev)
    for ip in range(L1p):
        e_match = params.pair[xl[:, ip, None], yl]
        e1 = e1_all[:, ip, None]
        H = e_match + _shift(prev_g0, 1, NEG)
        gx1 = _lse2(lt[1][0] + H, lt[1][1] + e1 + prev_gx1)
        gx2 = _lse2(lt[3][0] + H, lt[3][3] + e1 + prev_gx2)
        seed1 = neg
        seed2 = neg
        if ip == 0:
            gx1 = torch.where(lane == 0, torch.full_like(neg, li[1]), gx1)
            gx2 = torch.where(lane == 0, torch.full_like(neg, li[3]), gx2)
            seed1 = torch.where(lane == 0, torch.full_like(neg, li[2]), neg)
            seed2 = torch.where(lane == 0, torch.full_like(neg, li[4]), neg)
        # Gy[j] = lse(g[j], Gy[j-1] + ext + e2[j]); the seeds sit at the
        # origin only, so column 0 is a select
        a1 = torch.where(lane == 0, seed1, lt[2][0] + H)
        a2 = torch.where(lane == 0, seed2, lt[4][0] + H)
        gy1 = _linrec(a1, e2 + lt[2][2])
        gy2 = _linrec(a2, e2 + lt[4][4])
        g0 = _lse(
            lt[0][0] + H,
            lt[0][1] + e1 + prev_gx1,
            lt[0][3] + e1 + prev_gx2,
            lt[0][2] + e2 + _shift(gy1, 1, NEG),
            lt[0][4] + e2 + _shift(gy2, 1, NEG),
        )
        if ip == 0:
            g0 = torch.where(lane == 0, torch.full_like(neg, li[0]), g0)
        prev_g0, prev_gx1, prev_gx2 = g0, gx1, gx2
        g_out[:, ip] = g0
    return g_out


def flip_within(g, lx, ly):
    """out[b, i, j] = g[b, lx[b]-i, ly[b]-j] for i <= lx[b], j <= ly[b],
    LOG_ZERO elsewhere: the dual grid in forward coordinates."""
    out = torch.full_like(g, LOG_ZERO)
    for b in range(g.shape[0]):
        nx, ny = int(lx[b]) + 1, int(ly[b]) + 1
        out[b, :nx, :ny] = g[b, :nx, :ny].flip(0, 1)
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(xcls, ycls, params, lens):
    for name, t in (("xcls", xcls), ("ycls", ycls)):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise TypeError(
                "%s must be a 2-D uint8 tensor, got %s %s"
                % (name, t.dtype, tuple(t.shape))
            )
    for name, t in lens:
        if t.dtype != torch.int32 or t.shape != (xcls.shape[0],):
            raise TypeError(
                "%s must be int32 of shape (%d,), got %s %s"
                % (name, xcls.shape[0], t.dtype, tuple(t.shape))
            )
    if xcls.shape[0] != ycls.shape[0] or xcls.shape[0] < 1:
        raise ValueError(
            "batch sizes differ or are empty: %s and %s"
            % (tuple(xcls.shape), tuple(ycls.shape))
        )
    if xcls.shape[0] * xcls.shape[1] * ycls.shape[1] >= 2**40:
        raise ValueError("batch of %s x %s is too large"
                         % (tuple(xcls.shape), tuple(ycls.shape)))
    for name, t in (("xcls", xcls), ("ycls", ycls), *lens,
                    ("params", params.packed)):
        if t.device != xcls.device:
            raise ValueError(
                "%s is on %s, xcls on %s" % (name, t.device, xcls.device)
            )
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if params.packed.dtype != torch.float32 or params.packed.numel() != 102:
        raise TypeError("params.packed must be 102 float32 values")
    if xcls.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % xcls.device)


def _scratch_tensor(direction, plan, B, L1p, L2p, dev):
    """The zeroed edge records of one launch, or None for one panel."""
    if L2p % 4:
        raise ValueError("the DP kernels take rows of a multiple of 4 "
                         "columns, got L2p = %d" % L2p)
    words = scratch_words(direction, B, L1p, plan["P"])
    return (torch.zeros(words, dtype=torch.int32, device=dev)
            if words else None)


def _plan_args(plan):
    return plan["C"], plan["G"], plan["P"]


def _launch_fwd(plan, xcls, ycls, lx, params):
    """The forward kernel on CUDA tensors under ``plan``."""
    B, L1p = xcls.shape
    L2p = ycls.shape[1]
    dev = xcls.device
    m_out = torch.empty((B, L1p, L2p), dtype=torch.float32, device=dev)
    snap = torch.empty((B, 5, L2p), dtype=torch.float32, device=dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        scratch = _scratch_tensor("fwd", plan, B, L1p, L2p, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rtt_pairhmm_fwd_f32(
            xcls.data_ptr(), ycls.data_ptr(), lx.data_ptr(),
            params.packed.data_ptr(), m_out.data_ptr(), snap.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, L1p, L2p, *_plan_args(plan), stream,
        )
    build.check(err, "pairhmm_fwd")
    LAUNCHES["fwd"] += 1
    return m_out, snap


def _launch_bwd(plan, xcls, ycls, lx, ly, params):
    """The backward kernel on CUDA tensors under ``plan``."""
    B, L1p = xcls.shape
    L2p = ycls.shape[1]
    dev = xcls.device
    out = torch.empty((B, L1p, L2p), dtype=torch.float32, device=dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        scratch = _scratch_tensor("bwd", plan, B, L1p, L2p, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rtt_pairhmm_bwd_f32(
            xcls.data_ptr(), ycls.data_ptr(), lx.data_ptr(), ly.data_ptr(),
            params.packed.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, L1p, L2p, *_plan_args(plan), stream,
        )
    build.check(err, "pairhmm_bwd")
    LAUNCHES["bwd"] += 1
    return out


def fwd_dp(xcls, ycls, lx, params: PairHMMParams):
    """Forward DP of a batch -> (M (B, L1p, L2p), snap (B, 5, L2p)).
    Rows of M beyond lx[b] hold LOG_ZERO."""
    _check(xcls, ycls, params, (("lx", lx),))
    if xcls.device.type == "cpu":
        return fwd_dp_plain(xcls, ycls, lx, params)
    plan = launch_plan(xcls.shape[0], xcls.shape[1], ycls.shape[1])
    return _launch_fwd(plan, xcls, ycls, lx, params)


def bwd_dp(xcls, ycls, lx, ly, params: PairHMMParams):
    """Backward DP of a batch of within-length-reversed sequences ->
    the backward matrix (B, L1p, L2p) in forward coordinates,
    ``flip_within(G0, lx, ly)``."""
    _check(xcls, ycls, params, (("lx", lx), ("ly", ly)))
    if xcls.device.type == "cpu":
        return flip_within(bwd_dp_plain(xcls, ycls, params), lx, ly)
    plan = launch_plan(xcls.shape[0], xcls.shape[1], ycls.shape[1])
    return _launch_bwd(plan, xcls, ycls, lx, ly, params)


# ---------------------------------------------------------------------------
# the batched posterior
# ---------------------------------------------------------------------------

def _prep(x, y):
    """x: (B, L1p) uint8 bytes, y: (B, L2p) uint8 bytes -> their classes
    (uint8).  The emission rows the reference gathers here are looked up
    from the class tables inside the DP."""
    tab = torch.from_numpy(_CLS).to(x.device)
    return tab[x.long()].contiguous(), tab[y.long()].contiguous()


def _reverse_within(x, lx):
    """xr[i'] = x[lx-i'+1] for 1 <= i' <= lx; '~' beyond; dummy at 0."""
    L = x.shape[1]
    iar = torch.arange(L, device=x.device)[None, :]
    lxl = lx.long()[:, None]
    idx = (lxl - iar + 1).clamp(0, L - 1)
    xr = torch.where(
        (iar >= 1) & (iar <= lxl),
        torch.gather(x, 1, idx),
        torch.full_like(x, ord("~")),
    )
    xr[:, 0] = x[:, 0]
    return xr


def combine(m_grid, snap, b0, lx, ly, params: PairHMMParams):
    """Posterior and total of a batch from the forward grid M, the
    snapshot at row lx and the backward matrix in forward coordinates:
    total = lse_k snap[b, k, ly[b]] + init[k], p = exp(min(0, M + B0 -
    total)) masked to 1..lx x 1..ly.  Overwrites ``m_grid``."""
    B, L1p, L2p = m_grid.shape
    snap_at = torch.gather(
        snap, 2, ly.long()[:, None, None].expand(B, 5, 1)
    )[:, :, 0]
    total = torch.logsumexp(snap_at + params.init[None, :], dim=1)
    p = m_grid.add_(b0).sub_(total[:, None, None]).clamp_(max=0.0).exp_()
    iar = torch.arange(L1p, device=p.device)[None, :]
    jar = torch.arange(L2p, device=p.device)[None, :]
    rows = ((iar >= 1) & (iar <= lx[:, None])).to(p.dtype)
    cols = ((jar >= 1) & (jar <= ly[:, None])).to(p.dtype)
    p.mul_(rows[:, :, None]).mul_(cols[:, None, :])
    return p, total


def posterior_batch(x, y, lx, ly, params: PairHMMParams = None):
    """x: (B, L1p) uint8 with the dummy at column 0 and '~' padding, y:
    (B, L2p) likewise; lx, ly: (B,) int32 true lengths.  Returns
    (posterior (B, L1p, L2p) float32, total (B,) float32)."""
    if params is None:
        params = default_params(x.device)
    xcls, ycls = _prep(x, y)
    m_grid, snap = fwd_dp(xcls, ycls, lx, params)
    # backward on reversed sequences, brought to forward coordinates:
    # B0[b, i, j] = G0[b, lx-i, ly-j]
    xclsr, yclsr = _prep(_reverse_within(x, lx), _reverse_within(y, ly))
    b0 = bwd_dp(xclsr, yclsr, lx, ly, params)
    return combine(m_grid, snap, b0, lx, ly, params)


def bucket_key(s1: str, s2: str):
    """Padded DP shape (L1p, L2p) of a pair: power-of-two length buckets
    plus the dummy column, the width rounded up to 128."""
    return _bucket(len(s1)) + 1, _round_up(_bucket(len(s2)) + 1, 128)


def batch_size(L1p: int, L2p: int, device_type: str) -> int:
    """Most pairs of one padded shape that one batch holds."""
    return max(1, min(MAX_BATCH,
                      MAX_BATCH_CELLS[device_type] // (L1p * L2p)))


def batches(pairs, device):
    """Yield (L1p, L2p, idxs, x, y, lx, ly) for every batch of ``pairs``:
    bucketed by padded shape, a bucket split so that one batch holds at
    most MAX_BATCH_CELLS posterior cells.  x, y, lx, ly are tensors on
    ``device``; no batch entry is padding."""
    dev = torch.device(device)
    buckets = {}
    for i, (s1, s2) in enumerate(pairs):
        buckets.setdefault(bucket_key(s1, s2), []).append(i)
    for (L1p, L2p), idxs_all in buckets.items():
        mB = batch_size(L1p, L2p, dev.type)
        for lo in range(0, len(idxs_all), mB):
            idxs = idxs_all[lo: lo + mB]
            xb = np.stack(
                [_pad_with_dummy(pairs[i][0].encode(), L1p - 1)
                 for i in idxs]
            )
            yb = np.stack(
                [_pad_with_dummy(pairs[i][1].encode(), L2p - 1)
                 for i in idxs]
            )
            lx = np.array([len(pairs[i][0]) for i in idxs], dtype=np.int32)
            ly = np.array([len(pairs[i][1]) for i in idxs], dtype=np.int32)
            yield (
                L1p, L2p, idxs,
                torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev),
                torch.from_numpy(lx).to(dev), torch.from_numpy(ly).to(dev),
            )


def batch_posteriors_dp(pairs, device, slice_output: bool = True,
                        params: PairHMMParams = None):
    """Dense posteriors of a list of (seq1, seq2) string pairs on
    ``device``: [(posterior, total), ...] in input order as numpy arrays,
    posteriors sliced to (l1+1, l2+1) unless ``slice_output`` is off."""
    out = [None] * len(pairs)
    for _L1p, _L2p, idxs, x, y, lx, ly in batches(pairs, device):
        p, tot = posterior_batch(x, y, lx, ly, params)
        p = p.cpu().numpy()
        tot = tot.cpu().numpy()
        for bi, i in enumerate(idxs):
            l1, l2 = len(pairs[i][0]), len(pairs[i][1])
            if slice_output:
                out[i] = (p[bi, : l1 + 1, : l2 + 1], float(tot[bi]))
            else:
                out[i] = (p[bi], float(tot[bi]))
    return out
