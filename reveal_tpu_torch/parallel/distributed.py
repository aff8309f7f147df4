"""Process groups for the multi-device routes.

Port of ``reveal_tpu/parallel/distributed.py``.  JAX runs one program
over a mesh of devices, in one process a host; torch runs one process a
rank in a ``torch.distributed`` process group.  Every process calls
``init_distributed`` with the group's address, size and its own rank,
then runs the same program: the alignment loops are deterministic, so
every rank makes the same calls and the collectives pair up.

Nothing here reads the environment: the address (``tcp://host:port`` or
``file:///path``), the world size and the rank come from the caller (the
reference's ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID`` are not carried over).  The backend follows the
device: gloo for ``cpu``, NCCL for ``cuda``.  A card without NCCL raises;
nothing falls back to gloo.

``World`` starts a local world of processes that this process drives
call by call (``World.run``): the tests' gloo worlds and
``chip_smoke.py``'s use it.
"""

from __future__ import annotations

import logging
import time
import traceback

import torch
import torch.distributed as dist

from ..core.torchconfig import resolve_device

log = logging.getLogger(__name__)


def backend_for(device) -> str:
    """The process-group backend of a device: ``gloo`` for the CPU,
    ``nccl`` for a card (which raises when NCCL is missing, or when no
    card is visible)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo"
    if not dist.is_nccl_available():
        raise RuntimeError("device %s needs the NCCL backend, which this "
                           "torch build lacks (torch %s)"
                           % (dev, torch.__version__))
    return "nccl"


def rank_device(device) -> torch.device:
    """This rank's device of kind ``device``: the CPU, or card
    ``rank % device_count`` (made the current card)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init_distributed(address, world_size: int = 1, rank: int = 0,
                     backend=None, device="cuda") -> None:
    """Join this process to the process group at ``address`` as ``rank``
    of ``world_size``.  No-op when ``address`` is None (one process).
    ``backend`` defaults to ``backend_for(device)``."""
    if address is None:
        return
    backend = backend or backend_for(device)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("backend nccl requested but unavailable")
    dist.init_process_group(backend, init_method=address,
                            world_size=int(world_size), rank=int(rank))
    log.info("torch.distributed up: rank %d/%d via %s (%s)", rank,
             world_size, address, backend)


def global_mesh(device="cuda"):
    """The mesh over every rank of the group this process belongs to."""
    from .mesh import make_mesh

    return make_mesh(None, device)


# --------------------------------------------------------------------------
# a local world of processes, driven from this one
# --------------------------------------------------------------------------

def _serve(rank, size, address, device, conn):
    """A rank of ``World``: join the group, then run each call sent down
    ``conn`` and send back (True, result) or (False, traceback)."""
    torch.set_num_threads(1)
    init_distributed(address, size, rank, device=device)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, kw = msg
            try:
                conn.send((True, fn(*args, **kw)))
            except Exception:
                conn.send((False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class World:
    """``size`` processes in one process group at ``address`` on
    ``device`` (gloo on the CPU, NCCL on cards: one card a rank), each
    running calls that this process sends (``run``).  Every call has
    ``timeout`` seconds to come back from every rank; past that, or when
    a rank dies, the world is killed and the call raises, so that a hung
    collective fails its caller instead of hanging it."""

    def __init__(self, size: int, address: str, device="cuda",
                 timeout: float = 300.0):
        import multiprocessing as mp

        backend_for(device)  # no card, or no NCCL: raise before any spawn
        ctx = mp.get_context("spawn")
        self.size, self.timeout = int(size), float(timeout)
        self.procs, self.conns = [], []
        for rank in range(self.size):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, daemon=True,
                            args=(rank, self.size, address, str(device),
                                  child))
            p.start()
            child.close()
            self.procs.append(p)
            self.conns.append(parent)

    def run(self, fn, *args, **kw):
        """``fn(*args, **kw)`` on every rank (``fn`` importable by name,
        its arguments picklable): the list of the ranks' results."""
        if not self.procs:
            raise RuntimeError("the world is closed")
        for c in self.conns:
            c.send((fn, args, kw))
        deadline = time.monotonic() + self.timeout
        out, errors = [], []
        for rank, c in enumerate(self.conns):
            try:
                if not c.poll(max(0.0, deadline - time.monotonic())):
                    raise TimeoutError("rank %d gave no answer in %.0f s"
                                       % (rank, self.timeout))
                ok, val = c.recv()
            except (EOFError, OSError, TimeoutError) as e:
                self.close(kill=True)
                raise RuntimeError("world of %d: %s (%s)"
                                   % (self.size, e or "rank %d died" % rank,
                                      type(e).__name__)) from e
            if not ok:
                errors.append("rank %d:\n%s" % (rank, val))
            out.append(val)
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self, kill: bool = False):
        """Stop every rank (kill them with ``kill``, or when they do not
        end within a few seconds)."""
        if not kill:
            for c in self.conns:
                try:
                    c.send(None)
                except OSError:
                    pass
            for p in self.procs:
                p.join(10.0)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        for c in self.conns:
            c.close()
        self.procs, self.conns = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

