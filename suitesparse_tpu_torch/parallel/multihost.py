"""Multi-process execution: the process group, the (host, chip) topology
and the distributed entry points, on ``torch.distributed``.

Port of :mod:`suitesparse_tpu.parallel.multihost`. One process is one rank;
every rank calls with the same A and analysis S (the plan is replicated on
the host: it is small next to the numeric data). The schedule follows the
fabric (:mod:`.dist2`): subtrees a rank, whose extend-adds need no
communication; a MID crown a host, summed over the host's ranks only; the
global separator crown, summed once over every rank.

Launch, one process a rank (``torchrun``, or ``torch.multiprocessing`` with
the ``spawn`` method: CUDA cannot fork)::

    import suitesparse_tpu_torch.parallel.multihost as mh
    mh.initialize("tcp://localhost:29500", world_size=4, rank=r,
                  backend="gloo")        # or "env://" under torchrun
    topo = mh.host_chip_mesh()           # host axis from the hostnames
    F = mh.factorize(A, S, topo)
    x = mh.solve(F, b)

Backends: ``"nccl"`` takes one rank a card; ``"gloo"`` takes CPU tensors
and ranks that share a card (NCCL refuses two ranks on one GPU), and sums
CUDA tensors through the host. ``initialize`` raises on a combination that
cannot work; it never switches backends by itself.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import torch
import torch.distributed as tdist

from ..config import DEFAULT, Config
from ..device import resolve_device

__all__ = ["Topology", "factorize", "global_solver_mesh", "host_chip_mesh",
           "host_layout", "initialize", "solve", "topology"]

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 600.0     # a dead rank fails its peers' collectives after this


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               timeout: float = TIMEOUT_S) -> None:
    """Create the default process group (``torch.distributed``).

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK`` (as
    ``torchrun`` sets them), else 1 and 0. A world of one rank without an
    ``init_method`` is a no-op: the distributed factor then runs with no
    process group. With an ``init_method`` a world of one rank gets its
    group like any other, so that its sums go through the backend.
    ``backend`` must be named: ``"nccl"`` (one rank a card: this raises if
    the host's ranks outnumber its cards, or there is no card; a world
    larger than the host's cards spans several hosts only with
    ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` set, as ``torchrun`` sets
    them) or ``"gloo"``. ``timeout`` (seconds) bounds every collective, so
    that a dead rank fails its peers instead of hanging them."""
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None \
        else world_size
    rank = _env_int("RANK", 0) if rank is None else rank
    if world_size == 1 and init_method is None:
        return
    if backend not in BACKENDS:
        raise ValueError(f"initialize: backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"initialize: rank {rank} of {world_size}")
    if tdist.is_initialized():
        if (tdist.get_world_size(), tdist.get_rank(),
                tdist.get_backend()) != (world_size, rank, backend):
            raise RuntimeError("initialize: a different process group is "
                               "already initialized")
        return
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        spread = "LOCAL_WORLD_SIZE" in os.environ and \
            "LOCAL_RANK" in os.environ
        if world_size > cards and cards and not spread:
            raise ValueError(
                f"initialize: NCCL takes one rank a card; {world_size} ranks "
                f"on this host's {cards} cards must name their share of it "
                f"in LOCAL_WORLD_SIZE and LOCAL_RANK (torchrun sets them), "
                f"or share a card with backend='gloo'")
        local = _env_int("LOCAL_WORLD_SIZE", world_size)
        if local > cards:
            raise ValueError(
                f"initialize: NCCL takes one rank a card; this host runs "
                f"{local} ranks on {cards} cards (ranks that share a card "
                f"take backend='gloo')")
        torch.cuda.set_device(_env_int("LOCAL_RANK", rank) % cards)
    tdist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))


@dataclasses.dataclass
class Topology:
    """This rank's place in a (host, chip) layout: ranks are host-major
    (``rank = host * nchip + chip``). ``host_group`` is the process group
    of the host's ranks (None: the world, as on one host), ``device`` the
    rank's device."""

    nhost: int
    nchip: int
    rank: int
    host: int
    chip: int
    host_group: object
    device: torch.device

    @property
    def world(self) -> int:
        return self.nhost * self.nchip


def topology(nhost: int, nchip: int, rank: int, host_group=None,
             device=None) -> Topology:
    """The :class:`Topology` of ``rank`` in ``nhost`` hosts of ``nchip``
    ranks each. ``device``: by default ``cuda:{local rank % device
    count}`` (it raises where there is no card); the CPU tests pass
    ``"cpu"``."""
    if nhost < 1 or nchip < 1 or not 0 <= rank < nhost * nchip:
        raise ValueError(f"topology: rank {rank} in {nhost} x {nchip}")
    host, chip = divmod(rank, nchip)
    return Topology(nhost=nhost, nchip=nchip, rank=rank, host=host,
                    chip=chip, host_group=host_group,
                    device=resolve_device(_default_device() if device is None
                                          else device))


def host_layout(names: list) -> tuple[int, int]:
    """(nhost, nchip) of the ranks whose hostnames are ``names`` (by
    rank); raises unless each host holds the same number of ranks, in one
    run of consecutive ranks (host-major)."""
    hosts = list(dict.fromkeys(names))
    nhost = len(hosts)
    if not names or len(names) % nhost:
        raise ValueError(f"host_layout: {len(names)} ranks do not split "
                         f"over {nhost} hosts")
    nchip = len(names) // nhost
    if any(name != hosts[r // nchip] for r, name in enumerate(names)):
        raise ValueError(f"host_layout: ranks are not host-major: {names}")
    return nhost, nchip


def _default_device():
    if not torch.cuda.is_available():
        return "cuda"      # resolve_device raises: CUDA asked for, none here
    return torch.device("cuda", _env_int("LOCAL_RANK", tdist.get_rank()
                                         if tdist.is_initialized() else 0)
                        % torch.cuda.device_count())


def host_chip_mesh(nhost: int | None = None, nchip: int | None = None,
                   device=None) -> Topology:
    """This rank's (host, chip) :class:`Topology`.

    By default the host axis follows the real process layout: each rank's
    hostname, gathered once (``all_gather_object``). Explicit ``nhost``
    and/or ``nchip`` lay the world out as asked, for one-machine runs.
    Every rank must call this with the same arguments: it creates one
    process group a host. ``device``: by default
    ``cuda:{local rank % device count}``; the CPU tests pass ``"cpu"``."""
    init = tdist.is_available() and tdist.is_initialized()
    world = tdist.get_world_size() if init else 1
    rank = tdist.get_rank() if init else 0
    if nhost is None and nchip is None:
        names = [socket.gethostname()]
        if world > 1:
            names = [None] * world
            tdist.all_gather_object(names, socket.gethostname())
        nhost, nchip = host_layout(names)
    elif nchip is None:
        nchip = world // nhost
    elif nhost is None:
        nhost = world // nchip
    if nhost * nchip != world:
        raise ValueError(f"host_chip_mesh: {nhost} x {nchip} ranks for a "
                         f"world of {world}")
    host_group = None
    if init and nhost > 1:
        groups = [tdist.new_group(list(range(h * nchip, (h + 1) * nchip)))
                  for h in range(nhost)]
        host_group = groups[rank // nchip]
    return topology(nhost, nchip, rank, host_group, device)


def global_solver_mesh(device=None) -> Topology:
    """The flat topology over every rank (one host of ``world`` ranks):
    the flat schedule's entry point."""
    init = tdist.is_available() and tdist.is_initialized()
    return host_chip_mesh(1, tdist.get_world_size() if init else 1, device)


def factorize(A, S, topo: Topology | None = None, config: Config = DEFAULT):
    """The distributed factor over ``topo`` (default
    :func:`host_chip_mesh`): the (host, chip) schedule where it has more
    than one host, the flat one otherwise."""
    from .dist2 import dist_factorize_v2

    return dist_factorize_v2(A, S, host_chip_mesh() if topo is None
                             else topo, config)


def solve(F, b, config: Config = DEFAULT):
    """The distributed solve over a :func:`factorize` factor."""
    from .dist2 import dist_solve_v2

    return dist_solve_v2(F, b, config)
