"""Collective census of the distributed factors and solve.

Port of :func:`suitesparse_tpu.parallel.diag.collective_census`. The
reference parses the compiled XLA program; the port reads the record that
its one collective wrapper (``dist2._all_reduce``) keeps on the factor:
every ``all_reduce`` of the last distributed factor and of its last solve,
with its phase, group and bytes. The design contract it makes testable:
on :mod:`.dist2`'s flat schedule one halo sum before the crown, on its
(host, chip) schedule one sum over the host's ranks and one over the
world, one assembly sum, two sums a solve; on :mod:`.dist`'s mesh one
gather of U over the tree group a tree-sharded group, one of L21 and one
of U over the panel group a panel-sharded group, one assembly sum.
(``census_from_hlo`` parses XLA's HLO and has no counterpart.)
"""

from __future__ import annotations

__all__ = ["collective_census"]


def _tally(log) -> dict:
    out: dict = {}
    for c in log:
        row = out.setdefault(c.phase, {"group": c.group, "ranks": c.ranks,
                                       "count": 0, "bytes": 0,
                                       "seconds": 0.0})
        row["count"] += 1
        row["bytes"] += c.nbytes
        row["seconds"] += c.seconds
    return out


def collective_census(F) -> dict:
    """{"factor": {phase: {group, ranks, count, bytes, seconds}}, "solve":
    the same for the factor's last solve (empty before one)} of a
    :func:`.dist2.dist_factorize_v2` or :func:`.dist.dist_factorize_device`
    factor, on this rank."""
    if getattr(F, "dist", None) is None:
        raise ValueError("collective_census: the factor is not distributed")
    return {"factor": _tally(F.dist.collectives),
            "solve": _tally(F.dist.solve_collectives)}
