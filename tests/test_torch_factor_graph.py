"""The supernodal factor's group loop replayed from a CUDA graph
(``supernodal_device.FactorGraph``).

On the CPU: the rule that picks eager, capture or replay
(``_graph_mode``), the key a graph is cached under (``_graph_key``, per
``DevicePlan``), the live-set estimate a capture checks against the free
memory (``_loop_bytes``), the bytes a graph's pool holds, which every
free-memory check of the port leaves out while the graph lives
(``device.free_bytes``), and the CPU factor, which never captures: its
bits and counters are the same on every call.

Marked ``card`` (they skip where no card is found; the check is made
inside the fixture): replayed factors bit-equal to the eager loop over
refactorizations of changed values in fp32 (K1, K2, K7), fp64 and fp32
with bfloat16 updates, an earlier factor untouched by a later replay, a
matrix made indefinite mid-sequence, the segmented factor, a capture
that does not fit, and the pool's free blocks held from another key's
budget. On the card (``--noconftest``: ``tests/conftest.py``
imports JAX, which the card's Python lacks):

    python -m pytest --noconftest tests/test_torch_factor_graph.py -m card
"""

import gc
import types

import numpy as np
import pytest
import torch

import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch import device as sdev
from suitesparse_tpu_torch import stats
from suitesparse_tpu_torch.device import fp32_precision
from suitesparse_tpu_torch.numeric import segmented, supernodal
from suitesparse_tpu_torch.numeric import supernodal_device as sd
from suitesparse_tpu_torch.numeric import supernodal_solve

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")
GRAPH_COUNTERS = ("factor.graph.capture", "factor.graph.replay",
                  "factor.graph.eager", "graph_pool_bytes")
DTYPES = {"float32": ("float32", "float32"), "float64": ("float64", "float64"),
          "bf16_updates": ("float32", "bfloat16")}


def analysis(k=8):
    """A Laplacian, its config and its supernodal analysis (no plan
    cached on it yet)."""
    A = sstt.fixtures.laplacian_3d(k)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    S = supernodal.supernodal_symbolic(A, sstt.analyze(A, cfg), cfg)
    return A, S, cfg


def config(cfg, name):
    compute, upd = DTYPES[name]
    return cfg.replace(compute_dtype=compute, update_dtype=upd)


def counted(fn):
    """``fn()`` and the change of every ``GLOBAL_STATS`` counter across
    it."""
    before = dict(stats.GLOBAL_STATS.counters)
    out = fn()
    after = stats.GLOBAL_STATS.counters
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


def eager_lx(A, S, cfg, dev, tile_rmin=sd.TILE_RMIN):
    """The eager group loop on A's values, on the plan a factor of
    ``cfg`` takes: the padded factor a replay must match."""
    dp = sd.device_plan(A, S, dev, tile_rmin, cfg.tile_pair)
    dtype = sd.compute_dtype(cfg)
    Cdata = torch.as_tensor(sd._clow_data(A, S), device=dev).to(dtype)
    arrays = enumerate(ix for il in dp.groups for ix in il)
    with fp32_precision(cfg.precision):
        return sd._run_plan(dp.plan, arrays, Cdata, dtype,
                            sd.update_dtype(cfg, dtype))


# ----- on the CPU -----

class _Graph:
    """A stand-in for a captured :class:`FactorGraph` (truthy)."""


# (device, segmented, the state before, tracing at each call, the modes)
MODE_CASES = {
    "cpu": (CPU, False, "absent", [False] * 3, ["eager"] * 3),
    "segmented": (CUDA, True, "absent", [False] * 3, ["eager"] * 3),
    "first_eager_then_capture": (CUDA, False, "absent", [False, False],
                                 ["eager", "capture"]),
    "traced_waits_to_capture": (CUDA, False, "absent", [True, True, False],
                                ["eager", "eager", "capture"]),
    "graph_replays_traced_or_not": (CUDA, False, "graph", [False, True],
                                    ["replay", "replay"]),
    "did_not_fit_stays_eager": (CUDA, False, "no_fit", [False] * 3,
                                ["eager"] * 3),
}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_graph_mode_rule(case, monkeypatch):
    dev, segmented, state, traced, want = MODE_CASES[case]
    dp = sd.DevicePlan(plan=None, device=dev, groups=None)
    key = (torch.float32, torch.float32, "highest")
    if state != "absent":
        dp.graphs[key] = _Graph() if state == "graph" else False
    got = []
    for t in traced:
        monkeypatch.setattr(sd, "tracing", lambda t=t: t)
        got.append(sd._graph_mode(dp, key, dev, segmented))
    assert got == want
    if dev.type != "cuda" or segmented:
        assert dp.graphs == {}
    elif state == "absent":
        assert dp.graphs == {key: None}


@pytest.mark.parametrize("field,a,b", [
    ("compute_dtype", "float32", "float64"),
    ("update_dtype", "float32", "bfloat16"),
    ("precision", "highest", "high"),
])
def test_graph_key_separates(field, a, b):
    cfg = sstt.DEFAULT
    keys = []
    for v in (a, b, a):
        c = cfg.replace(**{field: v})
        dtype = sd.compute_dtype(c)
        keys.append(sd._graph_key(c, dtype, sd.update_dtype(c, dtype)))
    assert keys[0] != keys[1] and keys[0] == keys[2]


def test_graph_key_separates_plans():
    """Graphs live on the plan entry, which the tile threshold, the
    manifest form and the device separate: a second plan of the same
    analysis starts at its own first (eager) factor."""
    A, S, cfg = analysis(6)
    key = sd._graph_key(cfg, torch.float32, torch.float32)
    plans = [sd._plan_entry(A, S, CUDA, rmin, pair)
             for rmin, pair in ((256, False), (32, False), (256, True))]
    assert len({id(dp) for dp in plans}) == 3
    assert sd._plan_entry(A, S, CUDA, 256, False) is plans[0]
    assert sd._graph_mode(plans[0], key, CUDA, False) == "eager"
    assert sd._graph_mode(plans[0], key, CUDA, False) == "capture"
    for dp in plans[1:]:
        assert sd._graph_mode(dp, key, CUDA, False) == "eager"


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_cpu_factor_bits_and_counters_unchanged(name):
    """The CPU factor never captures: every call runs the eager loop, to
    the same bits, and counts nothing of the graph."""
    A, S, cfg = analysis()
    c = config(cfg, name)
    runs = [counted(lambda: sd.factorize_device(A, S, c, "cpu"))
            for _ in range(3)]
    want = eager_lx(A, S, c, CPU)
    for F, d in runs:
        assert F.ok and torch.equal(F.Lx, want)
        assert not set(d) & set(GRAPH_COUNTERS), d
    assert runs[0][0].dplan.graphs == {}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_loop_bytes_is_the_loops_live_peak(name, monkeypatch):
    """The estimate a capture checks equals the largest sum, over the
    loop, of a group's working set and the updates held across it."""
    A, S, cfg = analysis()
    c = config(cfg, name)
    dtype = sd.compute_dtype(c)
    udtype = sd.update_dtype(c, dtype)
    seen = []
    group_compute = sd._group_compute

    def spy(g, ix, Cdata, updates, dt, *args, **kw):
        seen.append(sd._work_bytes(g, dt, kw.get("udtype"))
                    + sum(U.numel() * U.element_size()
                          for U in updates.values()))
        return group_compute(g, ix, Cdata, updates, dt, *args, **kw)

    monkeypatch.setattr(sd, "_group_compute", spy)
    F = sd.factorize_device(A, S, c, "cpu")
    costs = F.dplan.costs[dtype, udtype]
    assert F.ok and len(seen) == len(costs)
    assert sd._loop_bytes(F.dplan.plan, costs, udtype) == max(seen)


class _Owner:
    """What keeps a graph alive, as a :class:`FactorGraph` does."""


def test_held_bytes_follow_their_owners():
    """Held bytes add up by device while their owners live, and each
    owner's go when it is collected."""
    base = {i: sdev.graph_held_bytes(CUDA if i == 0 else
                                     torch.device("cuda", i))
            for i in (0, 1)}
    owners = [_Owner() for _ in range(3)]
    for o, (i, n) in zip(owners, ((0, 100), (0, 20), (1, 7))):
        sdev.hold_graph_bytes(o, torch.device("cuda", i), n)
    del o
    assert sdev.graph_held_bytes(CUDA) == base[0] + 120
    assert sdev.graph_held_bytes(torch.device("cuda", 1)) == base[1] + 7
    del owners[0]
    gc.collect()
    assert sdev.graph_held_bytes(CUDA) == base[0] + 20
    owners.clear()
    gc.collect()
    assert sdev.graph_held_bytes(CUDA) == base[0]
    assert sdev.graph_held_bytes(torch.device("cuda", 1)) == base[1]


def _fake_card(monkeypatch, free, reserved=3000, allocated=1000):
    """torch.cuda's memory readings of a card with ``free`` bytes free
    by ``mem_get_info`` and ``reserved - allocated`` cached by PyTorch."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: reserved)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: allocated)


def _w2_fits(need):
    """The solve's W2 gate on the factor's own plan, W2 needing ``need``
    bytes."""
    def check(monkeypatch):
        monkeypatch.setattr(supernodal_solve, "solve_ladder",
                            lambda F: "fine")
        monkeypatch.setattr(supernodal_solve, "_w2_need",
                            lambda plan, dtype, config: need)
        F = types.SimpleNamespace(
            Lx=types.SimpleNamespace(device=CUDA),
            dplan=types.SimpleNamespace(plan=None))
        return supernodal_solve._w2_fits(F, torch.float32, sstt.DEFAULT)
    return check


def _coarse_ladder(need):
    """The solve's coarse plan gate, the relayouted copy needing ``need``
    bytes."""
    def check(monkeypatch):
        monkeypatch.setattr(supernodal_solve, "_coarse_need", lambda F: need)
        F = types.SimpleNamespace(Lx=types.SimpleNamespace(device=CUDA))
        return supernodal_solve.solve_ladder(F) == "coarse"
    return check


def _one_piece(need):
    """The factor's auto budget, the one-piece factor needing ``need``
    bytes beyond an output of 100."""
    def check(monkeypatch):
        b = segmented.budget(sstt.DEFAULT, CUDA, 100)
        return need <= b
    return check


# free-memory check -> (check of a need, the need that just fits a card
# of 10000 bytes free by mem_get_info and 2000 cached ones)
FREE_READERS = {
    "free_bytes": (lambda need: lambda mp: need <= sdev.free_bytes(CUDA),
                   12000),
    "segment_budget": (_one_piece, 5950),
    "solve_coarse_ladder": (_coarse_ladder, 12000),
    "solve_w2_gate": (_w2_fits, 12000),
}


@pytest.mark.parametrize("reader", sorted(FREE_READERS))
def test_free_memory_checks_leave_out_held_pool_bytes(reader, monkeypatch):
    """Every free-memory check of the port counts PyTorch's cached
    blocks as free but not the free blocks a live graph's pool holds:
    a need that just fits no longer does once a graph holds a byte, and
    fits again when the graph is gone."""
    make, fits = FREE_READERS[reader]
    _fake_card(monkeypatch, 10000 + sdev.graph_held_bytes(CUDA))
    check = make(fits)
    assert check(monkeypatch)
    assert not make(fits + 2)(monkeypatch)
    owner = _Owner()
    sdev.hold_graph_bytes(owner, CUDA, 2)
    assert not check(monkeypatch)
    del owner
    gc.collect()
    assert check(monkeypatch)


# ----- on the card -----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return CUDA


def stepped(A, k, indefinite=False):
    """A's values for refactorization k: the diagonal shifted by k / 10,
    or one diagonal entry of the middle column made negative."""
    B = sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices, A.data.copy(), A.sym)
    cols = np.repeat(np.arange(A.ncol), np.diff(A.indptr))
    diag = np.flatnonzero(A.indices == cols)
    B.data[diag] += 0.1 * k
    if indefinite:
        B.data[diag[A.ncol // 2]] = -10.0
    return B


def launches():
    return {c: getattr(*c) for c in sd._LAUNCH_COUNTERS}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_replay_bit_equal_to_eager(dev, name):
    """Five factors of changed values on one analysis: the first eager,
    the second run on a side stream and captured, the rest replayed; each
    bit-equal to the eager loop on its values, each adding the eager
    factor's launches to the kernels' counters."""
    A, S, cfg = analysis(12)
    c = config(cfg, name)
    tile_rmin = 96        # fp32: K2 on 14 groups, K7 on 10, K1 on 2
    got = []
    for k in range(5):
        Ak = stepped(A, k)
        l0 = launches()
        F, d = counted(lambda: sd.factorize_device(Ak, S, c, dev, tile_rmin))
        dl = {key: v - l0[key] for key, v in launches().items()
              if v != l0[key]}
        got.append((d, dl))
        assert F.ok
        assert torch.equal(F.Lx, eager_lx(Ak, S, c, dev, tile_rmin)), k
    modes = [tuple(k for k in ("factor.graph.eager", "factor.graph.capture",
                               "factor.graph.replay") if d.get(k))
             for d, _dl in got]
    assert modes == [("factor.graph.eager",), ("factor.graph.capture",)] \
        + [("factor.graph.replay",)] * 3
    assert got[1][0]["graph_pool_bytes"] > 0
    eager_launches = got[0][1]
    assert all(dl == eager_launches for _d, dl in got[1:])
    if name == "float32":
        assert {fn.__name__ for (fn, attr) in eager_launches
                if attr == "launches"} == {"potrf_trsm", "extend_add_tiles",
                                           "extend_add"}


@pytest.mark.card
def test_earlier_factor_unchanged_by_later_replay(dev):
    A, S, cfg = analysis(12)
    Fs = [sd.factorize_device(stepped(A, k), S, cfg, dev) for k in range(3)]
    kept = Fs[2].Lx.clone()
    later = [sd.factorize_device(stepped(A, k), S, cfg, dev)
             for k in (3, 4)]
    assert torch.equal(Fs[2].Lx, kept)
    assert not torch.equal(later[-1].Lx, kept)
    assert Fs[2].Lx.data_ptr() != later[-1].Lx.data_ptr()


@pytest.mark.card
@pytest.mark.parametrize("name", ["float32", "float64"])
def test_indefinite_mid_sequence_gives_the_eager_minor(dev, name):
    A, S, cfg = analysis(12)
    c = config(cfg, name)
    seq = [stepped(A, k, indefinite=(k == 3)) for k in range(5)]
    Fs = [sd.factorize_device(Ak, S, c, dev) for Ak in seq]
    _A, S0, _c = analysis(12)
    want = sd.factorize_device(seq[3], S0, c, dev)   # its first: eager
    assert not want.ok and Fs[3].minor == want.minor
    assert all(F.ok for i, F in enumerate(Fs) if i != 3)
    assert torch.equal(Fs[4].Lx, eager_lx(seq[4], S, c, dev))


@pytest.mark.card
def test_segmented_factor_stays_eager(dev):
    A, S, cfg = analysis(6)
    seg = cfg.replace(segment_bytes=20000)
    for k in range(4):
        F, d = counted(lambda: sd.factorize_device(stepped(A, k), S, seg,
                                                   dev))
        assert F.ok and F.segments > 1
        assert d.get("factor.graph.eager") == 1
        assert not d.get("factor.graph.capture") and \
            not d.get("factor.graph.replay")
    assert F.dplan.graphs == {}


@pytest.mark.card
@pytest.mark.parametrize("how", ["estimate", "out_of_memory"])
def test_capture_that_does_not_fit_stays_eager(dev, how, monkeypatch):
    """The capture is dropped where the estimate passes the free memory,
    or where the capture runs out of it; the key then stays eager."""
    if how == "estimate":
        monkeypatch.setattr(sd, "_loop_bytes", lambda *a: 1 << 60)
    else:
        run_plan = sd._run_plan

        def short(*args, **kw):
            if torch.cuda.is_current_stream_capturing():
                raise torch.cuda.OutOfMemoryError("out of memory")
            return run_plan(*args, **kw)

        monkeypatch.setattr(sd, "_run_plan", short)
    A, S, cfg = analysis(8)
    key = sd._graph_key(cfg, torch.float32, torch.float32)
    for k in range(4):
        Ak = stepped(A, k)
        F, d = counted(lambda: sd.factorize_device(Ak, S, cfg, dev))
        assert d.get("factor.graph.eager") == 1 and \
            not d.get("factor.graph.replay"), d
        assert torch.equal(F.Lx, eager_lx(Ak, S, cfg, dev))
    assert F.dplan.graphs[key] is False


@pytest.mark.card
def test_traced_replay_keeps_the_groups_span(dev):
    """Under the profiler a replayed factor has its ``sst.factor.groups``
    span and no per-group span (those exist on eager calls only)."""
    A, S, cfg = analysis(8)
    for k in range(2):
        sd.factorize_device(stepped(A, k), S, cfg, dev)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as p:
        F, d = counted(lambda: sd.factorize_device(stepped(A, 2), S, cfg,
                                                   dev))
    names = [e.name for e in p.events()]
    assert d.get("factor.graph.replay") == 1
    assert names.count("sst.factor.groups") == 1
    assert "sst.factor.group" not in names
    assert torch.equal(F.Lx, eager_lx(stepped(A, 2), S, cfg, dev))


@pytest.mark.card
def test_graph_pool_free_blocks_held_while_it_lives(dev):
    """The bytes a capture holds are its pool's free blocks, counted as
    held until the graph is dropped (a segmented factor of its plan)."""
    A, S, cfg = analysis(12)
    gc.collect()
    base = sdev.graph_held_bytes(dev)
    for k in range(2):
        F = sd.factorize_device(stepped(A, k), S, cfg, dev)
    fg = F.dplan.graphs[sd._graph_key(cfg, torch.float32, torch.float32)]
    gc.collect()
    held = sdev.graph_held_bytes(dev) - base
    assert held > 0 and held == sd._pool_free(fg.graph)
    del fg
    F = sd.factorize_device(stepped(A, 2), S,
                            cfg.replace(segment_bytes=20000), dev)
    assert F.segments > 1 and F.dplan.graphs == {}
    gc.collect()
    assert sdev.graph_held_bytes(dev) == base


@pytest.mark.card
def test_second_key_budget_leaves_out_the_pool(dev, monkeypatch):
    """After an fp32 capture, an fp64 factor of the same plan under the
    auto budget, on a card whose free memory fits its one piece only if
    the fp32 graph's pool counted as free: it leaves the one piece (a
    segmented run, which lets the plan's upload and graphs go)."""
    gc.collect()                 # earlier tests' graphs
    torch.cuda.empty_cache()
    A, S, cfg = analysis(20)
    for k in range(2):
        F = sd.factorize_device(stepped(A, k), S, cfg, dev)
    dp = F.dplan
    need = segmented.one_piece_bytes(
        dp.index_bytes, sd._costs(dp, torch.float64, torch.float64))
    out = dp.plan.dev_size * 8
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    held = sdev.graph_held_bytes(dev)
    assert F.ok and held > 0 and dp.groups is not None
    cached = torch.cuda.memory_reserved(dev) \
        - torch.cuda.memory_allocated(dev) - held
    # the budget, half of (free + the plan's upload - the output), is
    # one byte short of the one piece, and reaches it with the pool
    reported = 2 * need - 1 - cached - dp.index_bytes + out
    assert reported >= 0
    total = torch.cuda.mem_get_info(dev)[1]
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (reported, total))
    F64 = sd.factorize_device(stepped(A, 2), S, config(cfg, "float64"), dev)
    assert F64.ok and dp.groups is None and dp.graphs == {}
    assert torch.equal(F64.Lx, eager_lx(stepped(A, 2), S,
                                        config(cfg, "float64"), dev))
