"""The control (the program's own lower-precision path) fails the cell's
limits where the program meets them; and a run with its timed path broken
underneath comes out not correct."""

import numpy as np
import pytest

from bench_port import harness

CELLS = ("lap3d80_fp32.refactor", "hpcg27_80_fp64.refactor")
SMALL = {"lap3d80_fp32.refactor": 16, "hpcg27_80_fp64.refactor": 10}


def small_cell(name, g=None):
    cell = harness.Cell(name)
    g = g or SMALL[name]
    return harness.Cell(name, config=dict(cell.config, nx=g, ny=g, nz=g))


def drive(cell, device="cpu", control=False, seed=20260, steps=6):
    """The rest of a run without the look for a chip: set-up, a window of
    ``steps`` steps, the program let go, the reference's verdict."""
    import torch
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        run = harness.Run(cell, device, control=control)
        k = run.setup(seed)
        for _ in range(steps):
            k = run.window(k, 0.0)
        ks = run.sample()
        run.free()
        readings = run.judge(ks)
        return harness.verdict(run, ks, readings)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, check = drive(small_cell(name))
    assert ok, check


def test_fp64_control_fails():
    """fp64 cell: its control, a float32 factor, fails a limit."""
    ok, check = drive(small_cell("hpcg27_80_fp64.refactor"), control=True)
    assert not ok, check


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_fails(name, monkeypatch):
    """A factor step that returns its state unchanged: every step gets the
    first factor of the run."""
    import suitesparse_tpu_torch as sstt
    real = sstt.factorize
    first = []

    def stale(A, S, config, device):
        if not first:
            first.append(real(A, S, config, device))
        return first[0]

    monkeypatch.setattr(sstt, "factorize", stale)
    ok, check = drive(small_cell(name))
    assert not ok, check


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_fails(name, monkeypatch):
    """An answer altered where it is produced: one entry of every x off by
    a hundredth of the largest."""
    import suitesparse_tpu_torch as sstt
    real = sstt.solve

    def altered(F, b, config):
        x = np.array(real(F, b, config))
        x[len(x) // 3] += 1e-2 * np.abs(x).max()
        return x

    monkeypatch.setattr(sstt, "solve", altered)
    ok, check = drive(small_cell(name))
    assert not ok, check


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, cuda):
    """On the card, at the cell's own size, on three seeds: the program
    meets the limits and its control does not."""
    cell = harness.Cell(name)
    for seed in (31, 32, 33):
        ok, check = drive(cell, cuda, seed=seed)
        assert ok, check
        bad, check = drive(cell, cuda, control=True, seed=seed)
        assert not bad, check
