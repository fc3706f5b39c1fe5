"""Minimal statement-coverage tracker (the Tcov discipline, stdlib-only).

The reference's Tcov suite holds CHOLMOD to 100% statement coverage
INCLUDING error handling (``CHOLMOD/Tcov/README.txt:17-26``). This is a
tracker with no dependency beyond the standard library, on
``sys.monitoring`` (PEP 669, Python 3.12): LINE events record executed
lines per file; the executable-line universe comes from walking the
compiled module's code-object tree (``co_lines``), so the denominator is
exact — not a source-text heuristic.

The port's copy of the JAX package's ``coverage.py``: a test puts a
measured floor under modules by running code under it.
"""

from __future__ import annotations

import sys

__all__ = ["LineCoverage", "executable_lines"]

_TOOL_ID = 4                      # sys.monitoring.PROFILER_ID is 2; use a
                                  # free slot (0-5) not used by pytest/pdb


def executable_lines(path: str, split: bool = False):
    """Executable line numbers of a source file (code-object walk).

    With ``split=True`` returns ``(module_level, nested)``: module-level
    lines (imports, def/class statements, dataclass fields) execute at
    import time — before any tracker can start — so the gate counts them
    as import-covered and measures the nested (function-body) universe."""
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    top: set = set()
    nested: set = set()
    stack = [(code, True)]
    while stack:
        co, is_top = stack.pop()
        for _, _, ln in co.co_lines():
            if ln is not None and ln > 0:
                (top if is_top else nested).add(ln)
        for const in co.co_consts:
            if hasattr(const, "co_lines"):
                # class bodies run when their enclosing scope runs (they
                # set __qualname__ as their first op); function bodies run
                # only when called
                is_class = "__qualname__" in const.co_names
                stack.append((const, is_top and is_class))
    nested -= top
    if split:
        return top, nested
    return top | nested


class LineCoverage:
    """Context manager recording executed lines for a set of files."""

    def __init__(self, paths):
        self.paths = {str(p) for p in paths}
        self.hit: dict = {p: set() for p in self.paths}

    def _on_line(self, code, line):
        f = code.co_filename
        if f in self.hit:
            self.hit[f].add(line)
        return sys.monitoring.DISABLE if f not in self.hit else None

    def __enter__(self):
        mon = sys.monitoring
        mon.use_tool_id(_TOOL_ID, "sstpu-cov")
        mon.register_callback(_TOOL_ID, mon.events.LINE, self._on_line)
        mon.set_events(_TOOL_ID, mon.events.LINE)
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        mon.set_events(_TOOL_ID, 0)
        mon.register_callback(_TOOL_ID, mon.events.LINE, None)
        mon.free_tool_id(_TOOL_ID)
        return False

    def report(self) -> dict:
        """{path: (hit, total, fraction, sorted missed lines)} over the
        function-body universe (module-level lines are import-covered)."""
        out = {}
        for p in sorted(self.paths):
            _, nested = executable_lines(p, split=True)
            hit = self.hit[p] & nested
            missed = sorted(nested - hit)
            out[p] = (len(hit), len(nested),
                      len(hit) / max(len(nested), 1), missed)
        return out
