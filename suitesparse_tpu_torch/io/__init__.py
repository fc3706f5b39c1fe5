"""Test-matrix generators of the port."""

from . import fixtures

__all__ = ["fixtures"]
