"""Matrix I/O of the port: Matrix Market, Rutherford-Boeing, and the
test-matrix generators."""

from . import fixtures
from .matrix_market import read_matrix_market, write_matrix_market
from .rutherford_boeing import read_rb, write_rb

__all__ = ["fixtures", "read_matrix_market", "write_matrix_market",
           "read_rb", "write_rb"]
