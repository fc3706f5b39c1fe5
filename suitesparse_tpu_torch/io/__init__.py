"""Matrix I/O of the port: Matrix Market, Rutherford-Boeing, the local
matrix-collection cache (``ssget``), and the test-matrix generators."""

from . import fixtures
from .collection import Collection, default_collection, ssget
from .matrix_market import read_matrix_market, write_matrix_market
from .rutherford_boeing import read_rb, write_rb

__all__ = ["fixtures", "read_matrix_market", "write_matrix_market",
           "read_rb", "write_rb", "Collection", "default_collection", "ssget"]
