"""Core of the port: query model, graph container, superstep primitives, the
dense executor (``engine.py``) and the type-sliced executor
(``engine_sliced.py``), and the pure-Python oracle (``ref_engine.py``)."""
from . import intervals, query  # noqa: F401
from .engine import (MODE_BUCKET, MODE_INTERVAL, MODE_STATIC,  # noqa: F401
                     count_results, execute, execute_batch, execute_batch_out)
from .graph import PropColumn, TemporalGraph  # noqa: F401
from .ref_engine import RefEngine  # noqa: F401
