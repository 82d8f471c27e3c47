"""Serving layer of the port: the batched LM ``Engine`` (``engine.py``),
the multi-tenant sparse-matrix router (autotuned ingest, warm-start
program artifacts, batched multi-RHS SpMV, feature-keyed plan cache,
cross-request micro-batching) on the device executor, and the online
rebalancing subsystem that keeps serving plans matched to the live
request mix (``rebalance.py``)."""
from .engine import Engine, ServeConfig
from .router import IngestedMatrix, MicroBatchConfig, SparseMatrixEngine
from .rebalance import LoadMonitor, RebalanceConfig, RebalanceEvent

__all__ = ["Engine", "ServeConfig", "SparseMatrixEngine", "IngestedMatrix",
           "MicroBatchConfig", "LoadMonitor", "RebalanceConfig",
           "RebalanceEvent"]
