"""The search server: an in-process asynchronous request scheduler.

Reproduces `tpu_tree_search/service/__init__.py`'s exports, but for
`AOTCache` (ROADMAP A9d):

- `SearchRequest`, `RequestRecord` and the request states (request.py)
- `SearchServer`: submit, status, result, cancel and preempt over
  partitioned submeshes, with priority preemption and loop reuse
  (server.py)
- `AdmissionError`, `RequestQueue`: the bounded wait line (queueing.py)
- `ExecutorCache`: serve many, capture once (executors.py)
- `spool`: the file front-end of the `serve` and `client` commands
  (spool.py)
- `RequestLedger`: the durable write-ahead journal of request state
  transitions, replayed at boot (ledger.py), under a fenced lease in a
  fleet (lease.py, failover.py); `portfolio.py` races K configurations
"""

from .executors import ExecutorCache
from .ledger import RequestLedger
from .queueing import AdmissionError, RequestQueue
from .request import (CANCELLED, DEADLINE, DONE, FAILED, PREEMPTED, QUEUED,
                      RUNNING, TERMINAL_STATES, RequestRecord, SearchRequest)
from .server import SearchServer

__all__ = [
    "AdmissionError", "ExecutorCache", "RequestLedger",
    "RequestQueue",
    "RequestRecord",
    "SearchRequest", "SearchServer",
    "QUEUED", "RUNNING", "PREEMPTED", "DONE", "CANCELLED", "DEADLINE",
    "FAILED", "TERMINAL_STATES",
]
