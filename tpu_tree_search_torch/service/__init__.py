"""The search server: an in-process asynchronous request scheduler.

Reproduces `tpu_tree_search/service/__init__.py`'s exports, but for
`AOTCache` and `RequestLedger` (ROADMAP A9c):

- `SearchRequest`, `RequestRecord` and the request states (request.py)
- `SearchServer`: submit, status, result, cancel and preempt over
  partitioned submeshes, with priority preemption and loop reuse
  (server.py)
- `AdmissionError`, `RequestQueue`: the bounded wait line (queueing.py)
- `ExecutorCache`: serve many, capture once (executors.py)
- `spool`: the file front-end of the `serve` and `client` commands
  (spool.py)
"""

from .executors import ExecutorCache
from .queueing import AdmissionError, RequestQueue
from .request import (CANCELLED, DEADLINE, DONE, FAILED, PREEMPTED, QUEUED,
                      RUNNING, TERMINAL_STATES, RequestRecord, SearchRequest)
from .server import SearchServer

__all__ = [
    "AdmissionError", "ExecutorCache",
    "RequestQueue",
    "RequestRecord",
    "SearchRequest", "SearchServer",
    "QUEUED", "RUNNING", "PREEMPTED", "DONE", "CANCELLED", "DEADLINE",
    "FAILED", "TERMINAL_STATES",
]
