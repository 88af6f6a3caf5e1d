"""One rank of the port's two-process CPU jobs
(`tests/test_torch_multiprocess.py`).

Joins the gloo process group from the environment (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT, LOCAL_RANK, as `torch.distributed.run` sets
them), drives four CPU workers of the job's eight through
`distributed.search` and `_DistDriver`, and writes what it saw as JSON
(and, on rank 0, the gathered states as `.npz`) under OUT_DIR.

Usage: python tests/_torch_mp_worker.py OUT_DIR ONE_PROCESS_CHECKPOINT
"""

import json
import pathlib
import shutil
import sys

import numpy as np
import torch

from tpu_tree_search_torch import problems
from tpu_tree_search_torch.engine import checkpoint, distributed
from tpu_tree_search_torch.parallel import mesh
from tpu_tree_search_torch.problems.pfsp import PFSPInstance
from tpu_tree_search_torch.tune import cache

# the shape of tests/test_torch_distributed.py, on 8 workers
TABLE = PFSPInstance.synthetic(jobs=8, machines=4, seed=3).p_times
KW = dict(chunk=4, balance_period=2, transfer_cap=16, min_transfer=4,
          min_seed=4, capacity=1 << 10)
LOCAL = ["cpu"] * 4


def result(res) -> dict:
    return {"totals": [res.explored_tree, res.explored_sol, res.best,
                       res.complete],
            "per_device": {k: np.asarray(v).tolist()
                           for k, v in res.per_device.items()}}


def rounds(out_dir: pathlib.Path) -> None:
    """The gathered stacked state after 1, 2 and 3 macro-iterations (the
    JAX `fetch_state` at those ceilings), saved by rank 0."""
    prob = problems.get("pfsp")
    drv = distributed._problem_driver(
        prob, LOCAL, TABLE, 1, KW["chunk"], KW["balance_period"],
        KW["transfer_cap"], KW["min_transfer"])
    fr = prob.warmup(TABLE, 1, None, target=KW["min_seed"] * 8)
    fr.aux = prob.seed_aux(TABLE, fr.prmu, fr.depth)
    states = drv.seed(fr, KW["capacity"], TABLE.shape[1], fr.best)
    for k in (1, 2, 3):
        states = drv.run(states, max_iters=k * KW["balance_period"])
        host = distributed.fetch_state(states)
        if mesh.process_index() == 0:
            np.savez(out_dir / f"round{k}.npz", **host._asdict())


def main() -> None:
    out_dir, one_proc_ck = pathlib.Path(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    mesh.init_processes()
    rank = mesh.process_index()
    report = {"rank": rank, "world": mesh.process_count(),
              "fingerprint": cache.tuning_fingerprint(device="cpu")}

    report["plain"] = result(distributed.search(
        TABLE, lb_kind=1, devices=LOCAL, **KW))
    rounds(out_dir)

    # a truncated segmented run with a checkpoint: every write is counted
    writes = []
    orig = checkpoint._write_snapshot

    def counted(path, arrays):
        writes.append(str(path))
        return orig(path, arrays)

    checkpoint._write_snapshot = counted
    ck = out_dir / "mp.npz"
    report["trunc"] = result(distributed.search(
        TABLE, lb_kind=1, devices=LOCAL, segment_iters=2, max_rounds=2,
        checkpoint_path=str(ck), **KW))
    report["trunc_writes"] = len(writes)
    if rank == 0:
        shutil.copy(ck, out_dir / "mp_copy.npz")
    report["resume"] = result(distributed.search(
        TABLE, lb_kind=1, devices=LOCAL, checkpoint_path=str(ck), **KW))
    report["resume_writes"] = len(writes)
    # a one-process checkpoint resumed by the two processes
    report["from_one"] = result(distributed.search(
        TABLE, lb_kind=1, devices=LOCAL, checkpoint_path=one_proc_ck,
        **KW))
    (out_dir / f"rank{rank}.json").write_text(json.dumps(report))


if __name__ == "__main__":
    main()
