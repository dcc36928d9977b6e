"""repro_torch.api — the declarative front door of the port.

    from repro_torch.api import Session, SessionConfig

    with Session(SessionConfig(partition_size=64)) as sess:   # on the card
        frame = (sess.frame(corpus)
                 .sem_filter("mentions topic 1", task_id=1)
                 .sem_map("extract field 2", task_id=2)
                 .with_guarantees(recall=0.75, precision=0.75))
        print(frame.explain())          # plan + cascade table, no execution
        result = frame.execute()        # streaming runtime, full corpus
        print(result.metrics())         # lazy gold comparison

Two corpora join through `frame.sem_join(other_frame, text, task_id,
on=column)`, a JoinFrame with the same `.explain()` / `.execute()` /
`.metrics()` verbs. `Session(..., device="cpu")` runs the same path on
the CPU with the kernels' plain versions. The api package adds no
planning or execution logic of its own: it compiles to
`core.planner.plan_query` / `plan_tree` and `runtime.executor.run_plan` /
`iter_plan` / `runtime.tree.run_tree`.
"""
from repro_torch.api.explain import (ExplainReport, ExplainStage,
                                     TreeExplainReport)
from repro_torch.api.frame import JoinFrame, SemFrame
from repro_torch.api.result import JoinResult, QueryResult, ResultStream
from repro_torch.api.session import EngineSpec, Session, SessionConfig

__all__ = ["EngineSpec", "ExplainReport", "ExplainStage", "JoinFrame",
           "JoinResult", "QueryResult", "ResultStream", "SemFrame",
           "Session", "SessionConfig", "TreeExplainReport"]
