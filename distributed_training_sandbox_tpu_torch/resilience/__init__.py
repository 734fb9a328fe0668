"""Run-level fault tolerance of the port: the JAX package's
``resilience/`` package (``state``, ``faults``, ``supervisor``, and the
part of ``elastic`` they reach).

The headline guarantee, restated here and pinned bitwise by
``tests/test_torch_resilience.py`` on gloo ranks and by
``chip_smoke.py`` phase 14 on the card: preempt a run at step k, resume
it, and the stitched loss sequence equals the uninterrupted run's, bit
for bit — including the host data cursor and the generator states.
"""

from .elastic import (  # noqa: F401
    Heartbeat,
    StepTimeoutError,
    Watchdog,
    WorkerLost,
    read_heartbeats,
)
from .faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    InjectedCrash,
    corrupt_checkpoint,
    parse_fault_spec,
    truncate_checkpoint,
    unreaped_workers,
)
from .state import (  # noqa: F401
    CheckpointCorruptError,
    Checkpointer,
    RunState,
    generator_states,
    restore_run_state,
    save_run_state,
)
from .supervisor import (  # noqa: F401
    GracefulShutdown,
    Preempted,
    ResilienceContext,
    Supervisor,
)
