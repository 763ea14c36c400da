"""repro_torch.core — the port's own copy of Kvik's policy layer, line for
line with ``repro.core``.  Plain Python: it imports neither torch nor JAX.

Public surface:

* Divisibles:  ``WorkRange``, ``BatchWork``, ``SeqWork``, ``TileGrid2D``,
               ``ZipDivisible``, ``PermRange``
* Adaptors:    ``bound_depth``, ``even_levels``, ``force_depth``,
               ``size_limit``, ``cap``, ``join_context``, ``thief_splitting``
* Schedulers:  ``JoinScheduler``/``schedule_join``, ``ByBlocks``/``by_blocks``,
               ``AdaptiveScheduler``/``adaptive``
* Plans:       ``build_plan``, ``demand_split``, ``geometric_blocks``
* Faults:      ``FaultPlan`` + event types (``WorkerDeath``, ``Slowdown``,
               ``CheckpointWriteFault``, ``CorruptionFault``,
               ``PreemptionFault``, ``HostDeath``) — deterministic fault
               injection into the Runtime and the chaos harness
* D&C:         ``wrap_iter``, ``work_loop``
* Runtime:     ``Runtime`` (the one discrete-event engine) + ``CostModel``/
               ``SimResult``; policies ``JoinPolicy``, ``DepJoinPolicy``,
               ``AdaptivePolicy``, ``StaticPartitionPolicy``,
               ``ByBlocksPolicy`` and the ``simulate`` face.  Legacy shims:
               ``WorkStealingSim``, ``AdaptiveSim``, ``static_partition_sim``.
"""

from .divisible import (Divisible, Producer, WorkRange, BatchWork, SeqWork,
                        TileGrid2D, ZipDivisible, WorkSet, PermRange,
                        total_permutations)
from .adaptors import (Adaptor, StealContext, bound_depth, even_levels,
                       force_depth, size_limit, cap, join_context,
                       thief_splitting, tagged, find_tag, BoundDepth,
                       EvenLevels, ForceDepth, SizeLimit, Cap, JoinContext,
                       ThiefSplitting, Tagged)
from .plan import (Plan, PlanNode, MergeLevel, DigitPass, SortSchedule,
                   MULTI_TILE_LAUNCHES_PER_PASS, digit_passes, build_plan,
                   demand_split, geometric_blocks)
from .schedulers import (JoinScheduler, schedule_join, ByBlocks, by_blocks,
                         BlockStats, AdaptiveScheduler, adaptive)
from .dnc import wrap_iter, WrappedIter, work_loop
from .faults import (FaultPlan, WorkerDeath, Slowdown, CheckpointWriteFault,
                     CorruptionFault, PreemptionFault, HostDeath, SlotDeath)
from .runtime import CostModel, SimResult, Task, Runtime
from .policies import (SchedulingPolicy, JoinPolicy, DepJoinPolicy,
                       AdaptivePolicy, StaticPartitionPolicy, ByBlocksPolicy,
                       PriorityPolicy, DeadlinePolicy, simulate)
from .simruntime import WorkStealingSim, AdaptiveSim, static_partition_sim

__all__ = [
    "Divisible", "Producer", "WorkRange", "BatchWork", "SeqWork",
    "TileGrid2D", "ZipDivisible", "WorkSet", "PermRange",
    "total_permutations",
    "Adaptor", "StealContext", "bound_depth", "even_levels", "force_depth",
    "size_limit", "cap", "join_context", "thief_splitting", "tagged",
    "find_tag", "BoundDepth", "EvenLevels", "ForceDepth", "SizeLimit", "Cap",
    "JoinContext", "ThiefSplitting", "Tagged",
    "Plan", "PlanNode", "MergeLevel", "DigitPass", "SortSchedule",
    "digit_passes", "MULTI_TILE_LAUNCHES_PER_PASS", "build_plan",
    "demand_split", "geometric_blocks",
    "JoinScheduler", "schedule_join", "ByBlocks", "by_blocks", "BlockStats",
    "AdaptiveScheduler", "adaptive",
    "wrap_iter", "WrappedIter", "work_loop",
    "FaultPlan", "WorkerDeath", "Slowdown", "CheckpointWriteFault",
    "CorruptionFault", "PreemptionFault", "HostDeath", "SlotDeath",
    "CostModel", "SimResult", "Task", "Runtime",
    "SchedulingPolicy", "JoinPolicy", "DepJoinPolicy", "AdaptivePolicy",
    "StaticPartitionPolicy", "ByBlocksPolicy", "PriorityPolicy",
    "DeadlinePolicy", "simulate",
    "WorkStealingSim", "AdaptiveSim", "static_partition_sim",
]
