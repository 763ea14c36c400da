"""repro_torch.core — the port's own copy of the Kvik policy layer that the
serving path uses.  Plain Python: no torch, no JAX.

* Divisibles:  ``WorkRange``, ``SeqWork``
* Adaptors:    ``bound_depth``/``BoundDepth``, ``even_levels``/
               ``EvenLevels``, ``cap``/``Cap``, ``StealContext``
* Plans:       ``PlanNode``, ``Plan``, ``build_plan``, ``demand_split``,
               ``geometric_blocks``; the sort's schedule metadata
               ``DigitPass``, ``digit_passes``, ``MergeLevel``,
               ``SortSchedule``, ``MULTI_TILE_LAUNCHES_PER_PASS``
* Schedulers:  ``ByBlocks``, ``BlockStats``
"""

from .divisible import Divisible, WorkRange, SeqWork
from .adaptors import (Adaptor, StealContext, BoundDepth,
                       bound_depth, EvenLevels, even_levels, Cap, cap)
from .plan import (Plan, PlanNode, build_plan, demand_split,
                   geometric_blocks, DigitPass, digit_passes, MergeLevel,
                   SortSchedule, MULTI_TILE_LAUNCHES_PER_PASS)
from .schedulers import ByBlocks, BlockStats

__all__ = [
    "Divisible", "WorkRange", "SeqWork",
    "Adaptor", "StealContext", "BoundDepth", "bound_depth",
    "EvenLevels", "even_levels", "Cap", "cap",
    "Plan", "PlanNode", "build_plan", "demand_split", "geometric_blocks",
    "DigitPass", "digit_passes", "MergeLevel", "SortSchedule",
    "MULTI_TILE_LAUNCHES_PER_PASS",
    "ByBlocks", "BlockStats",
]
