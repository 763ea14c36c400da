"""repro_torch.chaos — deterministic fault injection for the serving layer.

The virtual-time half of a :class:`~repro_torch.core.faults.FaultPlan`
(worker deaths, slowdowns) is consumed directly by the core Runtime; this
package consumes its serving half: slot deaths injected through the
engine's ``kill_slot`` hook during a wall-clock trace :func:`replay`.  The
train-side injectors (checkpoint I/O faults, corruption, SIGTERM and host
death during training) come with the train layer.
"""

from .serving import (ReplayResult, SlotDeathInjector, TraceItem,
                      make_request, replay, slo_mix_trace)

__all__ = [
    "TraceItem", "ReplayResult", "SlotDeathInjector", "make_request",
    "slo_mix_trace", "replay",
]
