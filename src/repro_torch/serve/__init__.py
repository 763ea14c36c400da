"""repro_torch.serve — serving engines built from Kvik scheduling policies."""

from .early_exit import (DecodeStats, decode_until_eos, make_decode_block,
                         make_decode_tick)
from .engine import (AdmissionSimulator, ContinuousEngine, Engine,
                     EngineConfig, EngineTelemetry, QueueFull, Request)
from .kvcache import PageTable, cache_bytes, cache_slot_insert
from .prefill import ChunkedPrefill, PrefillStats
from .slo import (CLASS_RANK, SLO_CLASSES, DeadlineServePolicy,
                  FifoServePolicy, PriorityServePolicy, ServePolicy,
                  request_deadline)

__all__ = [
    "AdmissionSimulator", "ChunkedPrefill", "ContinuousEngine", "DecodeStats", "Engine",
    "EngineConfig", "EngineTelemetry", "PageTable", "PrefillStats",
    "QueueFull", "Request", "cache_bytes", "cache_slot_insert",
    "decode_until_eos", "make_decode_block", "make_decode_tick",
    "SLO_CLASSES", "CLASS_RANK", "request_deadline", "ServePolicy",
    "FifoServePolicy", "PriorityServePolicy", "DeadlineServePolicy",
]
