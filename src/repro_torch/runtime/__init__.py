"""Fault-tolerant runtime (port of ``repro.runtime``).

``ft`` holds the per-step machinery (the async-checkpointed
``train_loop``, the retry policy, the warmup-aware
``StragglerWatchdog``); ``coordinator`` the multi-host failover control
loop (heartbeat leases, eviction, elastic restore, ``m_ingested``
resume) and ``faults`` its deterministic fault plan. The coordinator
imports the engine stack, so it is not re-exported here:
``from repro_torch.runtime.coordinator import ...`` (``ft.coordinator``
imports it on call).
"""
from repro_torch.runtime.ft import (  # noqa: F401
    FTConfig, StragglerWatchdog, coordinator, train_loop,
)
