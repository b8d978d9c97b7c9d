"""Failover runtime: the deterministic fault plan and the writer's
checkpoint cadence (``faults``, ``ft``)."""
