"""Data layer: the deterministic token pipeline and the sketch telemetry
(port of ``repro.data``)."""
from repro_torch.data.pipeline import SyntheticCorpus, batch_for_step  # noqa: F401
from repro_torch.data.telemetry import RoutingSketch, NGramSketch  # noqa: F401
