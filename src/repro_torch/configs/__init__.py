"""The ``--arch`` registry and the shape cells (a copy of
``repro.configs``): the ten architecture configs, field for field equal
to the JAX package's."""
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, LONG_CONTEXT_ARCHS, cell_is_applicable, get_config)
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: F401
