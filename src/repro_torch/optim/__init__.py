"""The optimiser of the LM training path (port of ``repro.optim``):
AdamW, the cosine schedule and int8 gradient compression."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    int8_compress, int8_decompress, compressed_psum,
)
