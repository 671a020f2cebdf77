"""The deterministic data pipeline (counterpart of `repro.data`)."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    MemmapSource,
    Prefetcher,
    SyntheticSource,
    make_source,
)
