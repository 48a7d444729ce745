"""repro_torch.data — corpus synthesis, dedup ingest pipeline, batch loader.

The port of ``repro/data``: ``corpus`` and ``loader`` are numpy copies,
``pipeline.DedupIngest`` chunks and fingerprints on the device.
"""
from .corpus import container_corpus, load_dataset, snapshot_series, vm_image_like  # noqa: F401
from .loader import LoaderConfig, TokenLoader  # noqa: F401
from .pipeline import DedupIngest, PipelineConfig  # noqa: F401
