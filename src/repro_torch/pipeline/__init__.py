"""Request-log data pipeline (torch port of ``repro/pipeline``): online
watermark join -> on-disk ROO shards -> async prefetching training loader
with a deterministic resume cursor.

Stages:

  events (data/events.py)
    -> WatermarkJoiner          (pipeline/joiner.py)   bounded-lateness join
    -> ShardWriter / manifest   (pipeline/shards.py)   columnar ROO shards
    -> PrefetchLoader           (pipeline/prefetch.py) background decode,
                                                       pack, copy to the card
    -> Trainer.run              (pipeline/resume.py)   (shard, offset) cursor
"""
from repro_torch.data.storage import ShardCorruptionError
from repro_torch.pipeline.joiner import (JoinStats, OnlineJoinConfig,
                                         WatermarkJoiner)
from repro_torch.pipeline.prefetch import (Cursor, DatasetStats, LoaderStats,
                                           PrefetchLoader, ShardDataset)
from repro_torch.pipeline.resume import (CursorStore, PipelineDataSource,
                                         make_data_source)
from repro_torch.pipeline.shards import (ShardInfo, ShardManifest,
                                         ShardWriter, load_manifest,
                                         read_all, read_shard, write_samples)

__all__ = [
    "JoinStats", "OnlineJoinConfig", "WatermarkJoiner",
    "Cursor", "DatasetStats", "LoaderStats", "PrefetchLoader",
    "ShardCorruptionError", "ShardDataset",
    "CursorStore", "PipelineDataSource", "make_data_source",
    "ShardInfo", "ShardManifest", "ShardWriter",
    "load_manifest", "read_all", "read_shard", "write_samples",
]
