"""ray_tpu_torch.data — streaming datasets for SPMD ingest, the port of
`ray_tpu/data/`.

Reference equivalent: `python/ray/data/` (Dataset, read_api, streaming
executor). Blocks are dict-of-numpy batches, executed lazily through a
bounded-window task pool; `split_for_workers` gives each training worker a
disjoint shard (`session.get_dataset_shard`), and `iter_torch_batches`
lands its batches on the card.
"""

from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.dataset import (Dataset, GroupedData, from_blocks,
                                        from_items, from_numpy, from_pandas,
                                        range, read_csv, read_json,
                                        read_parquet)
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

__all__ = [
    "Block", "Dataset", "DatasetPipeline", "GroupedData", "range",
    "from_blocks", "from_items", "from_numpy", "from_pandas", "read_csv",
    "read_json", "read_parquet",
]
