"""Dataset layer: pair-file parsing, length bucketing and FASTA ingestion
(the port's copies of tpu_align/io/dataset.py, bucketing.py and
fasta.py)."""

from tpu_align_torch.io.bucketing import Bucket, BucketSpec, bucketize
from tpu_align_torch.io.dataset import (
    DatasetStats,
    PairDataset,
    parse_pair_file,
    parse_pair_text,
    write_pair_file,
)

__all__ = ["PairDataset", "DatasetStats", "parse_pair_file",
           "parse_pair_text", "write_pair_file", "Bucket", "BucketSpec",
           "bucketize"]
