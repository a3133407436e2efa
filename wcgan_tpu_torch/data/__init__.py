"""Dataset pipelines: local-file loaders + synthetic data.

The port's own copy of ``wcgan_tpu.data`` (numpy only). Every loader
reads the canonical on-disk archive layout from ``--data_dir``;
``synthetic`` needs no files and backs the smoke tests.
"""

from wcgan_tpu_torch.data.base import ArrayDataset  # noqa: F401
from wcgan_tpu_torch.data.datasets import DATASETS, get_dataset  # noqa: F401
