"""Data substrate of the port: the synthetic class-mixture stand-ins for the
paper's Table 1 datasets."""
from repro_torch.data.synthetic import DATASETS, make_dataset

__all__ = ["DATASETS", "make_dataset"]
