from .collate import CollateConfig, collate_fn
from .fixtures import make_dataset, make_sample

__all__ = ["CollateConfig", "collate_fn", "make_dataset", "make_sample"]
