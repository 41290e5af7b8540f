from .pipeline import (DataConfig, SyntheticLMDataset,  # noqa: F401
                       make_train_iterator)
