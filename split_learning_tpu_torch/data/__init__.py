from split_learning_tpu_torch.data.datasets import (
    Dataset, DatasetStore, DevicePrefetch, LocalStore, Split, batches,
    epoch_steps, load_dataset, load_mnist_idx, synthetic, synthetic_lm,
    synthetic_tokens)

__all__ = ["Dataset", "DatasetStore", "DevicePrefetch", "LocalStore",
           "Split", "batches", "epoch_steps", "load_dataset",
           "load_mnist_idx", "synthetic", "synthetic_lm", "synthetic_tokens"]
