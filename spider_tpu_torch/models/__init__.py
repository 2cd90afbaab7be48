"""Model zoo of the PyTorch port. Importing a module registers its
classes with spider_tpu_torch.common.registry."""
