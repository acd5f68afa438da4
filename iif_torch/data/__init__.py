"""Classification data: port of ``iif_tpu/data`` (long-tailed CIFAR and
txt-list datasets, epoch samplers, the batch loader, the augmentations
on the device)."""
