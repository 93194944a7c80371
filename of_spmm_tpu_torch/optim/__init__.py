"""Optimisation helpers. The optimizers themselves are torch.optim's;
``lr_scheduler`` holds the learning-rate schedules of the JAX package
that the training example uses."""

from of_spmm_tpu_torch.optim import lr_scheduler

__all__ = ["lr_scheduler"]
