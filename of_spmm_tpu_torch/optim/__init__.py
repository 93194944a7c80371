"""optim: the JAX package's optimizers, schedules and row-sparse updates.

``adam(lr=...)`` and the other factories return an ``Optimizer`` whose
``init(parameters)`` builds a ``torch.optim.Optimizer`` (torch's own
classes where torch has the rule, ``Lamb`` and ``Ftrl`` written here);
``lr`` may be a schedule from ``lr_scheduler``, evaluated at the
optimizer's own step count from 1, as in JAX. ``indexed_slices`` holds
the row-sparse gradients and the lazy SGD / Adam updates of an embedding
table."""

from of_spmm_tpu_torch.optim import lr_scheduler
from of_spmm_tpu_torch.optim.indexed_slices import (
    IndexedSlices,
    reduce_ids,
    sparse_adam_update,
    sparse_lookup,
    sparse_sgd_update,
    sparse_value_and_grad,
)
from of_spmm_tpu_torch.optim.optimizers import (
    Ftrl,
    Lamb,
    Optimizer,
    adadelta,
    adagrad,
    adam,
    adamw,
    clip_grad_norm,
    ftrl,
    lamb,
    rmsprop,
    sgd,
)

__all__ = [
    "Optimizer",
    "Lamb",
    "Ftrl",
    "sgd",
    "adam",
    "adamw",
    "lamb",
    "ftrl",
    "rmsprop",
    "adagrad",
    "adadelta",
    "clip_grad_norm",
    "lr_scheduler",
    "IndexedSlices",
    "reduce_ids",
    "sparse_adam_update",
    "sparse_lookup",
    "sparse_sgd_update",
    "sparse_value_and_grad",
]
