"""Physics-fidelity and accuracy metrics of saved fields."""

from confild_tpu_torch.analysis import metrics  # noqa: F401
