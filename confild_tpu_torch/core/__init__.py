from confild_tpu_torch.core import normalize, packing, schedules, slicing  # noqa: F401
