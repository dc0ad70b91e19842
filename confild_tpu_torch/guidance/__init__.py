from confild_tpu_torch.guidance import methods, noise, operators, sampler  # noqa: F401
from confild_tpu_torch.guidance.methods import get_conditioning_method  # noqa: F401
from confild_tpu_torch.guidance.noise import get_noise  # noqa: F401
from confild_tpu_torch.guidance.operators import get_operator  # noqa: F401
from confild_tpu_torch.guidance.sampler import create_sampler  # noqa: F401
