"""Model definitions; importing the package registers the whole decoder zoo
(``cnf_zoo`` adds its names to ``cnf.NF_REGISTRY``), as
``confild_tpu/models/__init__.py`` does."""

from confild_tpu_torch.models import cnf, cnf_zoo, nn, unet  # noqa: F401
