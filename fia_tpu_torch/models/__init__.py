"""The latent-factor models (port of ``fia_tpu/models``): MF and NCF
over dicts of tensors."""

from fia_tpu_torch.models.base import LatentFactorModel, params_from_numpy  # noqa: F401
from fia_tpu_torch.models.mf import MF  # noqa: F401
from fia_tpu_torch.models.ncf import NCF  # noqa: F401

MODELS = {"MF": MF, "NCF": NCF}
