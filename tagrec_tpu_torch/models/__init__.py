"""Model zoo of the port (tagrec_tpu/models): DGCF (dense forward), KGAT
(dense flash tier) and LightGCN (dense sectors, hybrid and ELL tiers)."""

from tagrec_tpu_torch.models.dgcf import DGCF
from tagrec_tpu_torch.models.kgat import KGAT
from tagrec_tpu_torch.models.lightgcn import LightGCN

MODEL_REGISTRY = {"dgcf": DGCF, "kgat": KGAT, "lightgcn": LightGCN}


def model_class(name: str):
    """The model class registered as ``name``."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; the port has: "
                         f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


__all__ = ["DGCF", "KGAT", "LightGCN", "MODEL_REGISTRY", "model_class"]
