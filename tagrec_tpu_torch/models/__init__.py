"""Model zoo of the port (tagrec_tpu/models): DGCF and DisenGCN (dense
routing tier), KGAT (dense flash tier) and LightGCN (dense sectors, hybrid
and ELL tiers)."""

from tagrec_tpu_torch.models.dgcf import DGCF
from tagrec_tpu_torch.models.disengcn import DisenGCN
from tagrec_tpu_torch.models.kgat import KGAT
from tagrec_tpu_torch.models.lightgcn import LightGCN

MODEL_REGISTRY = {"dgcf": DGCF, "disengcn": DisenGCN, "kgat": KGAT,
                  "lightgcn": LightGCN}


def model_class(name: str):
    """The model class registered as ``name``."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; the port has: "
                         f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


__all__ = ["DGCF", "DisenGCN", "KGAT", "LightGCN", "MODEL_REGISTRY",
           "model_class"]
