"""Model zoo of the port (tagrec_tpu/models): DGCF and DisenGCN (dense
routing tier, or the chunked dense tier), DisenHAN (dense mode), KGAT
(dense flash tier, or the chunked dense tier), and LightGCN and NGCF
(dense sectors, hybrid and ELL tiers)."""

from tagrec_tpu_torch.models.dgcf import DGCF
from tagrec_tpu_torch.models.disengcn import DisenGCN
from tagrec_tpu_torch.models.disenhan import DisenHAN
from tagrec_tpu_torch.models.kgat import KGAT
from tagrec_tpu_torch.models.lightgcn import LightGCN
from tagrec_tpu_torch.models.ngcf import NGCF

MODEL_REGISTRY = {"dgcf": DGCF, "disengcn": DisenGCN, "disenhan": DisenHAN,
                  "kgat": KGAT, "lightgcn": LightGCN, "ngcf": NGCF}


def model_class(name: str):
    """The model class registered as ``name``."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; the port has: "
                         f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


__all__ = ["DGCF", "DisenGCN", "DisenHAN", "KGAT", "LightGCN", "NGCF",
           "MODEL_REGISTRY", "model_class"]
