"""Model zoo of the port (tagrec_tpu/models): DGCF and DisenGCN (dense
routing tier, or the chunked dense tier), DisenHAN (dense mode), KGAT
(dense flash tier or the chunked dense tier on the tag graph, the
relation-dense tier over a knowledge graph), LightGCN and NGCF (dense
sectors, hybrid and ELL tiers), and TGCN (deduplicated or plain neighbour
tables); DGCF, DisenGCN, DisenHAN, KGAT and TGCN also on the EdgeMap
tier (``ops.edgemap``), which the first four take past the dense
budget."""

from tagrec_tpu_torch.models.dgcf import DGCF
from tagrec_tpu_torch.models.disengcn import DisenGCN
from tagrec_tpu_torch.models.disenhan import DisenHAN
from tagrec_tpu_torch.models.kgat import KGAT
from tagrec_tpu_torch.models.lightgcn import LightGCN
from tagrec_tpu_torch.models.ngcf import NGCF
from tagrec_tpu_torch.models.tgcn import TGCN

MODEL_REGISTRY = {"dgcf": DGCF, "disengcn": DisenGCN, "disenhan": DisenHAN,
                  "kgat": KGAT, "lightgcn": LightGCN, "ngcf": NGCF,
                  "tgcn": TGCN}


def model_class(name: str):
    """The model class registered as ``name``."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; the port has: "
                         f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


__all__ = ["DGCF", "DisenGCN", "DisenHAN", "KGAT", "LightGCN", "NGCF", "TGCN",
           "MODEL_REGISTRY", "model_class"]
