"""The parallel layer (tagrec_tpu/parallel): the (data, model) mesh of
ranks, the launch from torchrun's environment, the placement of
parameters and batches, and the top-k over a row-sharded item table."""

from tagrec_tpu_torch.parallel.mesh import Mesh, make_mesh
from tagrec_tpu_torch.parallel import launch, sharding, topk

__all__ = ["Mesh", "make_mesh", "launch", "sharding", "topk"]
