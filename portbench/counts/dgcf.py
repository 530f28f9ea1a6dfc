"""Operations DGCF needs for one BPR step, from shapes and the joint
graph's real edges E.  Per routing iteration, edge and factor: the softmax
over the factors (3), the degree (1), the routed message (2 dk) and the
score update's dot product and sum (2 dk + 1); the backward runs the last
iteration's message product of each layer transposed (2 dk an edge and
factor).  The kernels' recomputation of scores from low-rank factors does
not count, nor elementwise work a node; the scores of each pair as
LightGCN's."""

from portbench.counts.lightgcn import edges


def step_flops(raw, cfg: dict, batch: int) -> float:
    d, layers = cfg["dim_latent"], len(cfg["dim_layer_list"])
    f, k = cfg["factor_k"], cfg["iterate_k"]
    dk = d // f
    e = edges(raw)
    per_layer = k * e * f * (5 + 4 * dk) + e * f * 2 * dk
    return float(layers * per_layer + 8 * batch * d)
