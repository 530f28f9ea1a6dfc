"""Operations LightGCN needs, from shapes and the graph's real edges: the
products of a sparse propagation (2 operations an edge and width, forward
and, in training, backward) and of the scores.  Elementwise work
(normalisation, the mean, Adam) is left out; a dense tier's zeros and
recomputed work do not count."""

from portbench.reference._common import joint_edges


def edges(raw) -> int:
    """Directed edges of the joint user-item-tag adjacency."""
    return len(joint_edges(raw.n_user, raw.n_item, raw.n_tag, raw.train,
                           raw.uit)[0])


def step_flops(raw, cfg: dict, batch: int) -> float:
    """One BPR step: L propagations forward and L backward, and the two
    score dot products of each pair, forward and backward."""
    d, layers = cfg["dim_latent"], len(cfg["dim_layer_list"])
    return 4.0 * layers * edges(raw) * d + 8.0 * batch * d


def eval_flops(raw, cfg: dict, users: int) -> float:
    """One evaluation pass: one forward and every test user's scores over
    every item."""
    d, layers = cfg["dim_latent"], len(cfg["dim_layer_list"])
    return 2.0 * layers * edges(raw) * d + 2.0 * users * raw.n_item * d
