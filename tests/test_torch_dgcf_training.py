"""The port's DGCF training slice against the JAX package on the CPU.

* ``routed_mm``'s gradient: JAX's custom VJP (its Pallas kernel in
  interpret mode, over mask.T) on random non-symmetric masks; rtol 5e-4,
  atol 1e-5 (float32, the backward sums over the mask's columns in another
  order); q and k get none.
* DGCF's loss parts (rtol 1e-4) and every parameter's gradient (rtol 5e-4,
  atol 1e-5) on JAX's first resampled batch, at cor_reg 0 and 0.1 (the
  distance-correlation term on the batch's cor ids); a 3-step Adam
  trajectory at both, rtol 5e-3 (Adam's sqrt(v) amplifies float32
  rounding in small gradients), with the same per-leaf step counts as
  JAX's ``torch_adam``, which skips a leaf whose gradient is exactly 0.
* ``cor_loss`` at rtol 1e-5.
* The samplers are random on both sides with different generators, so
  ``sample_positive`` and ``resampling_phase`` are held by invariants.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tagrec_tpu import compose as jcompose
from tagrec_tpu.config import TrainConfig as JaxTrainConfig
from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.ops import flash_routing as jfr
from tagrec_tpu.ops import losses as jlosses
from tagrec_tpu_torch.ops import flash_routing as tfr
from tagrec_tpu_torch.ops import losses, sampling
from tagrec_tpu_torch.training.train import resampling_phase
from torch_routed_parity import (STEPS, first_step, jax_trajectory,
                                 port_pipeline, trajectory)
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5
TRAJ_RTOL = 5e-3
COR = {"no_cor": 0.0, "cor": 0.1}


@pytest.fixture(scope="module")
def jax_runs(tiny_graph):
    """JAX DGCF (dense flash tier) with reg 1e-3, at cor_reg 0 and 0.1."""
    return {key: jax_trajectory(tiny_graph, "dgcf",
                                dict(reg=1e-3, cor_reg=c))
            for key, c in (("no_cor", 0.0), ("cor", 0.1))}


def _routing_inputs(r, seed):
    rng = np.random.default_rng(seed)
    f, n, m, dx = 4, 70, 50, 16
    q = (rng.standard_normal((f, n, r)) / np.sqrt(r)).astype(np.float32)
    k = (rng.standard_normal((f, m, r)) / np.sqrt(r)).astype(np.float32)
    x = rng.standard_normal((f, m, dx)).astype(np.float32)
    g = rng.standard_normal((f, n, dx)).astype(np.float32)
    mask = rng.random((n, m)) < 0.2
    mask[5, :] = False     # an empty row
    mask[:, 7] = False     # an empty column: its gradient is 0
    mask[:, 11] = True     # a full column
    return q, k, x, g, mask


@pytest.mark.parametrize("r", [8, 16])
@pytest.mark.parametrize("base", [0.0, 1.0])
@pytest.mark.parametrize("with_mask_t", [False, True])
def test_routed_mm_gradient_matches_jax_vjp(r, base, with_mask_t):
    q, k, x, g, mask = _routing_inputs(r, seed=r + int(base))
    _, vjp = jax.vjp(lambda q_, k_, x_: jfr.routed_mm(q_, k_, jnp.asarray(mask),
                                                      x_, base),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(x))
    dq, dk, dx = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    assert not dq.any() and not dk.any()
    tq, tk, tx = (torch.from_numpy(a).requires_grad_() for a in (q, k, x))
    mask_t = torch.from_numpy(np.ascontiguousarray(mask.T))
    out = tfr.routed_mm(tq, tk, torch.from_numpy(mask), tx, base,
                        mask_t=mask_t if with_mask_t else None)
    out.backward(torch.from_numpy(g))
    assert tq.grad is None and tk.grad is None
    np.testing.assert_allclose(tx.grad.numpy(), dx, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert not dx[:, 7].any() and not tx.grad[:, 7].any()
    # routed_mm_bwd is that gradient, and a swapped q and k cannot pass
    got = tfr.routed_mm_bwd(*(torch.from_numpy(a) for a in (q, k)), mask_t,
                            torch.from_numpy(g), base)
    np.testing.assert_allclose(got.numpy(), dx, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfr.routed_mm_bwd(*(torch.from_numpy(a) for a in (k, q)), mask_t,
                          torch.from_numpy(g), base)


def test_the_dgcf_mask_is_its_own_transpose():
    pipe, _ = port_pipeline("dgcf", {})
    model = pipe.model
    assert model.maskT is None and model.mask_t is model.mask
    assert torch.equal(model.mask, model.mask.T)
    assert "maskT" not in model.state_dict()
    assert [n for n, _ in model.named_parameters()] == [
        "embed.0", "embed.1", "embed.2"]


@pytest.mark.parametrize("key", ["no_cor", "cor"])
def test_loss_parts_and_gradients_match_jax(jax_runs, key):
    run = jax_runs[key]
    pipe, _ = port_pipeline("dgcf", dict(reg=1e-3, cor_reg=COR[key]),
                            run["params"])
    with torch.no_grad():
        for got, want in zip(pipe.model.forward(), run["forward"]):
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL)
    parts, grads = first_step(pipe.model, run["batches"][0])
    assert len(parts) == len(run["parts"]) == (3 if key == "cor" else 2)
    np.testing.assert_allclose(parts, run["parts"], rtol=RTOL, atol=1e-7)
    assert grads.keys() == run["grads"].keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, run["grads"][name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        assert np.abs(g).max() > 0, name


@pytest.mark.parametrize("key", ["no_cor", "cor"])
def test_trajectory_matches_torch_adam(jax_runs, key):
    run = jax_runs[key]
    pipe, trainer = port_pipeline("dgcf", dict(reg=1e-3, cor_reg=COR[key]),
                                  run["params"])
    got, counts = trajectory(pipe, trainer, run["batches"])
    np.testing.assert_allclose(got, run["losses"], rtol=TRAJ_RTOL,
                               atol=1e-5)
    # no leaf's gradient is exactly 0, so torch's Adam (grad-None skip) and
    # JAX's torch_adam (exactly-zero skip) step the same leaves
    assert counts == run["counts"] == dict.fromkeys(counts, STEPS)


@pytest.mark.parametrize("name", ["dgcf", "disengcn"])
def test_backward_sweeps_only_what_reaches_the_loss(monkeypatch, name):
    """A BPR step runs routed_mm's backward for each layer's last routing
    iteration only (3 of the 6 forwards): DGCF's earlier iteration feeds
    only the detached score factors, DisenGCN's only the next round's q,
    and q and k get no gradient.  The gradients are JAX's either way
    (test_loss_parts_and_gradients_match_jax, test_torch_disengcn.py)."""
    calls = []
    bwd = tfr.routed_mm_bwd

    def counted(q, k, mask_t, g, base=0.0):
        calls.append(q.shape[2])
        return bwd(q, k, mask_t, g, base)

    monkeypatch.setattr(tfr, "routed_mm_bwd", counted)
    pipe, _ = port_pipeline(name, {})
    batch = torch.tensor([[0, 1, 2], [3, 4, 5]])
    sum(pipe.model.bpr_loss(batch)).backward()
    # the ranks of those iterations: DGCF's series grows 16 an iteration
    assert sorted(calls) == ([16, 48, 80] if name == "dgcf" else [16] * 3)


def test_cor_loss_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 64)).astype(np.float32)
    x[7] = x[3]  # a repeated row: a zero distance off the diagonal
    for k in (2, 4):
        chunks = np.split(x, k, axis=1)
        want = float(jlosses.cor_loss([jnp.asarray(c) for c in chunks], k))
        got = losses.cor_loss([torch.from_numpy(c) for c in chunks], k)
        np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # its gradient against JAX's, at the gradients' tolerance: the
    # diagonal's squared distances are float32 rounding noise (about 1e-6)
    # under a sqrt of 1e-8, so both sides' gradients carry about 1e-6 of it
    chunks = np.split(x[:40], 4, axis=1)
    want = jax.grad(lambda cs: jlosses.cor_loss(cs, 4))(
        [jnp.asarray(c) for c in chunks])
    tc = [torch.from_numpy(c).requires_grad_() for c in chunks]
    losses.cor_loss(tc, 4).backward()
    for a, b in zip(tc, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_sample_positive_draws_from_the_set(tiny_graph):
    train = tiny_graph.user_items["train"]
    pt = sampling.build_pos_table(train, tiny_graph.n_user,
                                  tiny_graph.n_item, device="cpu")
    users = torch.tensor(sorted(train)).repeat(300)
    pos = sampling.sample_positive(torch.Generator().manual_seed(1), pt,
                                   users)
    assert pos.shape == users.shape
    assert sampling.contains(pt, users, pos).all()
    # every positive of a user is drawn: 300 draws over at most 30 ids
    u0 = int(users[0])
    assert set(pos[users == u0].tolist()) == set(train[u0])


@pytest.mark.parametrize("batch", [16, 40, 64])
def test_resampling_phase_batches(tiny_graph, batch):
    """Users distinct exactly when there are more users than the batch:
    40 users and batches of 16 (without replacement), 40 (the equality,
    with replacement) and 64 (with replacement)."""
    train = tiny_graph.user_items["train"]
    user_ids = np.asarray(sorted(train))
    assert len(user_ids) == 40
    pt = sampling.build_pos_table(train, tiny_graph.n_user,
                                  tiny_graph.n_item, device="cpu")
    cor_sizes = {"user": (100, tiny_graph.n_user),
                 "item": (100, tiny_graph.n_item),
                 "tag": (100, tiny_graph.n_tag)}
    phase = resampling_phase("bpr", user_ids, pt, batch, 7, None,
                             cor_sizes=cor_sizes)
    assert phase.steps_per_epoch == 7
    gen = torch.Generator().manual_seed(2)
    state = phase.epoch_reset(gen, phase.data)
    repeats = 0
    for i in range(20):
        b = phase.make_batch(gen, i, state, phase.data)
        assert b["bpr"].shape == (batch, 3)
        for u, p, n in b["bpr"].tolist():
            assert u in train and p in train[u] and n not in train[u]
            assert 0 <= n < tiny_graph.n_item
        distinct = len(set(b["bpr"][:, 0].tolist())) == batch
        assert distinct or batch >= 40
        repeats += not distinct
        assert list(b["cor"]) == list(cor_sizes)
        for key, (nb, hi) in cor_sizes.items():
            c = b["cor"][key]
            assert c.shape == (nb,) and 0 <= int(c.min())
            assert int(c.max()) < hi
    # with replacement, 40 draws of 40 users repeat one nearly always
    assert repeats == (0 if batch < 40 else 20)


@pytest.mark.parametrize("name", ["dgcf", "disengcn"])
def test_pipeline_steps_and_cor_ids_equal_jax(tiny_graph, name):
    jpipe = jcompose.build_pipeline(tiny_graph, jax_preset(name),
                                    JaxTrainConfig(train_batch=32))
    pipe, trainer = port_pipeline(name, {})
    (jphase,), (phase,) = jpipe.phases, pipe.phases
    n_edges = len(tiny_graph.edge_index["train"])
    assert phase.steps_per_epoch == jphase.steps_per_epoch == (
        n_edges // 32 + 1)
    np.testing.assert_array_equal(phase.data["users"].numpy(),
                                  np.asarray(jphase.data["users"]))
    want = jphase.make_batch(jax.random.PRNGKey(0), 0, None, jphase.data)
    got = phase.make_batch(trainer.generator, 0, None, phase.data)
    assert got["bpr"].shape == want["bpr"].shape
    assert {k: v.shape for k, v in got["cor"].items()} == {
        k: v.shape for k, v in want["cor"].items()}
