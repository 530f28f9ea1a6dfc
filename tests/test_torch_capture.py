"""The Trainer's graph-safe step, run eagerly on the CPU.

On the card the Trainer captures each phase's step in a CUDA graph; here
the same step body runs eagerly.  These tests hold it against the loop it
replaced: batches taken by a Python slice at step i, one optimizer step
each, the loss terms stacked per step.  Equal means bit for bit: the
same operations on the same values, on one thread.

- the phases' batches read from a device-style step counter (index
  arithmetic) equal the slices of the old loop, for BPR, TransE shuffled
  and in quirk #5's window, and the resampling phase;
- LightGCN and KGAT (BPR, then TransE on one Adam) trained by the
  Trainer equal the old loop: losses, parameters and Adam's per-parameter
  step counts;
- each row of the loss buffer holds its own step's terms;
- ``ell_mm_t`` over the host-built real-slot list equals its ``nonzero``
  form;
- a train state restores into the Adam state already there, in place.

No JAX here: the JAX parity of the step is held by the training test
files, which run this same body.
"""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data.synthetic import synthetic_graph
from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops import propagate, sampling
from tagrec_tpu_torch.training import checkpoint, optim
from tagrec_tpu_torch.training.train import (Trainer, _where, bpr_phase,
                                             resampling_phase, triple_phase)

ROUNDS = TrainConfig().neg_resample_rounds


@pytest.fixture(scope="module")
def graph():
    return synthetic_graph(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _counter(i):
    return torch.tensor([i], dtype=torch.int64)


# ------------------------------------------------------ the old loop's batches

def old_bpr_batch(gen, i, shuffled, phase, batch):
    sl = shuffled[i * batch:(i + 1) * batch]
    neg = sampling.sample_negatives(gen, phase.data["pt"], sl[:, 0],
                                    rounds=ROUNDS)
    return torch.stack([sl[:, 0], sl[:, 1], neg], dim=1)


def old_triple_batch(gen, i, state, phase, batch, window):
    trips, tkeys = state
    start = i if window else i * batch
    neg = sampling.sample_negatives_from_set(
        gen, phase.data["ts"], tkeys[start:start + batch], rounds=ROUNDS)
    return torch.cat([trips[start:start + batch], neg[:, None]], dim=1)


def test_bpr_batches_from_the_step_counter_equal_the_slices(graph):
    pt = sampling.build_pos_table(graph.user_items["train"], graph.n_user,
                                  graph.n_item, device="cpu")
    batch = 16
    phase = bpr_phase("bpr", graph.edge_index["train"], pt, batch, None)
    assert phase.steps_per_epoch > 2
    shuffled = phase.epoch_reset(_gen(), phase.data)
    for i in (0, 1, phase.steps_per_epoch - 1):
        got = phase.make_batch(_gen(i), _counter(i), shuffled, phase.data)
        want = old_bpr_batch(_gen(i), i, shuffled, phase, batch)
        assert torch.equal(got, want)


@pytest.mark.parametrize("window", [False, True])
def test_triple_batches_from_the_step_counter_equal_the_slices(graph, window):
    rng = np.random.default_rng(0)
    n_ids, n_rel, batch = 60, 4, 24
    trips = np.stack([rng.integers(0, n_ids, 200), rng.integers(0, n_rel, 200),
                      rng.integers(0, n_ids, 200)], axis=1)
    phase = triple_phase("transe", trips, n_rel, n_ids, batch, None,
                         window=window, device="cpu")
    steps = phase.steps_per_epoch
    assert steps == len(trips) // batch
    state = phase.epoch_reset(_gen(), phase.data)
    if window:  # quirk #5: the triples in file order, step i at row i
        assert torch.equal(state[0], phase.data["trips"])
    for i in (0, 1, steps - 1):
        got = phase.make_batch(_gen(i), _counter(i), state, phase.data)
        want = old_triple_batch(_gen(i), i, state, phase, batch, window)
        assert torch.equal(got, want)
    if window:  # consecutive windows overlap in all but one triple
        b0, b1 = (phase.make_batch(_gen(), _counter(i), state, phase.data)
                  for i in (0, 1))
        assert torch.equal(b0[1:, :3], b1[:-1, :3])


def test_resampling_batches_do_not_depend_on_the_counter_form(graph):
    pt = sampling.build_pos_table(graph.user_items["train"], graph.n_user,
                                  graph.n_item, device="cpu")
    users = np.asarray(sorted(graph.user_items["train"]), dtype=np.int64)
    for batch in (16, 64):  # without, and with, replacement
        phase = resampling_phase("bpr", users, pt, batch, 5, None,
                                 cor_sizes={"item": (8, graph.n_item)})
        got = phase.make_batch(_gen(), _counter(3), None, phase.data)
        want = phase.make_batch(_gen(), 3, None, phase.data)
        assert torch.equal(got["bpr"], want["bpr"])
        assert torch.equal(got["cor"]["item"], want["cor"]["item"])
        assert got["bpr"].shape == (batch, 3)


# --------------------------------------------------------- the old training

def _pipeline(graph, name, tcfg, **kw):
    return build_pipeline(graph, model_preset(name, **kw), tcfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))


def old_loop(pipe, tcfg, steps, windows):
    """The loop the Trainer replaced: per phase, a slice at Python step i,
    then zero_grad, loss, backward, Adam; the terms stacked per step."""
    gen = _gen(5)
    opt = optim.make_optimizer(pipe.model.parameters(), tcfg)
    out = {}
    for phase in pipe.phases:
        state = phase.epoch_reset(gen, phase.data)
        batch = phase.data["offsets"].numel()
        parts = []
        for i in range(min(steps, phase.steps_per_epoch)):
            if phase.name == "bpr":
                b = old_bpr_batch(gen, i, state, phase, batch)
            else:
                b = old_triple_batch(gen, i, state, phase, batch,
                                     windows[phase.name])
            opt.zero_grad(set_to_none=True)
            terms = phase.loss_fn(b, gen)
            sum(terms).backward()
            opt.step()
            parts.append(torch.stack([t.detach() for t in terms]))
        out[phase.name] = torch.stack(parts).numpy()
    return out, opt


@pytest.mark.parametrize("name,kw,windows", [
    ("lightgcn", {}, {}),
    ("kgat", {"agg_type": "bi_inter"}, {"transe": True}),
    ("kgat", {"agg_type": "bi_inter", "transe_sampler": "full_pass"},
     {"transe": False})])
def test_step_body_reproduces_the_old_loop_bit_for_bit(graph, name, kw,
                                                       windows):
    tcfg = TrainConfig(train_batch=64)
    steps = 4
    new = _pipeline(graph, name, tcfg, **kw)
    trainer = Trainer(new.model, new.phases, tcfg, generator=_gen(5))
    assert not trainer.capture  # the CPU runs the body eagerly
    got = trainer.run_epoch(max_steps=steps)
    old = _pipeline(graph, name, tcfg, **kw)
    want, old_opt = old_loop(old, tcfg, steps, windows)
    assert list(got) == list(want)
    for ph in want:
        np.testing.assert_array_equal(got[ph], want[ph])
    old_params = dict(old.model.named_parameters())
    for n, p in new.model.named_parameters():
        assert torch.equal(p, old_params[n]), n
        st, st_old = trainer.opt.state.get(p), old_opt.state.get(
            old_params[n])
        assert (st is None) == (st_old is None), n
        if st is not None:  # adam_impl="torch": a count per parameter
            assert int(st["step"]) == int(st_old["step"]), n
            assert torch.equal(st["exp_avg_sq"], st_old["exp_avg_sq"]), n


def test_kgat_phases_keep_their_own_adam_counts(graph):
    """BPR never reaches the TransE relation tables, TransE only the ego
    rows: under adam_impl="torch" the counts differ per parameter, as the
    eager loop's do (held equal in the test above)."""
    tcfg = TrainConfig(train_batch=64)
    pipe = _pipeline(graph, "kgat", tcfg, agg_type="bi_inter")
    trainer = Trainer(pipe.model, pipe.phases, tcfg, generator=_gen(5))
    got = trainer.run_epoch(max_steps=3)
    counts = {n: int(trainer.opt.state[p]["step"]) if p in trainer.opt.state
              else 0 for n, p in pipe.model.named_parameters()}
    n_bpr, n_transe = len(got["bpr"]), len(got["transe"])
    assert set(counts.values()) >= {n_bpr, n_bpr + n_transe}, counts


def test_each_loss_row_holds_its_own_step(graph):
    tcfg = TrainConfig(train_batch=32)
    pipe = _pipeline(graph, "lightgcn", tcfg)
    trainer = Trainer(pipe.model, pipe.phases, tcfg, generator=_gen(5))
    seen = []
    got = trainer.run_phase(pipe.phases[0], max_steps=4,
                            on_step=lambda i, parts: seen.append(
                                (i, parts.clone())))
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    for i, parts in seen:
        np.testing.assert_array_equal(got[i], parts.numpy())
    assert len({tuple(r) for r in got.tolist()}) == 4  # no row aliased
    run = trainer.runs["bpr"]
    assert run.graph is None and int(run.counter) == 4
    np.testing.assert_array_equal(run.losses[:4].numpy(), got)
    # the next epoch starts at row 0 again, in the same buffers
    buf, state = run.losses.data_ptr(), run.state.data_ptr()
    again = trainer.run_phase(pipe.phases[0], max_steps=2)
    assert run.losses.data_ptr() == buf and run.state.data_ptr() == state
    np.testing.assert_array_equal(run.losses[:2].numpy(), again)


# ----------------------------------------------------------- graph-safe ops

def _ell_mm_t_nonzero(ell, g, n_cols, chunk):
    """The form ``ell_mm_t`` had: the real slots found by ``nonzero``."""
    n, k = ell.idx.shape
    out = g.new_zeros((n_cols, g.shape[1]))
    slots = torch.arange(k)
    for i in range(0, n, chunk):
        r, s = torch.nonzero(slots[None, :] < ell.deg[i:i + chunk, None],
                             as_tuple=True)
        cols = ell.idx[i:i + chunk][r, s].long()
        out.index_add_(0, cols, ell.val[i:i + chunk][r, s][:, None]
                       * g[i + r])
    return out


@pytest.mark.parametrize("nonfinite", [False, True])
def test_ell_mm_t_over_the_live_slots_equals_the_nonzero_form(nonfinite):
    rng = np.random.default_rng(4)
    n, m, d = 57, 41, 8
    row = rng.integers(0, n, 400)
    col = rng.integers(0, m, 400)
    host = ell_lib.build_ell(row, col, rng.standard_normal(400), n, m)
    ell = ell_lib.to_device(host, "cpu")
    assert torch.equal(ell.live.long(),
                       torch.nonzero((torch.arange(ell.idx.shape[1])[None, :]
                                      < ell.deg[:, None]).reshape(-1))[:, 0])
    assert int((ell.deg < ell.idx.shape[1]).sum()) > 0  # rows with pads
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    if nonfinite:  # a pad slot is never read: no 0 * inf
        g[int(torch.argmin(ell.deg))] = float("inf")
    budget = 37 * d * 4  # chunks of 37 real slots, across rows
    got = propagate.ell_mm_t(ell, g, m, budget=budget)
    want = _ell_mm_t_nonzero(ell, g, m, chunk=10)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_train_state_restores_adam_state_in_place(graph, tmp_path):
    tcfg = TrainConfig(train_batch=64)
    pipe = _pipeline(graph, "kgat", tcfg, agg_type="bi_inter")
    trainer = Trainer(pipe.model, pipe.phases, tcfg, generator=_gen(5))
    trainer.run_epoch(max_steps=2)
    path = str(tmp_path / "state.npz")
    checkpoint.save_train_state(path, pipe.model, trainer.opt, 1)
    saved = {p: {k: v.clone() for k, v in st.items()}
             for p, st in trainer.opt.state.items()}
    ptrs = {p: st["exp_avg"].data_ptr() for p, st in trainer.opt.state.items()}
    trainer.run_epoch(max_steps=2)
    assert checkpoint.restore_train_state(path, pipe.model, trainer.opt) == 1
    assert trainer.opt.state.keys() == saved.keys()
    for p, st in trainer.opt.state.items():
        assert st["exp_avg"].data_ptr() == ptrs[p]  # the same tensors
        for key, v in saved[p].items():
            assert torch.equal(st[key], v), key


def test_where_names_the_operation_in_the_package():
    with pytest.raises(ValueError) as info:
        sampling.build_triple_set(np.zeros((0, 3), dtype=np.int64), 2, 5,
                                  device="cpu")
    where = _where(info.value)
    assert where.startswith("sampling.py:") and "build_triple_set" in where
