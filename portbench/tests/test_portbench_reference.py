"""The plain references against the port's plain CPU path on tiny graphs:
the same leaves and batches give the same tables, losses, gradients,
Adam steps and evaluation."""

import numpy as np
import pytest
import torch

from portbench import graphs
from portbench.reference import _common as C
from portbench.reference import _eval, dgcf, lightgcn
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.training import optim
from tagrec_tpu_torch.training.evaluate import Evaluator

REFS = {"lightgcn": lightgcn, "dgcf": dgcf}


def _setup(name, seed=5):
    raw = graphs.make(30, 80, 20, 600, tag_per_inter=0.5, seed=seed)
    mcfg = model_preset(name)
    model = model_class(name)(graphs.to_hetero(raw), mcfg,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    cfg = {"dim_latent": mcfg.dim_latent,
           "dim_layer_list": list(mcfg.dim_layer_list),
           "norm_type": mcfg.norm_type, "mul_loss_func": mcfg.mul_loss_func,
           "reg": mcfg.reg, "lr": 0.01, "factor_k": mcfg.factor_k,
           "iterate_k": mcfg.iterate_k, "cor_reg": mcfg.cor_reg}
    g = torch.Generator().manual_seed(seed)
    w0 = [torch.rand(shape, generator=g) - 0.5
          for _, shape in REFS[name].leaves(raw, cfg)]
    with torch.no_grad():
        for p, w in zip(model.parameters(), w0):
            p.copy_(w)
    rng = np.random.default_rng(seed)
    batches = [{"bpr": torch.as_tensor(np.stack([
        rng.integers(0, raw.n_user, 16), rng.integers(0, raw.n_item, 16),
        rng.integers(0, raw.n_item, 16)], axis=1))} for _ in range(3)]
    return raw, cfg, model, w0, batches


@pytest.mark.parametrize("name", sorted(REFS))
def test_reference_follows_the_port(name):
    raw, cfg, model, w0, batches = _setup(name)
    opt = optim.make_optimizer(model.parameters(), TrainConfig())
    losses, g1 = [], None
    for b in batches:
        opt.zero_grad(set_to_none=True)
        loss = sum(model.bpr_loss(b["bpr"]))
        loss.backward()
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = [float(p.grad.norm()) for p in model.parameters()]
        opt.step()
    change = [float((p.detach() - w).norm())
              for p, w in zip(model.parameters(), w0)]
    ref = REFS[name].train_steps(raw, cfg, w0, batches, C.Precision("ref"),
                                 "cpu")
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(g1, ref["grad1"], rtol=1e-4)
    np.testing.assert_allclose(change, ref["change"], rtol=1e-4)
    ctl = REFS[name].train_steps(raw, cfg, w0, batches, C.Precision("tf32"),
                                 "cpu")
    np.testing.assert_allclose(ctl["losses"], ref["losses"], rtol=1e-2)


def test_evaluation_follows_the_port():
    raw, cfg, model, w0, _ = _setup("lightgcn", seed=8)
    hetero = graphs.to_hetero(raw)
    ev = Evaluator(hetero, TrainConfig(test_batch=8), device="cpu")
    got = ev.run(model)
    users, items = lightgcn.final_tables(raw, cfg, w0, C.Precision("ref"),
                                         "cpu")
    top, want = _eval.evaluate(users, items, raw.train, raw.test, (10, 20),
                               8, C.Precision("ref"))
    with torch.no_grad():
        u32, i32 = model.forward()[:2]
    top32, _ = _eval.evaluate(u32.double(), i32.double(), raw.train,
                              raw.test, (10, 20), 8, C.Precision("ref"))
    assert np.mean(np.any(top32 != top, axis=1)) <= 0.05
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -10,
                      -3.0 - 2.0 ** -12])
    got = C.tf32(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -10, -3.0])
    assert torch.equal(got, want)
