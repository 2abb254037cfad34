"""The port's training losses, BatchedCOO, Adam, fresh init and config
against the JAX package (float64 on the CPU): each of the six losses and
its gradient, ``BatchedCOO.to_dense`` and both matvecs, three Adam steps
against ``optax.adam``, the statistics of Flax's fresh init, and the
trainer's ``params.yaml`` keys."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeppreconditioning_tpu import config as jax_config
from deeppreconditioning_tpu import metrics as jax_metrics
from deeppreconditioning_tpu.sparse.coo import BatchedCOO as JaxCOO
from deeppreconditioning_tpu.sparse.coo import (
    batched_coo_matvec as jax_coo_matvec,
)
from deeppreconditioning_tpu_torch import config, metrics
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    NeuralFSAI,
    init_params,
    params_from_jax,
    params_to_jax,
)
from deeppreconditioning_tpu_torch.sparse.coo import (
    BatchedCOO,
    batched_coo_matvec,
    pad_to_bucket,
)
from deeppreconditioning_tpu_torch.train.trainer import adam

REPO = Path(__file__).resolve().parents[1]
B, N = 2, 24
RTOL = 1e-10  # float64 on both sides; only summation order differs


def _operands(seed=0):
    """A batch of SPD systems (tril part), lower factors with a positive
    diagonal, a dense SPD M and right-hand sides, float64."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((B, N, N))
    a = g @ g.transpose(0, 2, 1) / N + np.eye(N)
    l_dense = np.tril(rng.standard_normal((B, N, N)) * 0.1, -1) \
        + np.eye(N) * rng.uniform(0.5, 1.5, (B, 1, N))
    h = rng.standard_normal((B, N, N)) * 0.2
    m = h @ h.transpose(0, 2, 1) + np.eye(N) * 0.3
    rhs = rng.standard_normal((B, N))
    return np.tril(a), l_dense, m, rhs


def _coo(l_dense, cls, **kw):
    b, r, c = np.nonzero(l_dense)
    idx = np.stack([b, r, c], axis=1)
    return cls.from_numpy(idx, l_dense[b, r, c], B, (N, N), bucket=64, **kw)


def _jax_loss(name, a_tril, l_dense, m, rhs, sol):
    if name == "inverse_loss":
        return jax_metrics.inverse_loss(a_tril, l_dense)
    if name == "condition_loss":
        return jax_metrics.condition_loss(a_tril, l_dense)
    if name == "kaporin_loss":
        return jax_metrics.kaporin_loss(a_tril, l_dense)
    if name == "hutchinson_trace":
        return jax_metrics.hutchinson_trace(jax.random.PRNGKey(3), a_tril,
                                            l_dense)
    if name == "pcg_residual_loss":
        return jax_metrics.pcg_residual_loss(a_tril, m, rhs, k_steps=5)
    b, r, c = np.nonzero(np.tril(np.ones((B, N, N))))
    coo = JaxCOO.from_numpy(np.stack([b, r, c], 1), np.zeros(b.shape[0]),
                            B, (N, N), bucket=64, dtype=jnp.float64)
    coo = coo.replace(values=jnp.pad(l_dense[b, r, c],
                                     (0, coo.nnz_pad - b.shape[0])))
    return jax_metrics.frobenius_loss(coo, sol, rhs)


def _torch_loss(name, a_tril, l_dense, m, rhs, sol):
    if name == "inverse_loss":
        return metrics.inverse_loss(a_tril, l_dense)
    if name == "condition_loss":
        return metrics.condition_loss(a_tril, l_dense)
    if name == "kaporin_loss":
        return metrics.kaporin_loss(a_tril, l_dense)
    if name == "hutchinson_trace":
        probes = jax.random.normal(jax.random.PRNGKey(3), (B, N),
                                   jnp.float64)
        return metrics.hutchinson_trace(
            a_tril, l_dense, probes=torch.tensor(np.asarray(probes)))
    if name == "pcg_residual_loss":
        return metrics.pcg_residual_loss(a_tril, m, rhs, k_steps=5)
    b, r, c = np.nonzero(np.tril(np.ones((B, N, N))))
    coo = BatchedCOO.from_numpy(
        np.stack([b, r, c], 1), np.zeros(b.shape[0]), B, (N, N), bucket=64,
        dtype=torch.float64)
    vals = torch.nn.functional.pad(l_dense[b, r, c],
                                   (0, coo.nnz_pad - b.shape[0]))
    return metrics.frobenius_loss(coo.replace_values(vals), sol, rhs)


@pytest.mark.parametrize("name", [
    "inverse_loss", "frobenius_loss", "hutchinson_trace", "condition_loss",
    "pcg_residual_loss", "kaporin_loss",
])
def test_loss_and_gradient_match_jax(name):
    """Each loss and its gradient with respect to the learned operand (L,
    or M for the PCG loss) in float64, to 1e-10 relative."""
    a_tril, l_dense, m, rhs = _operands()
    sol = np.random.default_rng(1).standard_normal((B, N))
    wrt = m if name == "pcg_residual_loss" else l_dense

    def jax_f(x):
        args = (x, m) if name != "pcg_residual_loss" else (l_dense, x)
        return _jax_loss(name, jnp.asarray(a_tril), jnp.asarray(args[0]),
                         jnp.asarray(args[1]), jnp.asarray(rhs),
                         jnp.asarray(sol))

    want, want_grad = jax.jit(jax.value_and_grad(jax_f))(jnp.asarray(wrt))
    x = torch.tensor(wrt, requires_grad=True)
    args = (x, torch.tensor(m)) if name != "pcg_residual_loss" else (
        torch.tensor(l_dense), x)
    got = _torch_loss(name, torch.tensor(a_tril), args[0], args[1],
                      torch.tensor(rhs), torch.tensor(sol))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    g_want = np.asarray(want_grad)
    np.testing.assert_allclose(x.grad.numpy(), g_want, rtol=1e-8,
                               atol=RTOL * np.abs(g_want).max())


def test_pcg_residual_loss_floor_and_hutchinson_generator():
    """A converged system reads the floor log(1e-12) exactly, as in JAX;
    the probes come from the generator when none are given."""
    a_tril, _, _, rhs = _operands()
    a_full = np.tril(a_tril) + np.tril(a_tril, -1).transpose(0, 2, 1)
    m_exact = np.linalg.inv(a_full)
    want = jax_metrics.pcg_residual_loss(jnp.asarray(a_tril),
                                         jnp.asarray(m_exact),
                                         jnp.asarray(rhs), k_steps=3)
    got = metrics.pcg_residual_loss(torch.tensor(a_tril),
                                    torch.tensor(m_exact), torch.tensor(rhs),
                                    k_steps=3)
    assert float(got) == pytest.approx(np.log(1e-12), abs=0)
    assert float(want) == pytest.approx(np.log(1e-12), abs=0)
    _, l_dense, _, _ = _operands(1)
    one = metrics.hutchinson_trace(torch.tensor(a_tril), torch.tensor(l_dense),
                                   generator=torch.Generator().manual_seed(5))
    two = metrics.hutchinson_trace(torch.tensor(a_tril), torch.tensor(l_dense),
                                   generator=torch.Generator().manual_seed(5))
    assert float(one) == float(two) and np.isfinite(float(one))


def test_scatter_tril_dense_matches_jax():
    rng = np.random.default_rng(4)
    rows = rng.integers(-2, N + 2, (B, 40))
    cols = rng.integers(-2, N + 2, (B, 40))
    vals = rng.standard_normal((B, 40))
    valid = rng.uniform(size=(B, 40)) < 0.8
    want = jax_metrics.scatter_tril_dense(
        jnp.asarray(vals), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(valid), N)
    got = metrics.scatter_tril_dense(
        torch.tensor(vals), torch.tensor(rows), torch.tensor(cols),
        torch.tensor(valid), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)


@pytest.mark.parametrize("transpose", [False, True])
def test_batched_coo_to_dense_and_matvec_match_jax(transpose):
    """Exact in float64: every product has one term per site."""
    _, l_dense, _, _ = _operands(2)
    ref = _coo(l_dense, JaxCOO, dtype=jnp.float64)
    ours = _coo(l_dense, BatchedCOO, dtype=torch.float64)
    assert ours.nnz_pad == ref.nnz_pad == pad_to_bucket(
        int((l_dense != 0).sum()), 64)
    np.testing.assert_array_equal(ours.to_dense().numpy(),
                                  np.asarray(ref.to_dense()))
    x = np.random.default_rng(3).standard_normal((B, N))
    want = jax_coo_matvec(ref, jnp.asarray(x), transpose=transpose)
    got = batched_coo_matvec(ours, torch.tensor(x), transpose=transpose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=1e-14)
    masked = ours.replace_values(ours.values * 2.0)
    np.testing.assert_array_equal(masked.masked_values().numpy(),
                                  np.asarray(ref.replace_values(
                                      ref.values * 2.0).masked_values()))


def _random_params(seed, width=8, hidden=16, degree=2):
    rng = np.random.default_rng(seed)
    shapes = {"dense0": (4 * width, hidden), "dense1": (hidden, hidden),
              "alpha": (hidden, width), "beta": (hidden, width)}
    tree = {name: {"kernel": rng.standard_normal(s) * 0.1,
                   "bias": rng.standard_normal(s[1]) * 0.1}
            for name, s in shapes.items()}
    tree["q_coeffs"] = rng.standard_normal(degree + 1) * 0.1
    return {"params": tree}


def test_adam_matches_optax_over_three_steps():
    """torch.optim.Adam at lr 1e-3 and optax.adam(1e-3) from the same
    params and the same gradients: params and both moments after each
    of three steps (eps placement and bias correction), float64."""
    params = _random_params(0)
    model = NeuralFSAI(8, 16, 2).double()
    model.load_state_dict(params_from_jax(params))
    optimizer = adam(model, 1e-3)
    tx = optax.adam(1e-3)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    names = {p: n for n, p in model.named_parameters()}
    for k in range(3):
        grads = _random_params(10 + k)
        grads["params"]["q_coeffs"] *= 1e-6  # a small, eps-sensitive leaf
        g_torch = params_from_jax(grads)
        for p, name in names.items():
            p.grad = g_torch[name].clone()
        optimizer.step()
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads),
                                    opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        got = params_to_jax(model.state_dict())
        want = jax.tree.map(np.asarray, jparams)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
        mu = params_to_jax({n: optimizer.state[p]["exp_avg"]
                            for p, n in names.items()})
        for a, b in zip(jax.tree.leaves(mu),
                        jax.tree.leaves(opt_state[0].mu)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12)
        assert int(opt_state[0].count) == k + 1


def test_init_params_statistics():
    """Flax's fresh init in distribution: dense kernels cut at two of
    their standard deviations and with variance 1 / fan_in (within 15%),
    zero biases, heads and q_coeffs; the generator fixes the draws."""
    model = NeuralFSAI(24, 64, 2)
    init_params(model, torch.Generator().manual_seed(69))
    for layer in (model.dense0, model.dense1):
        w = layer.weight.detach().double()
        fan_in = w.shape[1]
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(w.abs().max()) <= 2.0 * std * (1 + 1e-6)
        assert 0.85 / fan_in < float(w.var()) < 1.15 / fan_in
        assert abs(float(w.mean())) < 3 * np.sqrt(1.0 / fan_in / w.numel())
        assert not layer.bias.any()
    for head in (model.alpha, model.beta):
        assert not head.weight.any() and not head.bias.any()
    assert not model.q_coeffs.any()
    again = NeuralFSAI(24, 64, 2)
    init_params(again, torch.Generator().manual_seed(69))
    assert torch.equal(again.dense0.weight, model.dense0.weight)


def test_params_to_jax_inverts_params_from_jax():
    params = _random_params(7)
    back = params_to_jax(params_from_jax(params))
    assert list(back["params"]) == sorted(params["params"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_training_params_match_jax(tmp_path):
    """The trainer's params.yaml keys read as the JAX package reads them
    (fsai_width and fsai_power are its extra keys); learning_rate is a
    float."""
    fields = ("batch_size", "learning_rate", "patience", "seed",
              "checkpoint_dir", "data_root")
    for path, text in ((REPO / "params.yaml", None),
                       (tmp_path / "p.yaml", "learning_rate: 0.01\n"
                        "batch_size: 8\nfsai_width: 32\n")):
        if text is not None:
            path.write_text(text)
        ours = config.params_show(path)
        ref = jax_config.params_show(path)
        for name in fields:
            assert getattr(ours, name) == getattr(ref, name), name
        assert ours.fsai_width == ref.extra.get("fsai_width", 16)
        assert ours.fsai_power == ref.extra.get("fsai_power", 3)
        assert isinstance(ours.learning_rate, float)
