"""The port's checkpoint reader and NeuralFSAI against the JAX package's
(Flax's msgpack_restore; model outputs and the deployed dense M in f64)."""

from pathlib import Path

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.models.neural_fsai import (
    NeuralFSAI as JaxNeuralFSAI,
    neural_fsai_dense_preconditioner as jax_dense_m,
)
from deeppreconditioning_tpu.ops import fsai as jax_fsai
from deeppreconditioning_tpu_torch.data.datasets import _prepare_sample
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    NeuralFSAI,
    neural_fsai_dense_preconditioner,
    neural_fsai_from_checkpoint,
    params_from_jax,
)
from deeppreconditioning_tpu_torch.models import neural_fsai
from deeppreconditioning_tpu_torch.ops import fsai
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.utils import graphs
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


CKPT_DIR = Path(__file__).resolve().parents[1] / "assets" / "checkpoints_fsai"
BEST = CKPT_DIR / "best.msgpack"
N_PAD = 256


def _assert_same_tree(got, want, path="/"):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for key in want:
            _assert_same_tree(got[key], want[key], f"{path}{key}/")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("name", ["best", "latest", "k8_best", "k16_best"])
def test_msgpack_reader_matches_flax(name):
    path = CKPT_DIR / f"{name}.msgpack"
    want = flax.serialization.msgpack_restore(path.read_bytes())
    got = load_checkpoint(path)
    _assert_same_tree(got, want)


def _case(seed):
    case = generate_sludge_case(np.random.default_rng(seed), mesh_cells=1)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                        N_PAD)
    a = np.zeros((N_PAD, N_PAD))
    a[h.rows, h.cols] = h.vals
    a = a + np.tril(a, -1).T
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, N_PAD, power=4)
    plan = fsai.build_range_fsai_plan(pr, pc, N_PAD, width=24, range_h=128)
    ref = jax_fsai.build_range_fsai_plan(pr, pc, N_PAD, width=24,
                                         range_h=128)
    return a, h.scale, h.original_size, plan.to("cpu"), ref


def _models():
    payload = flax.serialization.msgpack_restore(BEST.read_bytes())
    jax_model = JaxNeuralFSAI(width=int(payload["width"]),
                              hidden=int(payload["hidden"]),
                              poly_degree=int(payload["poly_degree"]))
    model = neural_fsai_from_checkpoint(load_checkpoint(BEST)).double()
    return jax_model, payload["params"], model


def test_params_from_jax_layout():
    payload = flax.serialization.msgpack_restore(BEST.read_bytes())
    state = params_from_jax(payload["params"])
    tree = payload["params"]["params"]
    model = NeuralFSAI(width=24, hidden=64, poly_degree=2)
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(state["dense0.weight"].numpy(),
                                  tree["dense0"]["kernel"].T)
    np.testing.assert_array_equal(state["q_coeffs"].numpy(),
                                  tree["q_coeffs"])
    assert state["dense0.weight"].shape == (64, 96)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed):
    a, _, _, plan, ref = _case(seed)
    jax_model, params, model = _models()
    want = jax_model.apply(params, ref, jnp.asarray(a))
    with torch.no_grad():
        got = model(plan, torch.tensor(a))
    np.testing.assert_allclose(got.c_vals.numpy(), np.asarray(want.c_vals),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.q_coeffs.numpy(),
                               np.asarray(want.q_coeffs), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_preconditioner_matches_jax(seed):
    a, scale, n0, plan, ref = _case(seed)
    jax_model, params, model = _models()
    want = jax_dense_m(jax_model, params, ref, jnp.asarray(a),
                       jnp.asarray(scale), n0, dtype=jnp.float64)
    with torch.no_grad():
        got = neural_fsai_dense_preconditioner(
            model, plan, torch.tensor(a), torch.tensor(scale), n0,
            dtype=torch.float64,
        )
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


def test_untrained_model_is_classical_fsai():
    a, scale, n0, plan, _ = _case(0)
    model = NeuralFSAI(width=24, hidden=64, poly_degree=2).double()
    with torch.no_grad():
        m = neural_fsai_dense_preconditioner(
            model, plan, torch.tensor(a), torch.tensor(scale), n0,
            dtype=torch.float64,
        )
    d_isqrt = 1.0 / torch.sqrt(torch.tensor(scale))
    m_fsai = fsai.fsai_dense_preconditioner_range(
        plan, torch.tensor(a), d_isqrt=d_isqrt, n0=n0, dtype=torch.float64
    )
    torch.testing.assert_close(m, 0.5 * (m_fsai + m_fsai.T), rtol=1e-12,
                               atol=0.0)


FRAMES = (Path(__file__).resolve().parents[1] / "assets"
          / "checkpoints_frames" / "best.msgpack")
FRAMES_N_PAD = 640


def _frames_case():
    """A frame-structure case on the generic plan (power 2, w 41): its
    pattern's block row spread (311) does not fit a range plan."""
    from deeppreconditioning_tpu_torch.data.frames import generate_frame_case

    case = generate_frame_case(np.random.default_rng(3), solve=False)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                        FRAMES_N_PAD)
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, FRAMES_N_PAD, power=2)
    args = (h.rows, h.cols, pr, pc, FRAMES_N_PAD)
    plan = fsai.build_fsai_plan(*args, width=41)
    ref = jax_fsai.build_fsai_plan(*args, width=41)
    return h.vals, h.scale, h.original_size, plan.to("cpu"), ref


def _frames_models():
    payload = flax.serialization.msgpack_restore(FRAMES.read_bytes())
    jax_model = JaxNeuralFSAI(width=int(payload["width"]),
                              hidden=int(payload["hidden"]),
                              poly_degree=int(payload["poly_degree"]))
    model = neural_fsai_from_checkpoint(load_checkpoint(FRAMES)).double()
    return jax_model, payload["params"], model


def test_frames_checkpoint_carries_across():
    payload = flax.serialization.msgpack_restore(FRAMES.read_bytes())
    _assert_same_tree(load_checkpoint(FRAMES), payload)
    assert (payload["width"], payload["hidden"], payload["poly_degree"],
            payload["power"]) == (41, 64, 2, 2)
    state = params_from_jax(payload["params"])
    model = neural_fsai_from_checkpoint(load_checkpoint(FRAMES))
    assert (model.width, model.hidden, model.poly_degree) == (41, 64, 2)
    assert state["dense0.weight"].shape == (64, 4 * 41)
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[name].numpy())


def test_generic_forward_matches_jax():
    vals, _, _, plan, ref = _frames_case()
    jax_model, params, model = _frames_models()
    want = jax_model.apply(params, ref, jnp.asarray(vals))
    with torch.no_grad():
        got = model(plan, torch.tensor(vals))
    np.testing.assert_allclose(got.c_vals.numpy(), np.asarray(want.c_vals),
                               rtol=1e-9,
                               atol=1e-12 * np.abs(want.c_vals).max())
    np.testing.assert_allclose(got.q_coeffs.numpy(),
                               np.asarray(want.q_coeffs), rtol=1e-12)


def test_generic_dense_preconditioner_matches_jax():
    vals, scale, n0, plan, ref = _frames_case()
    jax_model, params, model = _frames_models()
    want = np.asarray(jax_dense_m(jax_model, params, ref, jnp.asarray(vals),
                                  jnp.asarray(scale), n0,
                                  dtype=jnp.float64))
    with torch.no_grad():
        got = neural_fsai_dense_preconditioner(
            model, plan, torch.tensor(vals), torch.tensor(scale), n0,
            dtype=torch.float64,
        )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


# -- n0 as a device value, the setup graph's key and engagement rule ----------


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's threaded float32 products need not
    give the same bits from one call to the next."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32_setup_input(seed, kind, static_lo=False):
    """(plan, operand, scales, n0) of a sludge case at N_PAD in float32, on
    the range plan (dense A~) or the generic plan (tril values)."""
    case = generate_sludge_case(np.random.default_rng(seed), mesh_cells=1)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                        N_PAD)
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, N_PAD, power=4)
    if kind == "generic":
        plan = fsai.build_fsai_plan(h.rows, h.cols, pr, pc, N_PAD, width=24)
        operand = h.vals
    else:
        plan = fsai.build_range_fsai_plan(pr, pc, N_PAD, width=24,
                                          range_h=128, static_lo=static_lo)
        operand = np.zeros((N_PAD, N_PAD))
        operand[h.rows, h.cols] = h.vals
        operand = operand + np.tril(operand, -1).T
    return (plan, torch.tensor(operand, dtype=torch.float32),
            torch.tensor(h.scale, dtype=torch.float32), h.original_size)


@pytest.mark.parametrize("kind", ["range", "generic"])
@torch.no_grad()
def test_n0_tensor_gives_the_int_bits(kind, one_thread):
    """A 0-dim int64 ``n0`` (the setup graph's static value) masks as the
    int does: the same M, bit for bit."""
    model = neural_fsai_from_checkpoint(load_checkpoint(BEST))
    for seed in (0, 1):
        plan, operand, scales, n0 = _f32_setup_input(seed, kind)
        plan = plan.to("cpu")
        want = neural_fsai_dense_preconditioner(model, plan, operand,
                                                scales, n0)
        got = neural_fsai_dense_preconditioner(
            model, plan, operand, scales, torch.tensor(n0))
        assert torch.equal(got, want)
        assert n0 < N_PAD and not want[n0:].any()


@torch.no_grad()
def test_group_n0_tensor_gives_the_per_case_bits(one_thread):
    """A group of 3 with one int64 ``n0`` a case gives each case's M of
    the per-case setup with an int ``n0``, bit for bit."""
    model = neural_fsai_from_checkpoint(load_checkpoint(BEST))
    inputs = [_f32_setup_input(seed, "range", static_lo=True)
              for seed in (0, 1, 2)]
    n0s = [n0 for *_, n0 in inputs]
    assert len(set(n0s)) == 3
    got = neural_fsai_dense_preconditioner(
        model, fsai.stack_plans([p for p, *_ in inputs]).to("cpu"),
        torch.stack([o for _, o, _, _ in inputs]),
        torch.stack([s for _, _, s, _ in inputs]), torch.tensor(n0s))
    for i, (plan, operand, scales, n0) in enumerate(inputs):
        want = neural_fsai_dense_preconditioner(model, plan.to("cpu"),
                                                operand, scales, n0)
        assert torch.equal(got[i], want)


def _cell_case(seed, dtype=torch.float32, **plan_args):
    """(plan, operand, scales, n0) of a case of the per-case cell's shape:
    a mesh_cells-2 sludge case in n_pad 1024, power 4, w 24, H 128."""
    n_pad = 1024
    case = generate_sludge_case(np.random.default_rng(seed), mesh_cells=2)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                        n_pad)
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, n_pad, power=4)
    plan = fsai.build_range_fsai_plan(
        pr, pc, n_pad, width=24, **{"range_h": 128, **plan_args})
    return (plan.to("cpu"), torch.zeros((n_pad, n_pad), dtype=dtype),
            torch.ones(n_pad, dtype=dtype), h.original_size)


def test_setup_key_ignores_n0_and_plan_values():
    """Two cases of the cell's shape, other n0 and other plan values,
    share a key; another H, static window starts, precision or dtype
    give another."""
    model = neural_fsai_from_checkpoint(load_checkpoint(BEST))

    def key(case, dtype=torch.float32, precision=None):
        return neural_fsai._setup_key(model, *case, dtype, precision)[0]

    first, second = _cell_case(0), _cell_case(1)
    assert first[3] != second[3]
    assert not torch.equal(first[0].local, second[0].local)
    base = key(first)
    assert key(second) == base
    hash(base)
    others = [
        key(_cell_case(0, range_h=256)),
        key(_cell_case(0, static_lo=True)),
        key(first, precision="bf16"),
        key(first, dtype=torch.float64),
        key(_cell_case(0, dtype=torch.float64), dtype=torch.float64),
        key(first[:3] + (torch.tensor([first[3]]),)),
    ]
    assert len({base, *others}) == len(others) + 1
    _, leaves = neural_fsai._setup_key(model, *first, torch.float32, None)
    assert len(leaves) == 7  # lo, local, pos, diag_pad, out_rows, A~, D


@pytest.mark.parametrize("name,want", [
    ("cpu operand", "device"),
    ("operand needs a gradient", "grad"),
    ("parameter needs a gradient", "grad"),
    ("parameter needs a gradient, grad mode off", "device"),
])
def test_setup_eager_because(name, want):
    model = NeuralFSAI(width=24, hidden=64, poly_degree=2)
    plan, operand, scales, n0 = _cell_case(0)
    if name == "operand needs a gradient":
        operand.requires_grad_()
    if not name.startswith("parameter"):
        model.requires_grad_(False)
    _, leaves = neural_fsai._setup_key(model, plan, operand, scales, n0,
                                       torch.float32, None)
    with torch.set_grad_enabled(not name.endswith("grad mode off")):
        assert graphs.eager_because(leaves, model.parameters()) == want
