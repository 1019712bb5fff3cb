"""The port's datasets and small utilities against the JAX package, on the
CPU: ``ControlSequenceDataset`` (its normalizers' statistics, normalized
arrays, accessors, ``.npz`` files both ways, minibatches),
``train_val_split`` and ``specified_split`` (the same numpy draws, so the
same indices), and ``utils/misc``.

Inputs are made with numpy from a seed. The normalized arrays agree to
float32 rounding (1e-6): both sides fit the statistics in numpy and apply
the same formula.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.data import datasets as jax_ds
from mpc_via_diffusion_model_tpu.utils import misc as jax_misc
from mpc_via_diffusion_model_tpu_torch.data import (ControlSequenceDataset, specified_split,
                                                    train_val_split)
from mpc_via_diffusion_model_tpu_torch.utils import misc

torch.set_num_threads(1)

N, H, DU, DX = 200, 8, 1, 4


def _arrays(seed=0, constant_dim=False):
    rng = np.random.RandomState(seed)
    inputs = (rng.randn(N, H, DU) * 7 + 1).astype(np.float32)
    condition = (rng.randn(N, DX) * [1, 2, 0.5, 3]).astype(np.float32)
    if constant_dim:  # where safe_limits pads, and limits divide 0 by 0 as in JAX
        condition[:, 1] = 0.25
    return inputs, condition


@pytest.mark.parametrize("kind", ["LimitsNormalizer", "GaussianNormalizer", "SafeLimitsNormalizer",
                                  "FixedLimitsNormalizer", "Identity"])
def test_from_arrays_matches_jax(kind):
    inputs, condition = _arrays(constant_dim=True)
    ds = ControlSequenceDataset.from_arrays(inputs, condition, kind, device="cpu")
    jds = jax_ds.ControlSequenceDataset.from_arrays(inputs, condition, kind)
    for field in ("inputs", "condition"):
        got, want = ds.normalizer.stats[field], jds.normalizer.stats[field]
        assert got.kind == want.kind
        for k in ("mins", "maxs", "means", "stds"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), k)
    np.testing.assert_array_equal(ds.inputs.numpy(), inputs)
    np.testing.assert_allclose(ds.inputs_normalized.numpy(), np.asarray(jds.inputs_normalized),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ds.condition_normalized.numpy(),
                               np.asarray(jds.condition_normalized), rtol=1e-6, atol=1e-6)
    assert (ds.n_init, ds.n_support_points, ds.state_dim, ds.condition_dim, len(ds)) == (
        jds.n_init, jds.n_support_points, jds.state_dim, jds.condition_dim, len(jds))
    x0 = np.random.RandomState(1).randn(5, DX).astype(np.float32)
    u = np.random.RandomState(2).uniform(-1.5, 1.5, (5, H, DU)).astype(np.float32)
    np.testing.assert_allclose(ds.normalize_condition(torch.from_numpy(x0)).numpy(),
                               np.asarray(jds.normalize_condition(jnp.asarray(x0))), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ds.unnormalize_states(torch.from_numpy(u)).numpy(),
                               np.asarray(jds.unnormalize_states(jnp.asarray(u))), rtol=1e-6,
                               atol=1e-5)


def test_npz_both_ways_and_refusals(tmp_path):
    inputs, condition = _arrays(3)
    ds = ControlSequenceDataset.from_arrays(inputs, condition, device="cpu")
    ds.save(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "port.npz") as z:
        assert set(z.files) == {"inputs", "condition"}
    jds = jax_ds.ControlSequenceDataset.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(jds.inputs), inputs)
    jds.save(str(tmp_path / "jax.npz"))
    back = ControlSequenceDataset.load(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_array_equal(back.condition.numpy(), condition)
    np.testing.assert_array_equal(back.inputs_normalized.numpy(), ds.inputs_normalized.numpy())
    with pytest.raises(ValueError, match=".npz"):
        ControlSequenceDataset.load(str(tmp_path / "x.css"), device="cpu")
    with pytest.raises(ValueError, match="inputs"):
        ControlSequenceDataset.from_arrays(inputs[:, :, 0], condition, device="cpu")


def test_batch_draws_with_replacement():
    inputs, condition = _arrays(4)
    ds = ControlSequenceDataset.from_arrays(inputs, condition, device="cpu")
    x, c = ds.batch(torch.Generator().manual_seed(0), 1000)
    idx = torch.randint(0, N, (1000,), generator=torch.Generator().manual_seed(0))
    assert torch.equal(x, ds.inputs_normalized[idx]) and torch.equal(c, ds.condition_normalized[idx])
    assert len(set(idx.tolist())) < N and x.shape == (1000, H, DU)  # with replacement


@pytest.mark.parametrize("n,frac,seed", [(100, 0.05, 0), (1234, 0.1, 3), (7, 0.05, 1)])
def test_train_val_split_equals_jax(n, frac, seed):
    got, want = train_val_split(n, frac, seed), jax_ds.train_val_split(n, frac, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_specified_split_equals_jax():
    ranges = (range(0, 40), range(40, 80), iter(range(80, 100)), range(100, 120))
    got = specified_split(*ranges, val_fraction=0.1)
    want = jax_ds.specified_split(range(0, 40), range(40, 80), iter(range(80, 100)),
                                  range(100, 120), val_fraction=0.1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int64
    for bad in ((range(3), range(4), range(2), range(2)), (range(2), range(2), range(3), range(2))):
        with pytest.raises(ValueError, match="equal length"):
            specified_split(*bad)


def test_misc_matches_jax():
    for number, max_val, min_val in ((3, 5, 0), (np.array([0, 4, 7]), 8, 2), (9, 5, 0)):
        got = misc.to_one_hot(torch.as_tensor(number), max_val, min_val)
        want = jax_misc.to_one_hot(jnp.asarray(number), max_val, min_val)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.float32
    with pytest.raises(ValueError):
        misc.to_one_hot(1, 2, 2)
    hot = np.random.RandomState(0).rand(6, 5).astype(np.float32)
    np.testing.assert_array_equal(misc.from_one_hot(torch.from_numpy(hot)).numpy(),
                                  np.asarray(jax_misc.from_one_hot(jnp.asarray(hot))))
    x = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    w = np.random.RandomState(2).randn(2, 3).astype(np.float32)
    got = misc.batch_jacobian(lambda v: torch.tanh(torch.from_numpy(w) @ v) * v[0], torch.from_numpy(x))
    want = jax_misc.batch_jacobian(lambda v: jnp.tanh(jnp.asarray(w) @ v) * v[0], jnp.asarray(x))
    assert got.shape == (4, 2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for args in ((32, 5, 2, 1), (32, 4, 1, 2), (7, 3)):
        assert misc.calc_output(*args) == jax_misc.calc_output(*args)
    for args in ((16, 4, 1, 2), (5, 3, 0, 1, 2)):
        assert misc.calc_output_conv2d_transpose(*args) == jax_misc.calc_output_conv2d_transpose(*args)
    g1, g2 = misc.fix_random_seed(7), misc.fix_random_seed(7)
    assert torch.equal(torch.rand(3, generator=g1), torch.rand(3, generator=g2))
    p = {"a": torch.ones(2, requires_grad=True)}
    frozen = misc.freeze_params(p)
    assert not frozen["a"].requires_grad and frozen["a"].data_ptr() == p["a"].data_ptr()
    moved = misc.dict_to_device({"b": torch.zeros(2)}, "cpu")
    assert moved["b"].device.type == "cpu"
