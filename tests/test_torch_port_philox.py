"""The in-kernel noise's plain twin (ops/philox.py): Philox4x32-10 against
the known-answer vectors of Random123 (Salmon et al., SC 2011), the
Box-Muller map against the JAX package's ``_bits_to_normal``, the
distribution of the normals as ``tests/test_fused_episode.py:341`` holds
the JAX map's, and the counter layout of the episode's staged table. The
kernel's own draw is held to this twin on the card (``gpu``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.ops.fused_episode import _bits_to_normal, _key_to_seeds
from mpc_via_diffusion_model_tpu_torch.ops import philox

KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    assert tuple(int(w) for w in philox.philox4x32_10(counter, key)) == want
    got = philox.words(torch.tensor([counter]), torch.tensor([key]))  # the CPU path of the wrapper
    assert tuple(got[0].tolist()) == want


def test_bits_to_normal_matches_jax():
    rng = np.random.RandomState(5)
    b1 = rng.randint(0, 2 ** 32, size=(4096,), dtype=np.uint64)
    b2 = rng.randint(0, 2 ** 32, size=(4096,), dtype=np.uint64)
    b1[:3], b2[:3] = [0, 2 ** 32 - 1, 255], [0, 2 ** 32 - 1, 2 ** 31]  # u1 at 2^-24 and at 1
    want = np.asarray(_bits_to_normal(jnp.asarray(b1.astype(np.uint32)),
                                      jnp.asarray(b2.astype(np.uint32))))
    got = philox.bits_to_normal(torch.from_numpy(b1.astype(np.int64)),
                                torch.from_numpy(b2.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_twin_normals_are_standard_normal():
    """2^20 normals of one episode's table, to the JAX suite's tolerances."""
    seed = philox.seed_from_generator(torch.Generator().manual_seed(7))
    z = philox.normal_table(seed, (1024, 16, 16, 4)).double().numpy().reshape(-1)
    assert np.all(np.isfinite(z))
    assert abs(z.mean()) < 5e-3
    assert abs(z.std() - 1.0) < 5e-3
    assert abs((np.abs(z) < 1.96).mean() - 0.95) < 2e-3
    assert abs((np.abs(z) < 2.58).mean() - 0.99) < 1e-3
    assert abs((z ** 3).mean()) < 2e-2
    assert abs((z ** 4).mean() - 3.0) < 5e-2


def test_table_counter_layout_and_seeds():
    """Entry (s, k, t, d) is the normal of words 0 and 1 of counter
    (s, k, t, d) under the seed's two words; a JAX key's seed words are its
    data; the generator's seeds are int32 and differ."""
    seed = torch.tensor([-7, 123456789], dtype=torch.int32)
    shape = (3, 2, 5, 4)
    tab = philox.normal_table(seed, shape)
    assert tab.shape == shape and tab.dtype == torch.float32
    k0, k1 = philox.seed_words(seed)
    assert (k0, k1) == (2 ** 32 - 7, 123456789)
    for s, k, t, d in ((0, 0, 0, 0), (2, 1, 4, 3), (1, 0, 3, 2)):
        w0, w1, _, _ = philox.philox4x32_10((s, k, t, d), (k0, k1))
        assert tab[s, k, t, d] == philox.bits_to_normal(w0, w1)
    assert torch.equal(philox.table(seed, shape), tab)  # the CPU path of the wrapper
    jseed = np.asarray(_key_to_seeds(jax.random.PRNGKey(11)))
    assert jseed.dtype == np.int32 and jseed.shape == (2,)
    np.testing.assert_array_equal(philox.normal_table(torch.from_numpy(jseed), shape).numpy(),
                                  philox.normal_table(torch.from_numpy(jseed.copy()), shape).numpy())
    g = torch.Generator().manual_seed(0)
    a, b = philox.seed_from_generator(g), philox.seed_from_generator(g)
    assert a.dtype == torch.int32 and a.shape == (2,) and not torch.equal(a, b)
    assert not torch.equal(philox.normal_table(a, shape), philox.normal_table(b, shape))
