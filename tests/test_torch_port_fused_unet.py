"""The port's U-Net forward with the conv backbone as one kernel
(ops/fused_unet.py) against the JAX package's ``make_fused_unet`` in
interpret mode, and the kernel's program (one cluster of 8 CTAs per batch
row) emulated in numpy.

Tolerances rtol = 5e-4, atol = 5e-5, the JAX suite's for the fused U-Net
(tests/test_fused_unet.py:27): one fp32 forward, summed in other orders.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.ops.fused_unet import make_fused_unet as jax_fused_unet
from mpc_via_diffusion_model_tpu_torch.models import TemporalUnet, from_flax_params, load_flagship
from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import make_fused_unet
from torch_port_util import SMALL, emulate_fused_unet_kernel, randomize

torch.set_num_threads(1)

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts" / "flagship" / "ema_params.pkl"
RTOL, ATOL = 5e-4, 5e-5


def _models(cfg_indicator: bool, seed: int = 41):
    cfg = dict(SMALL, cfg_indicator=cfg_indicator)
    jm = JaxUnet(conditioning_type="default", **cfg)
    h, c = cfg["n_support_points"], cfg["context_dim"]
    args = [jnp.zeros((1, h, 1)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, c))]
    if cfg_indicator:
        args.append(jnp.zeros((1, 1)))
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), seed)
    tm = TemporalUnet(**cfg)
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm.eval()


def _inputs(seed: int, b: int, h: int):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, 1).astype(np.float32)
    t = rng.randint(0, 25, size=b).astype(np.int32)
    ctx = rng.randn(b, 5).astype(np.float32)
    mask = np.array([[0.0], [1.0]] * (b // 2), np.float32)  # the CFG doubling: kept, dropped
    return x, t, ctx, mask


@pytest.mark.parametrize("cfg_indicator", [True, False])
def test_plain_fused_unet_matches_jax_interpret(cfg_indicator):
    jm, params, tm = _models(cfg_indicator)
    x, t, ctx, mask = _inputs(1, 2, SMALL["n_support_points"])
    want = jax_fused_unet(jm, params, batch_size=2, interpret=True)(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(mask))
    fused = make_fused_unet(tm, batch_size=2, device="cpu")
    got = fused(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(ctx),
                torch.from_numpy(mask))
    assert (fused.launches, fused.plain_calls) == (0, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the split forward (features, then the final 1x1) is the module's forward
    with torch.no_grad():
        whole = tm(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(ctx),
                   torch.from_numpy(mask))
    torch.testing.assert_close(got, whole, rtol=0, atol=0)


def test_fused_unet_refuses_other_batch_sizes():
    tm = _models(True)[2]
    fused = make_fused_unet(tm, batch_size=2, device="cpu")
    x, t, ctx, mask = (torch.from_numpy(a) for a in _inputs(2, 4, SMALL["n_support_points"]))
    with pytest.raises(ValueError, match="built for batch 2, got 4"):
        fused(x, t.long(), ctx, mask)
    with pytest.raises(ValueError, match="CUDA"):
        fused.kernel(x[:2], t[:2].long(), ctx[:2], mask[:2])  # a CPU tensor never reaches the kernel
    assert (fused.launches, fused.plain_calls) == (0, 0)


@pytest.mark.parametrize("which", ["small", "flagship"])
def test_fused_unet_kernel_program_emulation_matches_plain(which):
    """``csrc/fused_unet.cu``'s program (one cluster of 8 CTAs per batch
    row, the cluster body on the row with FiLM row b of (n_res, B, max_c))
    run in numpy on the rank-major buffer the kernel reads, 8 NaN-filled
    shared images per row, equals the plain forward."""
    tm = _models(True)[2] if which == "small" else load_flagship(FLAGSHIP, device="cpu")
    h = tm.n_support_points
    fused = make_fused_unet(tm, batch_size=2, device="cpu")
    x, t, ctx, mask = (torch.from_numpy(a) for a in _inputs(3, 2, h))
    with torch.no_grad():
        want = fused.plain(x, t.long(), ctx, mask)
        films = fused.films(fused.model.conditioning(t.long(), ctx, mask)).numpy()
        y, _ = emulate_fused_unet_kernel(fused.packed, fused.cluster.weights, films, x.numpy())
        got = fused.final_1x1(torch.from_numpy(y))
    assert np.all(np.isfinite(y))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_fused_unet_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card at the
    flagship's full width, batch 2: 1e-4, chip_smoke.py's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    fused = make_fused_unet(load_flagship(FLAGSHIP, device="cuda"), batch_size=2, device="cuda")
    x, t, ctx, mask = (torch.from_numpy(a).cuda() for a in _inputs(4, 2, 32))
    got = fused(x, t.long(), ctx, mask)
    torch.cuda.synchronize()
    want = fused.plain(x, t.long(), ctx, mask)
    assert fused.launches == 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
