"""Shared helpers of the PyTorch-port tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and cross between the frameworks as
numpy arrays.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu_torch.models import TemporalUnet, from_flax_params
from mpc_via_diffusion_model_tpu_torch.ops import unet_pack as up

# The port's CPU tests run tiny tensors, where torch's intra-op threads cost
# more than they save, and the suite runs several test processes at once.
torch.set_num_threads(1)

# A small U-Net with the flagship's structure (three levels, so the kernel's
# skips at levels 1 and 2 are both exercised) for the Pallas interpret-mode
# comparisons, which are slow at full width.
SMALL = dict(state_dim=1, n_support_points=16, unet_input_dim=8, dim_mults=(1, 2, 4),
             context_dim=5, cfg_indicator=True)


def randomize(params, seed: int, scale: float = 0.3):
    """Every leaf of a flax param tree replaced by N(0, scale^2) numpy draws
    (flax initialises biases and GroupNorm to constants, which would hide
    layout mistakes)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * scale).astype(np.float32), params)


def small_models(seed: int = 0):
    """(flax model, numpy params, torch model) of the SMALL config."""
    cfg = dict(SMALL)
    jm = JaxUnet(conditioning_type="default", **cfg)
    h, d, c = cfg["n_support_points"], cfg["state_dim"], cfg["context_dim"]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, h, d)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, c)), jnp.zeros((1, 1)))
    params = randomize(shapes, seed)
    tm = TemporalUnet(**cfg)
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm.eval()


def _mish(x):
    return x * np.tanh(np.logaddexp(x, 0.0))


def emulate_cfg_chain_kernel(packed, films, noise_tab, coefs, w):
    """Runs ``csrc/cfg_chain.cu``'s program in numpy, op by op, on a shared
    memory image filled with NaN: it reads the packed weights and the meta
    table with the kernel's indices, keeps activations in the kernel's
    (2, h + 2*HALO, c) layout and rotates its three buffers the same way.
    A read of a halo the kernel never zeroed, or of a buffer it never wrote,
    turns the output to NaN."""
    W = packed.weights.cpu().numpy()
    m = packed.meta.cpu().numpy()
    halo = up.HALO
    n_total, b_all = noise_tab.shape[0] - 1, noise_tab.shape[1]
    H, D, nlev, maxc, buf = (int(m[k]) for k in (up.M_H, up.M_D, up.M_NLEV, up.M_MAXC, up.M_BUF))
    out = np.empty((b_all, H, D), np.float32)

    for sample in range(b_all):
        smem = np.full(int(m[up.M_SMEM]), np.nan, np.float32)

        def view(off, h, c, limit=buf):
            n = 2 * (h + 2 * halo) * c
            assert n <= limit, "activation larger than its shared-memory region"
            return smem[off:off + n].reshape(2, h + 2 * halo, c)

        def weights(off, shape):
            return W[off:off + int(np.prod(shape))].reshape(shape)

        def conv(src, hin, cin, dst, hout, cout, w_off, b_off, ks, stride, pad):
            x, y = view(src, hin, cin), view(dst, hout, cout)
            wk, bias = weights(w_off, (ks, cin, cout)), weights(b_off, (cout,))
            rows = halo + stride * np.arange(hout) - pad
            y[:, halo:halo + hout] = bias + sum(x[:, rows + k] @ wk[k] for k in range(ks))

        def zero_halo(off, h, c):
            y = view(off, h, c)
            y[:, :halo] = 0.0
            y[:, halo + h:] = 0.0

        def gn_mish(off, h, c, groups, g_off, be_off, film=None):
            y = view(off, h, c)
            v = y[:, halo:halo + h].reshape(2, h, groups, c // groups)
            mean = v.mean(axis=(1, 3), keepdims=True)
            var = np.maximum((v * v).mean(axis=(1, 3), keepdims=True) - mean * mean, 0.0)
            v = ((v - mean) / np.sqrt(var + 1e-5)).reshape(2, h, c)
            v = _mish(v * weights(g_off, (c,)) + weights(be_off, (c,)))
            if film is not None:
                v = v + film[:, None, :c]
            y[:, halo:halo + h] = v

        def res_block(r, src, t1, t2, h, film):
            rm = m[up.M_RES + r * up.RES_STRIDE:]
            cin, cout, groups = int(rm[up.R_CIN]), int(rm[up.R_COUT]), int(rm[up.R_GROUPS])
            conv(src, h, cin, t1, h, cout, rm[up.R_W1], rm[up.R_B1], 5, 1, 2)
            zero_halo(t1, h, cout)
            gn_mish(t1, h, cout, groups, rm[up.R_G1], rm[up.R_BE1], film)
            conv(t1, h, cout, t2, h, cout, rm[up.R_W2], rm[up.R_B2], 5, 1, 2)
            zero_halo(t2, h, cout)
            gn_mish(t2, h, cout, groups, rm[up.R_G2], rm[up.R_BE2])
            if rm[up.R_WR] >= 0:
                conv(src, h, cin, t1, h, cout, rm[up.R_WR], rm[up.R_BR], 1, 1, 0)
                view(t2, h, cout)[:, halo:halo + h] += view(t1, h, cout)[:, halo:halo + h]
            else:
                view(t2, h, cout)[:, halo:halo + h] += view(src, h, cout)[:, halo:halo + h]

        xs = noise_tab[n_total, sample].copy()
        for si in range(n_total):
            film_rows = films[si][:, [sample, b_all + sample]]  # (n_res, 2, max_c)
            cur, f1, f2 = 0, buf, 2 * buf
            x_in = view(cur, H, D)
            x_in[:, halo:halo + H] = xs[None]
            zero_halo(cur, H, D)
            h, r = H, 0
            for lvl in range(nlev):
                for _ in range(2):
                    res_block(r, cur, f1, f2, h, film_rows[r])
                    cur, f1, f2 = f2, cur, f1
                    r += 1
                c = int(m[up.M_DIMS + lvl + 1])
                if lvl > 0:
                    skip_off = int(m[up.M_SKIP + lvl])
                    n = 2 * (h + 2 * halo) * c
                    smem[skip_off:skip_off + n] = smem[cur:cur + n]
                if lvl < nlev - 1:
                    conv(cur, h, c, f1, h // 2, c, m[up.M_DOWN + 2 * lvl],
                         m[up.M_DOWN + 2 * lvl + 1], 3, 2, 1)
                    zero_halo(f1, h // 2, c)
                    h //= 2
                    cur, f1 = f1, cur
            for _ in range(2):
                res_block(r, cur, f1, f2, h, film_rows[r])
                cur, f1, f2 = f2, cur, f1
                r += 1
            for u in range(nlev - 1):
                lvl = nlev - 1 - u
                c = int(m[up.M_DIMS + lvl + 1])
                skip = view(int(m[up.M_SKIP + lvl]), h, c, limit=len(smem))
                cat = view(f1, h, 2 * c)
                cat[:, halo:halo + h] = np.concatenate(
                    [view(cur, h, c)[:, halo:halo + h], skip[:, halo:halo + h]], axis=-1)
                zero_halo(f1, h, 2 * c)
                cur, f1 = f1, cur
                for _ in range(2):
                    res_block(r, cur, f1, f2, h, film_rows[r])
                    cur, f1, f2 = f2, cur, f1
                    r += 1
                cd = int(m[up.M_DIMS + lvl])
                x, y = view(cur, h, cd), view(f1, 2 * h, cd)
                wu = weights(m[up.M_UP + 2 * u], (4, cd, cd))
                bu = weights(m[up.M_UP + 2 * u + 1], (cd,))
                t = np.arange(h)
                y[:, halo + 2 * t] = bu + x[:, halo + t - 1] @ wu[0] + x[:, halo + t] @ wu[2]
                y[:, halo + 2 * t + 1] = bu + x[:, halo + t] @ wu[1] + x[:, halo + t + 1] @ wu[3]
                zero_halo(f1, 2 * h, cd)
                h *= 2
                cur, f1 = f1, cur
            cf = int(m[up.M_DIMS + 1])
            conv(cur, h, cf, f1, h, cf, m[up.M_FIN], m[up.M_FIN + 1], 5, 1, 2)
            gn_mish(f1, h, cf, int(m[up.M_FIN + 4]), m[up.M_FIN + 2], m[up.M_FIN + 3])
            y = view(f1, h, cf)[:, halo:halo + H]
            eps = y @ weights(m[up.M_F1], (cf, D)) + weights(m[up.M_F1 + 1], (D,))
            sra, srm, c1, c2, sg = (np.float32(v) for v in coefs[si])
            rc = sra * xs - srm * eps[0]
            ru = sra * xs - srm * eps[1]
            rec = np.clip(np.float32(1.0 + w) * rc - np.float32(w) * ru, -1.0, 1.0)
            xs = (c1 * rec + c2 * xs) + sg * noise_tab[si, sample]
        out[sample] = xs
    return out
