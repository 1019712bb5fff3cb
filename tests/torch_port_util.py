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


def _emulate_unet_body(W, m, smem, nb, film_rows, x_rows):
    """``unet_body<nb>`` of ``csrc/unet_body.cuh`` in numpy, op by op, on the
    shared-memory image ``smem``: it reads the packed weights and the meta
    table with the kernel's indices, keeps activations in the kernel's
    (nb, h + 2*HALO, c) layout and rotates its three buffers the same way.
    ``film_rows`` (n_res, nb, max_c) are the FiLM rows of the row-sets,
    ``x_rows`` (nb, H, D) the input; returns y (nb, H, dims[1])."""
    halo = up.HALO
    H, D, nlev, buf = (int(m[k]) for k in (up.M_H, up.M_D, up.M_NLEV, up.M_BUF))

    def view(off, h, c, limit=buf):
        n = nb * (h + 2 * halo) * c
        assert n <= limit, "activation larger than its shared-memory region"
        return smem[off:off + n].reshape(nb, h + 2 * halo, c)

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
        v = y[:, halo:halo + h].reshape(nb, h, groups, c // groups)
        mean = v.mean(axis=(1, 3), keepdims=True)
        var = np.maximum((v * v).mean(axis=(1, 3), keepdims=True) - mean * mean, 0.0)
        v = ((v - mean) / np.sqrt(var + 1e-5)).reshape(nb, h, c)
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

    cur, f1, f2 = 0, buf, 2 * buf
    x_in = view(cur, H, D)
    x_in[:, halo:halo + H] = x_rows
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
            n = nb * (h + 2 * halo) * c
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
    return view(f1, h, cf)[:, halo:halo + H].copy()


def _emulate_chain_step(W, m, smem, film_rows, xs, coefs_si, noise_si, w):
    """One CFG chain step of cfg_chain.cu / cfg_episode.cu on the sample xs."""
    D = int(m[up.M_D])
    cf = int(m[up.M_DIMS + 1])
    y = _emulate_unet_body(W, m, smem, 2, film_rows, np.stack([xs, xs]))
    eps = y @ W[m[up.M_F1]:m[up.M_F1] + cf * D].reshape(cf, D) + W[m[up.M_F1 + 1]:m[up.M_F1 + 1] + D]
    sra, srm, c1, c2, sg = (np.float32(v) for v in coefs_si)
    rc = sra * xs - srm * eps[0]
    ru = sra * xs - srm * eps[1]
    rec = np.clip(np.float32(1.0 + w) * rc - np.float32(w) * ru, -1.0, 1.0)
    return (c1 * rec + c2 * xs) + sg * noise_si


def _image(n_floats):
    return np.full(n_floats, np.nan, np.float32)


def emulate_cfg_chain_kernel(packed, films, noise_tab, coefs, w):
    """Runs ``csrc/cfg_chain.cu``'s program in numpy, op by op, on a shared
    memory image filled with NaN. A read of a halo the kernel never zeroed,
    or of a buffer it never wrote, turns the output to NaN."""
    W = packed.weights.cpu().numpy()
    m = packed.meta.cpu().numpy()
    n_total, b_all = noise_tab.shape[0] - 1, noise_tab.shape[1]
    out = np.empty((b_all,) + noise_tab.shape[2:], np.float32)
    for sample in range(b_all):
        smem = _image(int(m[up.M_SMEM]))
        xs = noise_tab[n_total, sample].copy()
        for si in range(n_total):
            film_rows = films[si][:, [sample, b_all + sample]]  # (n_res, 2, max_c)
            xs = _emulate_chain_step(W, m, smem, film_rows, xs, coefs[si], noise_tab[si, sample], w)
        out[sample] = xs
    return out


def emulate_fused_unet_kernel(packed, films, x):
    """Runs ``csrc/fused_unet.cu``'s program in numpy: one block per batch
    element, ``unet_body<1>`` with FiLM row b of films (n_res, B, max_c)."""
    W = packed.weights.cpu().numpy()
    m = packed.meta.cpu().numpy()
    return np.stack([
        _emulate_unet_body(W, m, _image(int(m[up.M_SMEM])), 1, films[:, [b]], x[b:b + 1])[0]
        for b in range(x.shape[0])])


def cartpole_step_f32(x, u, dt):
    """``csrc/plants.cuh``'s CartpoleSwingup::step in float32 numpy, in its
    order of operations."""
    f = np.float32
    s, c = np.sin(x[2]), np.cos(x[2])
    x3sq = x[3] * x[3]
    den1 = f(3.0) - f(1.0) * c
    xd1 = ((f(1.0) * -s) * x3sq + (f(9.81) * s) * c + u[0]) / (den1 * den1)
    num3 = ((f(-1.0) * s) * c) * x3sq - f(29.43) * s - c * u[0]
    xd3 = num3 / (f(29.43) - f(1.0) * (c * c))
    xd4 = (f(-2.0 / np.pi) * (x[2] - f(np.pi))) * x[3]
    xdot = np.array([x[1], xd1, x[3], xd3, xd4], np.float32)
    return (x + xdot * f(dt)).astype(np.float32)


def _emulate_episode(packed, t_embs, consts, x0, n_candidates, selection_horizon, n_steps,
                     n_groups, first_plans, chain_step):
    """The program both episode kernels share (``csrc/episode.cuh`` and the
    kernels' replan loops), in numpy: the affine normalize, the per-step
    FiLM of ``n_groups`` groups from the FiLM weights the meta table points
    at (M_FW, M_FB, M_COND, M_TEMB, M_CTX), written into the shared image at
    M_EP_FILM and M_EP_MC, the chains of the K candidates
    (``chain_step(W, m, smem, films, x, step, si, k)``, from
    ``first_plans(step)``), the unnormalize, the candidate rollouts scored
    from ``consts`` and the one-hot choice, the stage cost and the plant
    step. The shared image is sized by the episode plan and filled with NaN,
    so a region that overlaps another or is read before it is written shows."""
    W = packed.weights.cpu().numpy()
    m = packed.meta.cpu().numpy()
    K, sel_h = n_candidates, selection_horizon
    H, D, n_res, maxc = (int(m[k]) for k in (up.M_H, up.M_D, up.M_NRES, up.M_MAXC))
    cond, temb, dctx = (int(m[k]) for k in (up.M_COND, up.M_TEMB, up.M_CTX))
    n_total = t_embs.shape[0]
    c = consts
    cn_shift, cn_scale, un_shift, un_scale = c[0:5], c[5:10], c[10:11], c[11:12]
    q, r, sq, sr, sp, dt = c[12:17], c[17:18], c[18:23], c[23:24], c[24:29], c[29]
    Fw = W[m[up.M_FW]:m[up.M_FW] + n_res * cond * maxc].reshape(n_res, cond, maxc)
    Fb = W[m[up.M_FB]:m[up.M_FB] + n_res * maxc].reshape(n_res, maxc)
    smem = _image(packed.episode_smem_bytes(K) // 4)
    films = smem[m[up.M_EP_FILM]:m[up.M_EP_FILM] + n_res * n_groups * maxc].reshape(n_res, n_groups, maxc)
    mc = smem[m[up.M_EP_MC]:m[up.M_EP_MC] + n_groups * cond].reshape(n_groups, cond)
    cand_off = int(m[up.M_EP_SMEM]) + up.align4(up.M_LEN)
    cand = smem[cand_off:cand_off + K * H * D].reshape(K, H, D)
    x = x0.astype(np.float32)
    xs, us, stages, chosen = [x], [], [], []
    for step in range(n_steps):
        ctx = (x - cn_shift) * cn_scale
        cand[:] = first_plans(step)
        for si in range(n_total):
            for g in range(n_groups):
                bit = [np.float32(1.0 - g)] if cond > temb + dctx else []
                mc[g] = _mish(np.concatenate([t_embs[si], ctx * np.float32(1 - g), bit]))
            films[:] = 0.0
            for rr in range(n_res):
                cout = int(m[up.M_RES + rr * up.RES_STRIDE + up.R_COUT])
                films[rr, :, :cout] = (mc @ Fw[rr] + Fb[rr])[:, :cout]
            for k in range(K):
                cand[k] = chain_step(W, m, smem, films, cand[k].copy(), step, si, k)
        plans = np.clip(cand, -1.0, 1.0) * un_scale + un_shift
        if K == 1:
            best, u0 = 0, plans[0, 0]
        else:
            score = np.zeros(K, np.float32)
            for k in range(K):
                xc = x.copy()
                for t in range(sel_h):
                    score[k] += np.sum(sq * xc * xc) + np.sum(sr * plans[k, t] * plans[k, t])
                    xc = cartpole_step_f32(xc, plans[k, t], dt)
                if sel_h == H:
                    score[k] += np.sum(sp * xc * xc)
            mn = np.min(score)
            hits = np.nonzero(score == mn)[0]
            best = int(hits[0]) if hits.size else K
            u0 = (np.arange(K) == best).astype(np.float32) @ plans[:, 0]
        stages.append(np.sum(q * x * x) + np.sum(r * u0 * u0))
        x = cartpole_step_f32(x, u0, dt)
        xs.append(x)
        us.append(u0)
        chosen.append(best)
    return np.stack(xs), np.stack(us), np.array(stages, np.float32), np.array(chosen)


def emulate_cfg_episode_kernel(packed, t_embs, noise, coefs, consts, x0, w, n_candidates,
                               selection_horizon, n_steps):
    """Runs ``csrc/cfg_episode.cu``'s program in numpy (``_emulate_episode``
    with the two FiLM groups and the CFG chain step on both row-sets).
    ``noise`` has the wrapper's layout (n_steps, n_total + 1, K, H, D) with
    row n_total = x_T."""
    n_total = noise.shape[1] - 1

    def step(W, m, smem, films, x, si_step, si, k):
        return _emulate_chain_step(W, m, smem, films, x, coefs[si], noise[si_step, si, k], w)

    return _emulate_episode(packed, t_embs, consts, x0, n_candidates, selection_horizon, n_steps,
                            2, lambda s: noise[s, n_total], step)


def _emulate_ddim_step(W, m, smem, film_rows, xs, coefs_si):
    """One step of ddim_chain.cu / ddim_episode.cu on the sample xs: the
    body on one row-set, the final 1x1 conv and the affine update."""
    D = int(m[up.M_D])
    cf = int(m[up.M_DIMS + 1])
    y = _emulate_unet_body(W, m, smem, 1, film_rows, xs[None])
    eps = y[0] @ W[m[up.M_F1]:m[up.M_F1] + cf * D].reshape(cf, D) + W[m[up.M_F1 + 1]:m[up.M_F1 + 1] + D]
    sra, srm, c1, c2 = (np.float32(v) for v in coefs_si)
    rec = np.clip(sra * xs - srm * eps, -1.0, 1.0)
    return c1 * rec + c2 * xs


def emulate_ddim_chain_kernel(packed, films, x_init, coefs):
    """Runs ``csrc/ddim_chain.cu``'s program in numpy on a NaN-filled
    shared image: one block per sample, ``unet_body<1>`` with FiLM row b of
    each step's films (n_total, n_res, B, max_c), from x_init (B, H, D)."""
    W = packed.weights.cpu().numpy()
    m = packed.meta.cpu().numpy()
    out = np.empty_like(x_init)
    for b in range(x_init.shape[0]):
        smem = _image(int(m[up.M_SMEM]))
        xs = x_init[b].copy()
        for si in range(coefs.shape[0]):
            xs = _emulate_ddim_step(W, m, smem, films[si][:, [b]], xs, coefs[si])
        out[b] = xs
    return out


def emulate_ddim_episode_kernel(packed, t_embs, noise, coefs, consts, x0, n_candidates,
                                selection_horizon, n_steps):
    """Runs ``csrc/ddim_episode.cu``'s program in numpy (``_emulate_episode``
    with the one FiLM group and the DDIM step on one row-set). ``noise`` is
    (n_steps, K, H, D), each replan's initial draw."""
    def step(W, m, smem, films, x, si_step, si, k):
        return _emulate_ddim_step(W, m, smem, films, x, coefs[si])

    return _emulate_episode(packed, t_embs, consts, x0, n_candidates, selection_horizon, n_steps,
                            1, lambda s: noise[s], step)
