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


def _image(n_floats, dtype=np.float32):
    return np.full(n_floats, np.nan, dtype)


def bf16_rne(v):
    """float32 -> bf16 -> float32, to nearest even, as an integer add and
    mask on the bits (finite values; overflow goes to inf): add 0x7FFF plus
    the lowest kept bit, then clear the 16 dropped bits."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
            & np.uint32(0xFFFF0000)).view(np.float32)


def _operand(bf16):
    """What the kernels do to a product's activation operand: round it to
    bf16 in the bf16 instantiation (kept in its own type), nothing in the
    float one."""
    return (lambda v: bf16_rne(v).astype(np.asarray(v).dtype)) if bf16 else (lambda v: v)


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


def cartpole_lmpc_step_f32(x, u, pc):
    """``csrc/plants.cuh``'s CartpoleLmpc::step in float32 numpy, in its
    order of operations: ``pc`` is the consts table from dt on, A_d
    row-major at pc[1:17] and B_d at pc[17:21]."""
    f = np.float32
    a, b = np.asarray(pc[1:17], f).reshape(4, 4), np.asarray(pc[17:21], f)
    xn = np.empty(4, f)
    for i in range(4):
        acc = f(a[i, 0] * x[0])
        for j in range(1, 4):
            acc = f(acc + f(a[i, j] * x[j]))
        xn[i] = f(acc + f(b[i] * u[0]))
    return xn


def quadrotor_step_f32(x, u, pc, sin=np.sin, cos=np.cos):
    """``csrc/plants.cuh``'s Quadrotor::step in float32 numpy, in its order
    of operations: ``pc`` is the consts table from dt on, dt, m, ixx, iyy,
    izz. ``sin`` and ``cos`` are numpy's unless given: libraries round them
    differently in the last bit (numpy and torch on the CPU in about one
    value of six), and given torch's the result is the torch step's bit for
    bit."""
    f = np.float32
    dt, m, inr = f(pc[0]), f(pc[1]), np.asarray(pc[2:5], f)
    cphi, sphi = f(cos(x[6])), f(sin(x[6]))
    cth, sth = f(cos(x[7])), f(sin(x[7]))
    cpsi, spsi = f(cos(x[8])), f(sin(x[8]))
    tm = u[0] / m
    z = np.array([cpsi * sth * cphi + spsi * sphi, spsi * sth * cphi - cpsi * sphi, cth * cphi], f)
    acc = z * tm - np.array([0.0, 0.0, 9.81], f)
    cs = np.maximum(cth, f(1e-3))
    tth = sth / cs
    w = x[9:12]
    rpy = np.array([w[0] + sphi * tth * w[1] + cphi * tth * w[2], cphi * w[1] - sphi * w[2],
                    (sphi * w[1] + cphi * w[2]) / cs], f)
    iw = inr * w
    gyro = np.array([w[1] * iw[2] - w[2] * iw[1], w[2] * iw[0] - w[0] * iw[2],
                     w[0] * iw[1] - w[1] * iw[0]], f)
    xdot = np.concatenate([x[3:6], acc, rpy, (u[1:4] - gyro) / inr]).astype(f)
    return (x + xdot * dt).astype(f)


def _f(v):
    return np.float32(v)


def _cross_f32(a, b):
    return [_f(_f(a[1] * b[2]) - _f(a[2] * b[1])), _f(_f(a[2] * b[0]) - _f(a[0] * b[2])),
            _f(_f(a[0] * b[1]) - _f(a[1] * b[0]))]


def _matvec_f32(r, v, transposed=False):
    out = []
    for i in range(3):
        row = [r[i], r[3 + i], r[6 + i]] if transposed else r[3 * i:3 * i + 3]
        out.append(_f(_f(_f(row[0] * v[0]) + _f(row[1] * v[1])) + _f(row[2] * v[2])))
    return out


def _add_f32(a, b):
    return [_f(x + y) for x, y in zip(a, b)]


def _panda_rne_f32(R, P, pc, qd, qdd, g):
    """``csrc/plants.cuh``'s PandaRbd::rne in float32 numpy, step by step."""
    mass, com, inr = pc[36:43], pc[43:64], pc[64:127]
    omega, omegad, vd = [_f(0)] * 3, [_f(0)] * 3, [_f(0), _f(0), _f(g)]
    F, N = [], []
    for i in range(7):
        r, p = R[9 * i:9 * i + 9], P[3 * i:3 * i + 3]
        c, inn = com[3 * i:3 * i + 3], inr[9 * i:9 * i + 9]
        v = _add_f32(_add_f32(vd, _cross_f32(omegad, p)), _cross_f32(omega, _cross_f32(omega, p)))
        vd = _matvec_f32(r, v, True)
        omega_r = _matvec_f32(r, omega, True)
        qdz = [_f(0), _f(0), _f(qd[i])]
        t1 = _add_f32(_matvec_f32(r, omegad, True), _cross_f32(omega_r, qdz))
        omegad = [_f(t1[0] + _f(0)), _f(t1[1] + _f(0)), _f(t1[2] + _f(qdd[i]))]
        omega = _add_f32(omega_r, qdz)
        vdc = _add_f32(_add_f32(vd, _cross_f32(omegad, c)), _cross_f32(omega, _cross_f32(omega, c)))
        F.append([_f(mass[i] * x) for x in vdc])
        N.append(_add_f32(_matvec_f32(inn, omegad), _cross_f32(omega, _matvec_f32(inn, omega))))
    f_next, n_next, tau = [_f(0)] * 3, [_f(0)] * 3, [None] * 7
    for i in reversed(range(7)):
        fc, nc = [_f(0)] * 3, [_f(0)] * 3
        if i < 6:
            fc = _matvec_f32(R[9 * (i + 1):9 * (i + 2)], f_next)
            nc = _add_f32(_matvec_f32(R[9 * (i + 1):9 * (i + 2)], n_next),
                          _cross_f32(P[3 * (i + 1):3 * (i + 2)], fc))
        c = com[3 * i:3 * i + 3]
        f_next = _add_f32(fc, F[i])
        n_next = _add_f32(_add_f32(N[i], nc), _cross_f32(c, F[i]))
        tau[i] = n_next[2]
    return tau


def panda_rbd_step_f32(x, u, pc, sin=np.sin, cos=np.cos, sqrt=np.sqrt):
    """``csrc/plants.cuh``'s PandaRbd::step in float32 numpy, in its order of
    operations: ``pc`` is the consts table from dt on (dt, the link table,
    masses, COMs, inertias, viscous gains, q_ref; ``dynamics/arm.py``,
    ``panda_device_consts``). ``sqrt`` is numpy's, correctly rounded as the
    kernel's __fsqrt_rn, unless given: torch's vectorised float32 sqrt on the
    CPU misses the nearest float in about 1 value of 140. Given torch's sin,
    cos and sqrt it is the torch ``panda_rbd_unrolled`` step's bits."""
    pc = np.asarray(pc, np.float32)
    dt, lk, visc, qref = pc[0], pc[1:36], pc[127:134], pc[134:141]
    q = [_f(x[i] + qref[i]) for i in range(7)]
    qd = [_f(x[7 + i]) for i in range(7)]
    R, P = [], []
    for i in range(7):
        a, ca, sa, dsa, dca = lk[5 * i:5 * i + 5]
        cq, sq = _f(cos(q[i])), _f(sin(q[i]))
        R += [cq, -sq, _f(0), _f(sq * ca), _f(cq * ca), _f(0 - sa), _f(sq * sa), _f(cq * sa),
              _f(0 + ca)]
        P += [_f(0 + a), _f(0 + dsa), _f(0 + dca)]
    zero = [_f(0)] * 7
    bias = _panda_rne_f32(R, P, pc, qd, zero, 9.81)
    M = np.zeros((7, 7), np.float32)
    for j in range(7):
        unit = [_f(1.0 if k == j else 0.0) for k in range(7)]
        M[:, j] = _panda_rne_f32(R, P, pc, zero, unit, 0.0)
    S = np.array([[_f(_f(0.5) * _f(M[i, j] + M[j, i])) for j in range(7)] for i in range(7)])
    rhs = [_f(_f(u[i] - bias[i]) - _f(visc[i] * qd[i])) for i in range(7)]
    L = np.zeros((7, 7), np.float32)
    for i in range(7):
        for j in range(i + 1):
            acc = S[i, j]
            for k in range(j):
                acc = _f(acc - _f(L[i, k] * L[j, k]))
            L[i, j] = _f(sqrt(acc)) if i == j else _f(acc / L[j, j])
    y, qdd = [None] * 7, [None] * 7
    for i in range(7):
        acc = _f(rhs[i])
        for k in range(i):
            acc = _f(acc - _f(L[i, k] * y[k]))
        y[i] = _f(acc / L[i, i])
    for i in reversed(range(7)):
        acc = y[i]
        for k in range(i + 1, 7):
            acc = _f(acc - _f(L[k, i] * qdd[k]))
        qdd[i] = _f(acc / L[i, i])
    v = [_f(qd[i] + _f(qdd[i] * dt)) for i in range(7)]
    return np.array([_f(x[i] + _f(v[i] * dt)) for i in range(7)] + v, np.float32)


def panda_context_f32(x, cc, sin=np.sin, cos=np.cos):
    """``csrc/plants.cuh``'s PandaContext::map of every entry in float32
    numpy: ``cc`` is its constants (q_ref, the FK's link table, the
    flange's d), the forward-mode FK chain in the kernel's order."""
    cc = np.asarray(cc, np.float32)
    qref, lk, fd = cc[:7], cc[7:42], cc[42]
    R = [_f(1), _f(0), _f(0), _f(0), _f(1), _f(0), _f(0), _f(0), _f(1)]
    P, dR, dP = [_f(0)] * 3, [_f(0)] * 9, [_f(0)] * 3
    for l in range(7):
        a, ca, sa, p1, p2 = lk[5 * l:5 * l + 5]
        q, w = _f(x[l] + qref[l]), _f(x[7 + l])
        cq, sq = _f(cos(q)), _f(sin(q))
        ri = [cq, -sq, _f(0), _f(sq * ca), _f(cq * ca), -sa, _f(sq * sa), _f(cq * sa), ca]
        dri = [_f(-sq * w), _f(-cq * w), _f(0), _f(_f(cq * ca) * w), _f(_f(-sq * ca) * w), _f(0),
               _f(_f(cq * sa) * w), _f(_f(-sq * sa) * w), _f(0)]
        pi = [a, p1, p2]
        Rn, dRn, Pn, dPn = [None] * 9, [None] * 9, [None] * 3, [None] * 3
        for r in range(3):
            for c in range(3):
                s_, ds = _f(0), _f(0)
                for k in range(3):
                    s_ = _f(s_ + _f(R[3 * r + k] * ri[3 * k + c]))
                    ds = _f(ds + _f(_f(dR[3 * r + k] * ri[3 * k + c]) + _f(R[3 * r + k] * dri[3 * k + c])))
                Rn[3 * r + c], dRn[3 * r + c] = s_, ds
            s_, ds = P[r], dP[r]
            for k in range(3):
                s_ = _f(s_ + _f(R[3 * r + k] * pi[k]))
                ds = _f(ds + _f(dR[3 * r + k] * pi[k]))
            Pn[r], dPn[r] = s_, ds
        R, dR, P, dP = Rn, dRn, Pn, dPn
    pos = [_f(P[r] + _f(R[3 * r + 2] * fd)) for r in range(3)]
    vel = [_f(dP[r] + _f(dR[3 * r + 2] * fd)) for r in range(3)]
    q = [_f(x[i] + qref[i]) for i in range(7)]
    return np.array(q + list(np.asarray(x[7:14], np.float32)) + pos + vel, np.float32)


def panda_plant_step(x, u, pc):
    """``PandaRbd::step`` for ``_emulate_episode`` (its consts from dt on)."""
    return panda_rbd_step_f32(x, u, pc)


def panda_context_condition(n_plant_consts=140):
    """``plants.cuh``'s PandaContext map for ``_emulate_episode``: its
    constants follow the plant's in ``pc``."""
    o = 1 + n_plant_consts
    return lambda x, pc: panda_context_f32(x, pc[o:o + 43])


def _seq(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = np.float32(acc + t)
    return acc


def _quad_stage_f32(q, r, x, u):
    """plants.cuh's quad_stage: sum_i q_i (x_i x_i), then sum_j r_j (u_j u_j), left to right."""
    return np.float32(_seq([q[i] * (x[i] * x[i]) for i in range(len(x))])
                      + _seq([r[j] * (u[j] * u[j]) for j in range(len(u))]))


def _safety_hinge_f32(sc, x, du=4, n_obs=3):
    w, c, rad = sc[du + 1], np.asarray(sc[du + 2:du + 2 + 3 * n_obs]).reshape(n_obs, 3), \
        sc[du + 2 + 3 * n_obs:du + 2 + 4 * n_obs]
    acc = np.float32(0.0)
    for j in range(n_obs):
        d0, d1, d2 = (np.float32(x[i] - c[j, i]) for i in range(3))
        d = np.sqrt(np.float32(np.float32(d0 * d0 + d1 * d1) + d2 * d2))
        pen = np.maximum(np.float32(rad[j] - d), np.float32(0.0))
        acc = np.float32(acc + np.float32(w * pen) * pen)
    return acc


def safety_first_stage_f32(q, r, sc, x, u):
    """``csrc/plants.cuh``'s SafetyFirstScorer::stage in float32 numpy:
    ``sc`` holds u_hover, factor, weight, the centers and the radii."""
    du = (u - np.asarray(sc[:4], np.float32)).astype(np.float32)
    s = _seq([du[j] * du[j] for j in range(4)])
    a = _quad_stage_f32(q, r, x, (du * np.float32(0.0)).astype(np.float32))
    return np.float32(np.float32(a + np.float32(sc[4]) * s) + _safety_hinge_f32(sc, x))


def safety_first_terminal_f32(p, sc, x):
    """``SafetyFirstScorer::terminal`` in float32 numpy."""
    return np.float32(_seq([p[i] * (x[i] * x[i]) for i in range(len(x))])
                      + _safety_hinge_f32(sc, x))


def _swingup_step(x, u, pc):
    return cartpole_step_f32(x, u, pc[0])


def _quadratic_select(x, u, sq, sr, pc):
    return np.sum(sq * x * x) + np.sum(sr * u * u)


def _quadratic_terminal(x, sp, pc):
    return np.sum(sp * x * x)


def quadrotor_select(n_plant_consts=4, n_condition_consts=0):
    """(stage, terminal) of the quadrotor's safety-first scorer for
    ``_emulate_episode``: its constants follow the plant's and the condition
    map's in ``pc``."""
    o = 1 + n_plant_consts + n_condition_consts
    return (lambda x, u, sq, sr, pc: safety_first_stage_f32(sq, sr, pc[o:], x, u),
            lambda x, sp, pc: safety_first_terminal_f32(sp, pc[o:], x))


def concat_features_condition(n_features, n_plant_consts=4):
    """``plants.cuh``'s ConcatFeatures map for ``_emulate_episode``: the
    state followed by the ``n_features`` constants after the plant's."""
    o = 1 + n_plant_consts
    return lambda x, pc: np.concatenate([x, np.asarray(pc[o:o + n_features], np.float32)])


def _emulate_episode(packed, t_embs, consts, x0, n_candidates, selection_horizon, n_steps,
                     n_groups, first_plans, chain_step, plant_step=_swingup_step,
                     select=(_quadratic_select, _quadratic_terminal), condition=None, plan=None):
    """The program both episode kernels share (``csrc/episode.cuh`` and the
    kernels' replan loops), in numpy: the affine normalize, the per-step
    FiLM of ``n_groups`` groups from the FiLM weights the meta table points
    at (M_FW, M_FB, M_COND, M_TEMB, M_CTX), written into the shared image at
    M_EP_FILM and M_EP_MC, the chains of the K candidates
    (``chain_step(W, m, smem, films, x, step, si, k)``, from
    ``first_plans(step)``), the unnormalize, the candidate rollouts scored
    from ``consts`` and the one-hot choice, the stage cost and the plant
    step, ``plant_step(x, u, consts from dt on)`` (the swing-up's by default;
    the state width is x0's), and the scorer ``select`` = (stage(x, u, sq,
    sr, pc), terminal(x, sp, pc)), the selection QuadraticCost by default,
    and the state-to-condition map ``condition(x, pc)`` (the identity by
    default), whose context is the model's context_dim wide. The shared image is sized by the
    episode plan ``plan`` (by default that of ``n_groups`` row-sets: the CFG episode's 2, the
    DDIM episode's 1; the CFG episode's ``unet_pack.TURNS``) and filled with NaN, so a region
    that overlaps another or is read before it is written shows."""
    W = packed.weights.cpu().numpy()
    plan = n_groups if plan is None else plan
    m = packed.metas[plan].cpu().numpy()
    K, sel_h = n_candidates, selection_horizon
    H, D, n_res, maxc = (int(m[k]) for k in (up.M_H, up.M_D, up.M_NRES, up.M_MAXC))
    cond, temb, dctx = (int(m[k]) for k in (up.M_COND, up.M_TEMB, up.M_CTX))
    n_total = t_embs.shape[0]
    dx, du, dc = x0.shape[0], D, dctx
    parts = np.split(np.asarray(consts, np.float32),
                     np.cumsum([dc, dc, du, du, dx, du, dx, du, dx]))
    cn_shift, cn_scale, un_shift, un_scale, q, r, sq, sr, sp, pc = parts
    Fw = W[m[up.M_FW]:m[up.M_FW] + n_res * cond * maxc].reshape(n_res, cond, maxc)
    Fb = W[m[up.M_FB]:m[up.M_FB] + n_res * maxc].reshape(n_res, maxc)
    smem = _image(packed.episode_smem_bytes(K, plan) // 4)
    films = smem[m[up.M_EP_FILM]:m[up.M_EP_FILM] + n_res * n_groups * maxc].reshape(n_res, n_groups, maxc)
    mc = smem[m[up.M_EP_MC]:m[up.M_EP_MC] + n_groups * cond].reshape(n_groups, cond)
    cand_off = int(m[up.M_EP_SMEM]) + up.align4(up.M_LEN)
    cand = smem[cand_off:cand_off + K * H * D].reshape(K, H, D)
    x = x0.astype(np.float32)
    xs, us, stages, chosen = [x], [], [], []
    for step in range(n_steps):
        ctx = ((x if condition is None else condition(x, pc)) - cn_shift) * cn_scale
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
                    score[k] += select[0](xc, plans[k, t], sq, sr, pc)
                    xc = plant_step(xc, plans[k, t], pc)
                if sel_h == H:
                    score[k] += select[1](xc, sp, pc)
            mn = np.min(score)
            hits = np.nonzero(score == mn)[0]
            best = int(hits[0]) if hits.size else K
            u0 = (np.arange(K) == best).astype(np.float32) @ plans[:, 0]
        stages.append(np.sum(q * x * x) + np.sum(r * u0 * u0))
        x = plant_step(x, u0, pc)
        xs.append(x)
        us.append(u0)
        chosen.append(best)
    return np.stack(xs), np.stack(us), np.array(stages, np.float32), np.array(chosen)


class _Cluster:
    """The shared memory of the CTAs of one thread-block cluster, one
    NaN-filled image each, and the check that keeps their pushes race-free:
    between two cluster barriers no address of a CTA may be written by two
    CTAs, nor written by another CTA and read by its own. ``read`` and
    ``write`` record the flat indices an operation touches; ``barrier``
    checks and starts the next interval."""

    def __init__(self, n_floats: int, n_ranks: int, dtype=np.float32):
        self.n = n_ranks
        self.smem = [_image(n_floats, dtype) for _ in range(n_ranks)]
        self.barriers = 0
        self._clear()

    def _clear(self):
        n = self.smem[0].size
        self.rd = np.zeros((self.n, n), bool)
        self.wr = np.zeros((self.n, self.n, n), bool)  # [CTA, writer]

    def read(self, j, idx):
        self.rd[j, idx] = True
        return self.smem[j][idx]

    def write(self, r, j, idx, values):
        self.smem[j][idx] = values
        self.wr[j, r, idx] = True

    def barrier(self):
        for j in range(self.n):
            others = np.delete(self.wr[j], j, axis=0).any(axis=0)
            assert not (others & self.rd[j]).any(), \
                f"CTA {j} read what another CTA wrote between two cluster barriers"
            assert (self.wr[j].sum(axis=0) <= 1).all(), \
                f"two CTAs wrote one address of CTA {j} between two cluster barriers"
        self.barriers += 1
        self._clear()


def _emulate_cluster_body(W, m, cl, nb, film, x_rows, eps=1e-5, next_pass=True, Wc=None):
    """``cunet_body<nb>`` of ``csrc/unet_body_cluster.cuh`` in numpy on the
    images of ``cl``: every CTA holds every activation in unet_body.cuh's
    layout and buffers; rank r computes the channels [r c / n, (r + 1) c / n)
    of every conv, the GroupNorm of its group, and stores its final slices
    into every CTA. ``film(r, rr, sl)`` is what rank r reads as the FiLM
    rows (nb, len(sl)) of block rr's channels sl: from its own image in the
    episodes (``film_from_image``), from device memory in the chain. ``W`` is the kernel's buffer, the body's
    conv kernels rank-major (``unet_pack.cluster_weights``): a conv's
    (ks * cin, cout) kernel holds (n, ks * cin, cout / n) at its offset.
    Every read and write goes through ``cl``,
    which checks the pushes against the kernel's cluster barriers. With
    ``next_pass`` (the chains and episodes) every CTA then reads y for the
    final 1x1 conv, followed by the kernels' barrier when y lies in a buffer
    the next pass pushes into; without (the U-Net pass) rank 0 reads it to
    write the output. Returns y (nb, H, dims[1]), which every CTA must hold
    alike. ``Wc`` is the bf16 instantiation's buffer of conv kernels (the
    kernel's bf16 copy of ``W``, as float32): when given, every conv kernel
    is read from it and every product's activation operand is rounded to
    bf16 (``bf16_rne``); biases and GroupNorm stay ``W``'s."""
    halo, n = up.HALO, cl.n
    rnd = _operand(Wc is not None)
    Wc = W if Wc is None else Wc
    H, D, nlev, buf = (int(m[k]) for k in (up.M_H, up.M_D, up.M_NLEV, up.M_BUF))
    ranks = range(n)

    def ix(off, h, c, t, ch):
        assert nb * (h + 2 * halo) * c <= buf or off >= 3 * buf, "activation larger than its buffer"
        b = np.arange(nb)[:, None, None]
        return off + (b * (h + 2 * halo) + halo + np.asarray(t)[None, :, None]) * c + np.asarray(ch)[None, None, :]

    def own(c, r):
        nc = c // n
        return np.arange(r * nc, (r + 1) * nc)

    def weights(off, shape, buf=W):
        return buf[off:off + int(np.prod(shape))].reshape(shape)

    def whole(off, h, c, r):
        return cl.read(r, ix(off, h, c, np.arange(-halo, h + halo), np.arange(c)))

    def conv(r, src, hin, cin, dst, hout, cout, w_off, b_off, ks, stride, pad, push):
        x, sl = rnd(whole(src, hin, cin, r)), own(cout, r)
        wk = weights(w_off + sl[0] * ks * cin, (ks, cin, len(sl)), Wc)  # the rank's block, rank-major
        bias = weights(b_off, (cout,))[sl]
        rows = halo + stride * np.arange(hout) - pad
        y = bias + sum(x[:, rows + k] @ wk[k] for k in range(ks))
        for j in (ranks if push else [r]):
            cl.write(r, j, ix(dst, hout, cout, np.arange(hout), sl), y)

    def zero_halo(r, off, h, c):
        cl.write(r, r, ix(off, h, c, np.r_[-halo:0, h:h + halo], np.arange(c)), 0.0)

    def gn_push(r, off, h, c, g_off, be_off, film_r=None, res=None):
        sl = own(c, r)
        v = cl.read(r, ix(off, h, c, np.arange(h), sl))
        mean = v.mean(axis=(1, 2), keepdims=True)
        var = np.maximum((v * v).mean(axis=(1, 2), keepdims=True) - mean * mean, 0.0)
        y = _mish((v - mean) / np.sqrt(var + eps) * weights(g_off, (c,))[sl] + weights(be_off, (c,))[sl])
        if film_r is not None:
            y = y + film(r, film_r, sl)[:, None, :]
        if res is not None:
            y = y + cl.read(r, ix(res, h, c, np.arange(h), sl))
        for j in ranks:
            cl.write(r, j, ix(off, h, c, np.arange(h), sl), y)

    def res_block(rr, src, t1, t2, h):
        rm = m[up.M_RES + rr * up.RES_STRIDE:]
        cin, cout = int(rm[up.R_CIN]), int(rm[up.R_COUT])
        assert int(rm[up.R_GROUPS]) == n
        for r in ranks:
            conv(r, src, h, cin, t1, h, cout, rm[up.R_W1], rm[up.R_B1], 5, 1, 2, False)
            zero_halo(r, t1, h, cout)
        for r in ranks:
            gn_push(r, t1, h, cout, rm[up.R_G1], rm[up.R_BE1], film_r=rr)
        cl.barrier()
        res = t1 if rm[up.R_WR] >= 0 else src
        for r in ranks:
            conv(r, t1, h, cout, t2, h, cout, rm[up.R_W2], rm[up.R_B2], 5, 1, 2, False)
            zero_halo(r, t2, h, cout)
        for r in ranks:  # after the block barrier that follows conv2
            if rm[up.R_WR] >= 0:
                conv(r, src, h, cin, t1, h, cout, rm[up.R_WR], rm[up.R_BR], 1, 1, 0, False)
        for r in ranks:
            gn_push(r, t2, h, cout, rm[up.R_G2], rm[up.R_BE2], res=res)
        cl.barrier()

    cur, f1, f2 = 0, buf, 2 * buf
    for r in ranks:
        cl.write(r, r, ix(cur, H, D, np.arange(H), np.arange(D)), x_rows)
        zero_halo(r, cur, H, D)
    h, rr = H, 0
    for lvl in range(nlev):
        for _ in range(2):
            res_block(rr, cur, f1, f2, h)
            cur, f1, f2 = f2, cur, f1
            rr += 1
        c = int(m[up.M_DIMS + lvl + 1])
        if lvl > 0:
            skip = int(m[up.M_SKIP + lvl])
            for r in ranks:
                cl.write(r, r, ix(skip, h, c, np.arange(-halo, h + halo), np.arange(c)),
                         whole(cur, h, c, r))
        if lvl < nlev - 1:
            for r in ranks:
                conv(r, cur, h, c, f1, h // 2, c, m[up.M_DOWN + 2 * lvl],
                     m[up.M_DOWN + 2 * lvl + 1], 3, 2, 1, True)
                zero_halo(r, f1, h // 2, c)
            h //= 2
            cur, f1 = f1, cur
            cl.barrier()
    for _ in range(2):
        res_block(rr, cur, f1, f2, h)
        cur, f1, f2 = f2, cur, f1
        rr += 1
    for u in range(nlev - 1):
        lvl = nlev - 1 - u
        c = int(m[up.M_DIMS + lvl + 1])
        skip = int(m[up.M_SKIP + lvl])
        for r in ranks:
            a = cl.read(r, ix(cur, h, c, np.arange(h), np.arange(c)))
            b = cl.read(r, ix(skip, h, c, np.arange(h), np.arange(c)))
            cl.write(r, r, ix(f1, h, 2 * c, np.arange(h), np.arange(2 * c)), np.concatenate([a, b], -1))
            zero_halo(r, f1, h, 2 * c)
        cur, f1, f2 = f1, f2, cur
        for _ in range(2):
            res_block(rr, cur, f1, f2, h)
            cur, f1, f2 = f2, cur, f1
            rr += 1
        cd = int(m[up.M_DIMS + lvl])
        bu = weights(m[up.M_UP + 2 * u + 1], (cd,))
        t = np.arange(h)
        for r in ranks:
            x, sl = rnd(whole(cur, h, cd, r)), own(cd, r)
            wu = weights(m[up.M_UP + 2 * u] + sl[0] * 4 * cd, (4, cd, len(sl)), Wc)
            y = np.empty((nb, 2 * h, len(sl)), np.float32)
            y[:, 0::2] = bu[sl] + x[:, halo + t - 1] @ wu[0] + x[:, halo + t] @ wu[2]
            y[:, 1::2] = bu[sl] + x[:, halo + t] @ wu[1] + x[:, halo + t + 1] @ wu[3]
            for j in ranks:
                cl.write(r, j, ix(f1, 2 * h, cd, np.arange(2 * h), sl), y)
            zero_halo(r, f1, 2 * h, cd)
        h *= 2
        cur, f1 = f1, cur
        cl.barrier()
    cf = int(m[up.M_DIMS + 1])
    for r in ranks:
        conv(r, cur, h, cf, f1, h, cf, m[up.M_FIN], m[up.M_FIN + 1], 5, 1, 2, False)
    assert int(m[up.M_FIN + 4]) == n
    for r in ranks:
        gn_push(r, f1, h, cf, m[up.M_FIN + 2], m[up.M_FIN + 3])
    cl.barrier()
    at = ix(f1, H, cf, np.arange(H), np.arange(cf))
    y = [cl.read(r, at) for r in (ranks if next_pass else [0])][0]  # the 1x1 conv; the output
    if next_pass and f1 != 0:  # the kernel's barrier when y is not the next pass's input buffer
        cl.barrier()
    for r in ranks:
        np.testing.assert_array_equal(cl.smem[r][at], y)
    return y


def film_from_image(cl, m, nb, n_rows, row0=0):
    """The episodes' FiLM reader for ``_emulate_cluster_body``: rank r reads
    block rr's channels sl of rows row0..row0+nb-1 from its own image at
    M_EP_FILM, laid out (n_res, n_rows, max_c)."""
    off, maxc = int(m[up.M_EP_FILM]), int(m[up.M_MAXC])
    return lambda r, rr, sl: cl.read(
        r, off + (rr * n_rows + row0 + np.arange(nb)[:, None]) * maxc + sl[None, :])


def _write_films_rank(cl, m, films):
    """``episode_films_rank``: each CTA's own channels of every block of the
    step's FiLM (n_res, G, max_c), written into its image at M_EP_FILM."""
    n_res, maxc, off = int(m[up.M_NRES]), int(m[up.M_MAXC]), int(m[up.M_EP_FILM])
    for r in range(cl.n):
        for rr in range(n_res):
            nc = int(m[up.M_RES + rr * up.RES_STRIDE + up.R_COUT]) // cl.n
            sl = np.arange(r * nc, (r + 1) * nc)
            for g in range(films.shape[1]):
                cl.smem[r][off + (rr * films.shape[1] + g) * maxc + sl] = films[rr, g, sl]


def _final_1x1(W, m, y, Wc=None):
    """The final 1x1 conv on y (nb, H, dims[1]) -> eps (nb, H, D); with the
    bf16 buffer ``Wc`` its kernel from there and y rounded to bf16."""
    D, cf = int(m[up.M_D]), int(m[up.M_DIMS + 1])
    rnd, Wc = _operand(Wc is not None), W if Wc is None else Wc
    return (rnd(y) @ Wc[m[up.M_F1]:m[up.M_F1] + cf * D].reshape(cf, D)
            + W[m[up.M_F1 + 1]:m[up.M_F1 + 1] + D])


def _ddim_update(x, eps, coefs_si, clip=True):
    """The recon, clip (the launch's ``clip`` flag) and affine lines of the DDIM kernels."""
    sra, srm, c1, c2 = (np.float32(v) for v in coefs_si)
    rec = sra * x - srm * eps
    if clip:
        rec = np.clip(rec, -1.0, 1.0)
    return c1 * rec + c2 * x


def _bf16_buffer(weights_bf16):
    """The bf16 copy of the buffer a bf16 entry reads, as float32 numpy (None for fp32)."""
    return None if weights_bf16 is None else weights_bf16.float().cpu().numpy()


def emulate_fused_unet_kernel(packed, weights, films, x, n_ranks=up.CLUSTER, weights_bf16=None):
    """Runs ``csrc/fused_unet.cu``'s program in numpy: per batch row one
    cluster of ``n_ranks`` CTAs (``_Cluster``, NaN-filled images of the
    pass's one-row-set plan), a cluster barrier once every CTA has started, the cluster
    body on the row (``_emulate_cluster_body``, one row-set, FiLM row b of
    films (n_res, B, max_c) in device memory), rank 0 reading y out, and a
    cluster barrier before exit. ``weights`` is the buffer the kernel reads
    (``FusedUnet.cluster.weights``), ``weights_bf16`` its bf16 copy, which
    the bf16 entry reads beside it (``cluster.weights_bf16``). Returns y (B,
    H, dims[1]) and each row's cluster-barrier count."""
    cluster_w = weights.cpu().numpy()
    wc = _bf16_buffer(weights_bf16)
    m = packed.metas[1].cpu().numpy()
    ys, barriers = [], []
    for b in range(x.shape[0]):
        cl = _Cluster(packed.chain_smem_bytes(1) // 4, n_ranks)
        cl.barrier()
        ys.append(_emulate_cluster_body(cluster_w, m, cl, 1, lambda r, rr, sl: films[rr][[b]][:, sl],
                                        x[b:b + 1], next_pass=False, Wc=wc)[0])
        cl.barrier()
        barriers.append(cl.barriers)
    return np.stack(ys), barriers


def emulate_ddim_chain_kernel(packed, weights, films, x_init, coefs, n_ranks=up.CLUSTER,
                              weights_bf16=None, clip=True):
    """Runs ``csrc/ddim_chain.cu``'s program in numpy: per sample one
    cluster of ``n_ranks`` CTAs (``_Cluster``, NaN-filled images of the
    chain's one-row-set plan), a cluster barrier once every CTA has started, then per
    step the cluster body on the sample's one row-set
    (``_emulate_cluster_body``, FiLM row ``sample`` of the step's (n_res, B,
    max_c) table in device memory), the final 1x1 conv and the DDIM lines,
    with the kernel's barrier when the pass ended in a buffer the next one
    pushes into; a cluster barrier before exit. ``weights`` is the buffer
    the kernel reads (``FusedDdimChain.cluster.weights``), ``weights_bf16``
    its bf16 copy, which the bf16 entry reads beside it; ``clip`` the
    launch's clip flag. Returns the output (B, H, D) and each sample's
    cluster-barrier count."""
    W = packed.weights.cpu().numpy()
    cluster_w = weights.cpu().numpy()
    wc = _bf16_buffer(weights_bf16)
    m = packed.metas[1].cpu().numpy()
    out = np.empty_like(x_init)
    barriers = []
    for sample in range(x_init.shape[0]):
        cl = _Cluster(packed.chain_smem_bytes(1) // 4, n_ranks)
        xs = x_init[sample].copy()
        cl.barrier()
        for si in range(coefs.shape[0]):
            rows = films[si][:, [sample]]  # (n_res, 1, max_c)
            y = _emulate_cluster_body(cluster_w, m, cl, 1, lambda r, rr, sl: rows[rr][:, sl],
                                      xs[None], Wc=wc)
            xs = _ddim_update(xs, _final_1x1(W, m, y, wc)[0], coefs[si], clip)
        cl.barrier()
        out[sample] = xs
        barriers.append(cl.barriers)
    return out, barriers


def _cfg_update(x, eps, coefs_si, noise_si, w, clip=True):
    """The recon, CFG, clip (the launch's ``clip`` flag) and posterior lines of the CFG kernels."""
    sra, srm, c1, c2, sg = (np.float32(v) for v in coefs_si)
    rec = np.float32(1.0 + w) * (sra * x - srm * eps[0]) - np.float32(w) * (sra * x - srm * eps[1])
    if clip:
        rec = np.clip(rec, -1.0, 1.0)
    return (c1 * rec + c2 * x) + sg * noise_si


def emulate_cfg_chain_kernel(packed, weights, films, noise_tab, coefs, w, n_ranks=up.CLUSTER,
                             weights_bf16=None, dtype=np.float32, clip=True):
    """Runs ``csrc/cfg_chain.cu``'s program in numpy: per sample one cluster
    of ``n_ranks`` CTAs (``_Cluster``, NaN-filled images of the chain's
    two-row-set plan), a cluster barrier once every CTA has started, then per step the
    cluster body on the two row-sets (``_emulate_cluster_body``, FiLM rows
    ``sample`` and ``B + sample`` of the step's (n_res, 2B, max_c) table in
    device memory), the final 1x1 conv and the CFG lines, with the kernel's
    barrier when the pass ended in a buffer the next one pushes into; a
    cluster barrier before exit. ``weights`` is the buffer the kernel reads
    (``FusedCfgChain.cluster.weights``), ``weights_bf16`` its bf16 copy,
    which the bf16 instantiation reads beside it (``cluster.weights_bf16``).
    ``dtype`` is the images' and the arithmetic's type: float64 runs the
    program with fp32 sums taken exactly enough that no bf16 rounding of an
    operand depends on their order. ``clip`` is the launch's clip flag.
    Returns the output (B, H, D) and each sample's cluster-barrier count."""
    W = packed.weights.cpu().numpy()
    cluster_w = weights.cpu().numpy()
    wc = _bf16_buffer(weights_bf16)
    m = packed.metas[2].cpu().numpy()
    n_total, b_all = noise_tab.shape[0] - 1, noise_tab.shape[1]
    out = np.empty((b_all,) + noise_tab.shape[2:], dtype)
    barriers = []
    for sample in range(b_all):
        cl = _Cluster(packed.chain_smem_bytes(2) // 4, n_ranks, dtype)
        xs = noise_tab[n_total, sample].astype(dtype)
        cl.barrier()
        for si in range(n_total):
            rows = films[si][:, [sample, b_all + sample]]  # (n_res, 2, max_c)
            y = _emulate_cluster_body(cluster_w, m, cl, 2, lambda r, rr, sl: rows[rr][:, sl],
                                      np.stack([xs, xs]), Wc=wc)
            xs = _cfg_update(xs, _final_1x1(W, m, y, wc), coefs[si], noise_tab[si, sample], w,
                             clip)
        cl.barrier()
        out[sample] = xs
        barriers.append(cl.barriers)
    return out, barriers


def emulate_cfg_episode_kernel(packed, weights, t_embs, noise, coefs, consts, x0, w, n_candidates,
                               selection_horizon, n_steps, n_ranks=up.CLUSTER, weights_bf16=None,
                               plant_step=_swingup_step,
                               select=(_quadratic_select, _quadratic_terminal), condition=None,
                               clip=True):
    """Runs ``csrc/cfg_episode.cu``'s program in numpy: ``_emulate_episode``
    with the two FiLM groups, and for every chain step the cluster body
    (``_emulate_cluster_body``) on the images of one cluster of ``n_ranks``
    CTAs, which live through the whole episode, each with only its own
    channels of the step's FiLM written (``episode_films_rank``), then the
    final 1x1 conv and the CFG lines (``_cfg_update``). ``noise`` has
    the wrapper's layout (n_steps, n_total + 1, K, H, D) with row n_total =
    x_T; ``weights`` is the buffer the kernel reads (``FusedCfgEpisode.weights``),
    ``weights_bf16`` its bf16 copy, which the bf16 instantiation reads beside
    it (``cluster.weights_bf16``); ``plant_step``, ``select`` and
    ``condition`` the plant's device function, the scorer and the
    state-to-condition map (``_emulate_episode``); ``clip`` the launch's clip
    flag. Returns the tracks, the choices and the number of cluster
    barriers."""
    n_total = noise.shape[1] - 1
    m = packed.metas[2].cpu().numpy()
    cluster_w = weights.cpu().numpy()
    wc = _bf16_buffer(weights_bf16)
    cl = _Cluster(packed.episode_smem_bytes(n_candidates, 2) // 4, n_ranks)
    film = film_from_image(cl, m, 2, 2)

    def step(W, m, smem, films, x, si_step, si, k):
        _write_films_rank(cl, m, films)
        y = _emulate_cluster_body(cluster_w, m, cl, 2, film, np.stack([x, x]), Wc=wc)
        return _cfg_update(x, _final_1x1(W, m, y, wc), coefs[si], noise[si_step, si, k], w, clip)

    out = _emulate_episode(packed, t_embs, consts, x0, n_candidates, selection_horizon, n_steps,
                           2, lambda s: noise[s, n_total], step, plant_step, select, condition)
    return out + (cl.barriers,)


def _eps_in_turns(W, cluster_w, m, cl, film_of, x):
    """The two passes of a CFG step on the plan in turns (``unet_pack.TURNS``):
    for g = 0 (conditional) and 1 (unconditional) the cluster body on one
    row-set of x (``_emulate_cluster_body``, FiLM ``film_of(g)``) and the
    final 1x1 conv, whose output every CTA writes into half g of eps at
    M_EPS of its own image; then every CTA reads both halves back for the
    CFG lines, so a region that the second pass overwrites shows. Returns
    eps (2, H, D), alike in every CTA."""
    hd = x.size
    at = int(m[up.M_EPS]) + np.arange(2 * hd)
    for g in range(2):
        y = _emulate_cluster_body(cluster_w, m, cl, 1, film_of(g), x[None])
        eps_g = _final_1x1(W, m, y)[0].ravel()
        for r in range(cl.n):
            cl.write(r, r, at[g * hd:(g + 1) * hd], eps_g)
    eps = [cl.read(r, at) for r in range(cl.n)]
    for other in eps[1:]:
        np.testing.assert_array_equal(other, eps[0])
    return eps[0].reshape(2, *x.shape)


def emulate_cfg_chain_turns_kernel(packed, weights, films, noise_tab, coefs, w,
                                   n_ranks=up.CLUSTER, clip=True):
    """Runs ``csrc/cfg_chain.cu``'s program in turns (``cfg_chain_turns``) in
    numpy: per sample one cluster of ``n_ranks`` CTAs (``_Cluster``,
    NaN-filled images of the plan in turns), a cluster barrier once every
    CTA has started, then per step the conditional and the unconditional
    pass one after the other (``_eps_in_turns``: FiLM rows ``sample`` and
    ``B + sample`` of the step's (n_res, 2B, max_c) table in device memory),
    each with the kernel's barrier when it ended in a buffer the next pass
    pushes into, then the CFG lines (``clip`` the launch's clip flag); a
    cluster barrier before exit. Returns the output (B, H, D) and each
    sample's cluster-barrier count."""
    W = packed.weights.cpu().numpy()
    cluster_w = weights.cpu().numpy()
    m = packed.metas[up.TURNS].cpu().numpy()
    n_total, b_all = noise_tab.shape[0] - 1, noise_tab.shape[1]
    out = np.empty((b_all,) + noise_tab.shape[2:], np.float32)
    barriers = []
    for sample in range(b_all):
        cl = _Cluster(packed.chain_smem_bytes(up.TURNS) // 4, n_ranks)
        xs = noise_tab[n_total, sample].astype(np.float32)
        cl.barrier()
        for si in range(n_total):
            rows = films[si][:, [sample, b_all + sample]]  # (n_res, 2, max_c)
            eps = _eps_in_turns(W, cluster_w, m, cl,
                                lambda g: (lambda r, rr, sl: rows[rr][[g]][:, sl]), xs)
            xs = _cfg_update(xs, eps, coefs[si], noise_tab[si, sample], w, clip)
        cl.barrier()
        out[sample] = xs
        barriers.append(cl.barriers)
    return out, barriers


def emulate_cfg_episode_turns_kernel(packed, weights, t_embs, noise, coefs, consts, x0, w,
                                     n_candidates, selection_horizon, n_steps, n_ranks=up.CLUSTER,
                                     plant_step=_swingup_step,
                                     select=(_quadratic_select, _quadratic_terminal),
                                     condition=None, clip=True):
    """Runs ``csrc/cfg_episode.cu``'s program in turns (``cfg_episode_panda``)
    in numpy: ``_emulate_episode`` on the plan in turns with the two FiLM
    groups, on one cluster of ``n_ranks`` CTAs that lives through the whole
    episode (a cluster barrier once every CTA has started, another before
    exit); every chain step writes each rank's own channels of the step's
    FiLM (``episode_films_rank<2>``), runs each candidate's two passes in
    turn (``_eps_in_turns``, FiLM rows 0 and 1 of the (n_res, 2, max_c)
    table in each CTA's image), then the CFG lines. ``noise`` has the
    wrapper's kernel layout (n_steps, n_total + 1, K, H, D) with row n_total
    = x_T; ``plant_step``, ``select`` and ``condition`` are
    ``_emulate_episode``'s, ``clip`` the launch's clip flag. Returns the
    tracks, the choices and the number of cluster barriers."""
    n_total = noise.shape[1] - 1
    m = packed.metas[up.TURNS].cpu().numpy()
    cluster_w = weights.cpu().numpy()
    cl = _Cluster(packed.episode_smem_bytes(n_candidates, up.TURNS) // 4, n_ranks)

    def step(W, m_, smem, films, x, si_step, si, k):
        _write_films_rank(cl, m, films)
        eps = _eps_in_turns(W, cluster_w, m, cl, lambda g: film_from_image(cl, m, 1, 2, g), x)
        return _cfg_update(x, eps, coefs[si], noise[si_step, si, k], w, clip)

    cl.barrier()
    out = _emulate_episode(packed, t_embs, consts, x0, n_candidates, selection_horizon, n_steps,
                           2, lambda s: noise[s, n_total], step, plant_step, select, condition,
                           plan=up.TURNS)
    cl.barrier()
    return out + (cl.barriers,)


def emulate_ddim_episode_kernel(packed, weights, t_embs, noise, coefs, consts, x0, n_candidates,
                                selection_horizon, n_steps, n_ranks=up.CLUSTER,
                                plant_step=_swingup_step, select=(_quadratic_select,
                                                                  _quadratic_terminal),
                                draw=None, condition=None, weights_bf16=None, clip=True):
    """Runs ``csrc/ddim_episode.cu``'s program in numpy: ``_emulate_episode``
    with the one FiLM group, on one cluster of ``n_ranks`` CTAs that lives
    through the whole episode (a cluster barrier once every CTA has started,
    another before exit); every chain step writes each rank's own channels of
    the FiLM (``episode_films_rank<1>``), runs the cluster body on one row-set
    (``_emulate_cluster_body``), the final 1x1 conv and the DDIM update, with
    the kernel's barrier when the pass ended in a buffer the next one pushes
    into. ``noise`` is (n_steps, K, H, D), each replan's initial draw;
    ``weights`` the buffer the kernel reads (``FusedDdimEpisode.weights``);
    ``plant_step``, ``select`` and ``condition`` the plant's device function, the
    scorer and the state-to-condition map (``_emulate_episode``). With ``draw(rank, step)`` -> (K, H, D) in
    place of ``noise`` (None), every rank draws each replan's noise itself,
    as the in-kernel draw does, and the draws of the ranks must be equal.
    ``weights_bf16`` is the bf16 copy of ``weights`` the bf16 entries read
    beside it, ``clip`` the launch's clip flag. Returns the tracks, the
    choices and the number of cluster barriers."""
    m = packed.metas[1].cpu().numpy()
    cluster_w = weights.cpu().numpy()
    wc = _bf16_buffer(weights_bf16)
    cl = _Cluster(packed.episode_smem_bytes(n_candidates, 1) // 4, n_ranks)
    film = film_from_image(cl, m, 1, 1)

    def step(W, m, smem, films, x, si_step, si, k):
        _write_films_rank(cl, m, films)
        y = _emulate_cluster_body(cluster_w, m, cl, 1, film, x[None], Wc=wc)
        return _ddim_update(x, _final_1x1(W, m, y, wc)[0], coefs[si], clip)

    def first_plans(s):
        if draw is None:
            return noise[s]
        plans = [draw(rank, s) for rank in range(n_ranks)]
        for other in plans[1:]:
            np.testing.assert_array_equal(other, plans[0])
        return plans[0]

    cl.barrier()
    out = _emulate_episode(packed, t_embs, consts, x0, n_candidates, selection_horizon, n_steps,
                           1, first_plans, step, plant_step, select, condition)
    cl.barrier()
    return out + (cl.barriers,)


def tf32_rna(v):
    """float32 -> tf32 as ``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest,
    ties away from zero (add half of the dropped 13 bits to the magnitude,
    then clear them), kept as float32."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_3xtf32(v):
    """(hi, lo): hi = tf32(v), lo = tf32(v - hi), the kernel's split."""
    hi = tf32_rna(v)
    return hi, tf32_rna(np.float32(v) - hi)


def mma_3xtf32(acc3, a, b):
    """One k8 step of the kernel's 3xTF32 product on m16n8k8 tiles: the tf32
    products a_lo b_hi, a_hi b_lo and a_hi b_hi, each summed in float32 into
    its own accumulator of ``acc3`` (three independent chains). Works on
    stacks of tiles (..., 16, 8) @ (..., 8, 8); ``sum_3xtf32`` adds the
    three at the end."""
    (a_hi, a_lo), (b_hi, b_lo) = split_3xtf32(a), split_3xtf32(b)
    return tuple(c + np.matmul(x, y) for c, (x, y) in
                 zip(acc3, ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))))


def sum_3xtf32(acc3):
    """The product from the three accumulators: the two small ones first."""
    lh, hl, hh = acc3
    return (lh + hl) + hh


# mma.sync.m16n8k8 tf32 fragments, by lane: g = lane >> 2, t = lane & 3
_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3
A_FRAG = [(_G, _T), (_G + 8, _T), (_G, _T + 4), (_G + 8, _T + 4)]   # (row, k) of a0..a3
B_FRAG = [(_T, _G), (_T + 4, _G)]                                   # (k, col) of b0, b1
C_FRAG = [(_G, 2 * _T), (_G, 2 * _T + 1), (_G + 8, 2 * _T), (_G + 8, 2 * _T + 1)]  # c0..c3


def _from_fragments(regs, frag, shape):
    """Places each lane's registers (n, 32, len(frag)) at their (row, col) of
    an (n, *shape) tile, checking that the lanes cover every element once."""
    tile = np.full((regs.shape[0],) + shape, np.nan, np.float32)
    seen = np.zeros(shape, np.int64)
    for i, (r, c) in enumerate(frag):
        tile[:, r, c] = regs[:, :, i]
        np.add.at(seen, (r, c), 1)
    assert np.all(seen == 1), "the fragment layout does not cover the tile once"
    return tile


def emulate_fused_conv_kernel(x, w, b, gamma, beta, n_groups, pre_bias=None, eps=1e-5):
    """Runs ``csrc/fused_conv.cu``'s program in float32 numpy, every CTA of
    ``conv_plan``'s grid at once, each on its own NaN-filled shared image of
    the plan's size, with the kernel's index arithmetic:

    - the copies: the group's weight slice into rows of w_stride floats
      (its padding columns are never written: they feed only discarded
      output columns), its bias, gamma and beta, the chunk's x rows into the
      interior rows (x_stride floats each) of the halo layout; then the
      zero fill (the weight slice's K-padding rows, the valid elements'
      halo rows), the K columns' offset table (k * x_stride + ci, or -1 in
      the K padding) and the pre-bias on the interior rows;
    - the product: every active warp (tile group r, split s) builds its
      m16n8k8 A and B fragments lane by lane from the image (A row m at
      element m / H, row m % H, its column kk at the table's offset, 0
      where the table says -1; rows past the chunk's valid ones read row
      0), splits them into tf32 hi and lo (``cvt.rna``) and sums the three
      products into three accumulators over its k-steps, then adds them;
    - the split-K reduction: splits 1.. store their C fragments over the
      operands (float4 per lane and tile), split 0 adds them in order;
    - the epilogue from split 0's registers: bias, each element's mean by
      lane sums, an xor-shuffle tree, one sum per warp in shared memory and
      every thread adding the warps' sums in order, then the sum of
      (y - mean)^2 the same way into a second array, 1/sqrt(var + eps),
      gamma, beta, Mish, and the valid elements stored (each output element
      once).

    A read of an element the kernel never wrote turns the output to NaN."""
    from mpc_via_diffusion_model_tpu_torch.ops.fused_conv import WARPS, conv_plan
    halo = up.HALO
    bsz, h, cin = x.shape
    cout = w.shape[-1]
    pl_ = conv_plan(bsz, h, cin, cout, n_groups)
    cpg, cpg_pad, k_pad, chunk = pl_.cpg, pl_.cpg_pad, pl_.k_pad, pl_.chunk
    ws, xst = pl_.w_stride, pl_.x_stride
    n_grp, n_chunks = pl_.grid
    n_cta = n_grp * n_chunks
    grp = np.repeat(np.arange(n_grp), n_chunks)           # blockIdx.x
    b0 = np.tile(np.arange(n_chunks), n_grp) * chunk       # blockIdx.y * chunk
    n_valid = np.minimum(chunk, bsz - b0)
    img = np.full((n_cta, pl_.smem_bytes // 4), np.nan, np.float32)
    xs_off, img_len = k_pad * ws, (h + 2 * halo) * xst
    col_off = xs_off + chunk * img_len
    par_off = max(pl_.operand_floats, pl_.partial_floats)      # bias, gamma, beta
    red_off = (par_off + 3 * cpg, par_off + 3 * cpg + WARPS * chunk)  # the two passes' sums
    w2 = w.reshape(5 * cin, cout)
    pb = np.zeros((bsz, cin), np.float32) if pre_bias is None else pre_bias
    kk = np.arange(k_pad)
    for q in range(n_cta):
        sm = img[q]
        wsm = sm[:xs_off].reshape(k_pad, ws)
        wsm[:5 * cin, :cpg] = w2[:, grp[q] * cpg:(grp[q] + 1) * cpg]          # cp.async group 0
        xsm = sm[xs_off:col_off].reshape(chunk, h + 2 * halo, xst)
        for i, v in enumerate((b, gamma, beta)):
            sm[par_off + i * cpg:par_off + (i + 1) * cpg] = v[grp[q] * cpg:(grp[q] + 1) * cpg]
        xsm[:n_valid[q], halo:halo + h, :cin] = x[b0[q]:b0[q] + n_valid[q]]  # cp.async group 1
        wsm[5 * cin:, :cpg_pad] = 0.0
        xsm[:n_valid[q], :halo, :cin] = 0.0
        xsm[:n_valid[q], halo + h:, :cin] = 0.0
        sm[col_off:col_off + k_pad] = np.where(kk < 5 * cin, (kk // cin) * xst + kk % cin, -1)
        xsm[:n_valid[q], halo:halo + h, :cin] += pb[b0[q]:b0[q] + n_valid[q], None]  # pre-bias
    # the product, C fragments by (warp, own tile): (n_cta, 32, 4)
    n_rows = n_valid * h                                                        # (n_cta,)
    cta = np.arange(n_cta)[:, None]

    def row_base(m):  # (n_cta, 32) image offsets of A rows m (32,)
        m = np.broadcast_to(m, (n_cta, 32))
        return np.where(m < n_rows[:, None], xs_off + (m // h) * img_len + (m % h) * xst, xs_off)

    def a_value(base, col):  # A[m][col] through the offset table; 0 where it says -1
        o = img[cta, col_off + col].astype(np.int64)
        return np.where(o >= 0, img[cta, np.where(o >= 0, base + o, 0)], np.float32(0.0))

    acc = {}
    for warp in range(WARPS):
        r, s = warp % pl_.tile_groups, warp // pl_.tile_groups
        if s >= pl_.k_splits:
            continue  # idle warp
        for j, tile in enumerate(range(r, pl_.tiles, pl_.tile_groups)):
            mt, nt = divmod(tile, pl_.n_tiles)
            c3 = (np.zeros((n_cta, 16, 8), np.float32),) * 3
            bases = [row_base(mt * 16 + rr) for rr, _ in A_FRAG]
            for ks in range(s, pl_.k_steps, pl_.k_splits):
                k0 = ks * 8
                a = np.stack([a_value(bases[i], k0 + kc) for i, (_, kc) in enumerate(A_FRAG)], -1)
                bf = np.stack([img[cta, (k0 + kr) * ws + nt * 8 + nn] for kr, nn in B_FRAG], -1)
                c3 = mma_3xtf32(c3, _from_fragments(a, A_FRAG, (16, 8)),
                                _from_fragments(bf, B_FRAG, (8, 8)))
            c = sum_3xtf32(c3)
            acc[warp, j] = np.stack([c[:, rr, cc] for rr, cc in C_FRAG], -1)
    # the split-K reduction through shared memory, over the operands
    for (warp, j), c in acc.items():
        r, s = warp % pl_.tile_groups, warp // pl_.tile_groups
        if s:
            tile = r + j * pl_.tile_groups
            off = ((s - 1) * pl_.tiles + tile) * 128 + 4 * _LANE[:, None] + np.arange(4)
            img[cta[:, :, None], off[None]] = c
    final = {}
    for (warp, j), c in acc.items():
        r, s = warp % pl_.tile_groups, warp // pl_.tile_groups
        if s == 0:
            tile = r + j * pl_.tile_groups
            for s2 in range(1, pl_.k_splits):
                off = ((s2 - 1) * pl_.tiles + tile) * 128 + 4 * _LANE[:, None] + np.arange(4)
                c = c + img[cta[:, :, None], off[None]]
            final[r, tile] = c
    # the epilogue: rows, columns and validity of every register
    out = np.full((bsz, h, cout), np.nan, np.float32)
    written = np.zeros((bsz, h, cout), np.int64)

    def par(i, col):  # bias (0), gamma (1) or beta (2) of columns col: (n_cta, *col.shape)
        idx = par_off + i * cpg + np.minimum(col, cpg - 1)
        return img[np.arange(n_cta).reshape((-1,) + (1,) * col.ndim), idx[None]]

    regs = {}
    for (r, tile), c in final.items():
        mt, nt = divmod(tile, pl_.n_tiles)
        rows = np.stack([np.broadcast_to(mt * 16 + rr, 32) for rr, _ in C_FRAG], -1)  # (32, 4)
        cols = np.stack([nt * 8 + cc for _, cc in C_FRAG], -1)
        valid = (rows[None] < n_rows[:, None, None]) & (cols[None] < cpg)            # (n_cta,32,4)
        regs[r, tile] = (c + np.where(valid, par(0, cols), np.float32(0.0)), rows, cols, valid)
    e_valid = np.arange(chunk)[None] < n_valid[:, None]                        # (n_cta, chunk)

    def group_sums(pass_, value):
        """Per warp of split 0 and valid element: its lanes' sums of
        value(y, rows) over their valid registers, an xor-shuffle tree, lane
        0's sum into the pass's array; returns the per-register reader of
        the warps' sums added in order."""
        for r in range(pl_.tile_groups):
            for e in range(chunk):
                part = np.zeros((n_cta, 32), np.float32)
                for tile in range(r, pl_.tiles, pl_.tile_groups):
                    y, rows, _, valid = regs[r, tile]
                    for i in range(4):
                        mine = valid[:, :, i] & (rows[None, :, i] // h == e)
                        part = part + np.where(mine, value(y[:, :, i], rows[:, i]), np.float32(0.0))
                for o in (16, 8, 4, 2, 1):
                    part = part + part[:, _LANE ^ o]
                img[e_valid[:, e], red_off[pass_] + r * chunk + e] = part[e_valid[:, e], 0]

        def total(rows):  # (n_cta, 32): the sum of the element of each lane's row
            e = np.minimum(rows // h, chunk - 1)
            t = img[cta, red_off[pass_] + e]
            for r in range(1, pl_.tile_groups):
                t = t + img[cta, red_off[pass_] + r * chunk + e]
            return t
        return total

    n = np.float32(h * cpg)
    sum0 = group_sums(0, lambda y, rows: y)
    mean = lambda rows: sum0(rows) / n
    sum1 = group_sums(1, lambda y, rows: (y - mean(rows)) ** 2)
    for (r, tile), (y, rows, cols, valid) in regs.items():
        for i in range(4):
            with np.errstate(invalid="ignore"):  # rows past the chunk's valid ones
                inv_std = np.float32(1.0) / np.sqrt(sum1(rows[:, i]) / n + np.float32(eps))
                yn = (y[:, :, i] - mean(rows[:, i])) * inv_std * par(1, cols[:, i]) + par(2, cols[:, i])
            for q in range(n_cta):
                ok = valid[q, :, i]
                bi, ti = b0[q] + rows[ok, i] // h, rows[ok, i] % h
                ch = grp[q] * cpg + cols[ok, i]
                out[bi, ti, ch] = _mish(yn[q, ok])
                np.add.at(written, (bi, ti, ch), 1)
    assert np.all(written == 1), "the kernel's stores do not cover the output once"
    return out


def emulate_episode_grid(x0s, noise, n_steps, du, offsets, run_cluster, n_ranks=up.CLUSTER):
    """A fleet launch of an episode kernel in numpy: a grid of N = len(x0s)
    clusters of ``n_ranks`` CTAs over FLAT buffers, as the kernels see them.
    Every CTA of block b computes its episode e = b // n_ranks (the kernels'
    ``blockIdx.x / CLUSTER``) and, through ``offsets(e, n_steps, dx, du,
    noise_len)`` (``ops/fused_episode.py::episode_offsets``, the kernels'
    formula), reads its x0 (dx values) and its noise (noise_len, one
    episode's share of ``noise``) from the flat inputs; the CTAs of a
    cluster must agree on both. Each cluster then runs ``run_cluster(x0,
    noise) -> (x_track, u_track, costs, chosen)`` (one episode's program,
    e.g. ``emulate_ddim_episode_kernel``) and its rank 0 writes them into
    the flat outputs through the same offsets. Every output element must be
    written exactly once, by the cluster of its own episode. Returns the
    outputs shaped (N, ...)."""
    n = len(x0s)
    dx = x0s.shape[1]
    noise_len = int(np.prod(noise.shape[1:]))
    x0_flat, noise_flat = np.ascontiguousarray(x0s).ravel(), np.ascontiguousarray(noise).ravel()
    lengths = {"x_track": (n_steps + 1) * dx, "u_track": n_steps * du, "costs": n_steps,
               "chosen": n_steps}
    outs = {name: np.full(n * size, np.nan) for name, size in lengths.items()}
    writer = {name: np.full(n * size, -1) for name, size in lengths.items()}
    for e in range(n):
        reads = []
        for b in range(e * n_ranks, (e + 1) * n_ranks):
            o = offsets(b // n_ranks, n_steps, dx, du, noise_len)
            reads.append((x0_flat[o["x0"]:o["x0"] + dx],
                          noise_flat[o["noise"]:o["noise"] + noise_len]))
        for x0_r, nz_r in reads[1:]:
            np.testing.assert_array_equal(x0_r, reads[0][0])
            np.testing.assert_array_equal(nz_r, reads[0][1])
        x0_e, nz_e = reads[0]
        assert x0_e.size == dx and nz_e.size == noise_len, f"episode {e} reads past its inputs"
        result = run_cluster(x0_e, nz_e.reshape(noise.shape[1:]))
        o = offsets(e, n_steps, dx, du, noise_len)
        for name, value in zip(lengths, result):
            at = o[name] + np.arange(lengths[name])
            assert at.max() < writer[name].size, f"episode {e} writes past {name}"
            assert (writer[name][at] == -1).all(), f"episode {e} writes {name} a second time"
            writer[name][at] = e
            outs[name][at] = np.asarray(value, np.float64).ravel()
    for name, size in lengths.items():
        owner = np.repeat(np.arange(n), size)
        assert (writer[name] == owner).all(), f"{name}: an element not written by its own episode"
    return tuple(outs[name].reshape((n, -1) if name in ("costs", "chosen") else
                                    (n, -1, dx if name == "x_track" else du))
                 for name in lengths)
