"""The 7-DoF Franka Panda arm of ``mpc_via_diffusion_model_tpu/dynamics/arm.py``
on torch tensors, fp32, every function taking leading batch axes (q, qd,
qdd (..., 7), x (..., 14), u (..., 7)):

- ``panda_fk`` (the end-effector position through the modified-DH chain)
  and ``panda_ee_velocity`` (J(q) qd, a directional derivative of the FK:
  ``torch.func.jvp`` where JAX takes ``jax.jacobian`` and a product);
- ``panda_context`` and ``make_panda_context``: the 20-dim condition
  (q | qd | ee position | ee velocity), the latter from the shifted state
  of ``panda_rbd`` (q = x[:7] + q_ref) as a ``PandaContext``, the map the
  episode kernel runs (``kind``, ``device_consts``);
- ``panda_surrogate`` (inertia-scaled double integrators) and
  ``panda_cost``;
- the articulated rigid-body dynamics: ``panda_link_transforms``,
  ``panda_inverse_dynamics`` (recursive Newton-Euler, the JAX scan's link
  body in a Python loop), ``panda_mass_matrix`` (the RNE column trick with
  the 7 unit accelerations as a batch axis, symmetrised) and ``panda_rbd``
  (M qdd = u - bias - viscous qd by ``torch.linalg.solve``, semi-implicit
  Euler, the state shifted by ``q_ref``);
- ``panda_inverse_dynamics_unrolled``, ``solve_spd_unrolled`` and
  ``panda_rbd_unrolled``: the forms the JAX package traces into its episode
  kernel (component cross products, explicit 3-vector products, an unrolled
  Cholesky solve), which the port's episode kernel
  (``ops/csrc/plants.cuh``, ``PandaRbd``) follows operation by operation;
  these are its plain version.

The inertial tables are the port's own copy of the JAX module's (the public
Franka Panda parameters). Every constant enters the float32 arithmetic as
JAX's does: computed in float64 numpy, then rounded to float32.
``PandaRbd.device_consts`` lays them out for the kernel.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .base import Plant, QuadraticCost

__all__ = ["panda_surrogate", "panda_rbd", "panda_cost", "panda_fk", "panda_link_transforms",
           "panda_ee_velocity", "panda_context", "make_panda_context", "PandaContext",
           "panda_inverse_dynamics", "panda_inverse_dynamics_unrolled", "panda_rbd_unrolled",
           "panda_mass_matrix", "solve_spd_unrolled", "PANDA_READY_POSE", "panda_device_consts",
           "fk_device_consts"]

# Franka Panda modified-DH parameters (a, d, alpha), public spec
_PANDA_DH = np.array([
    [0.0, 0.333, 0.0],
    [0.0, 0.0, -np.pi / 2],
    [0.0, 0.316, np.pi / 2],
    [0.0825, 0.0, np.pi / 2],
    [-0.0825, 0.384, -np.pi / 2],
    [0.0, 0.0, np.pi / 2],
    [0.088, 0.0, np.pi / 2],
], dtype=np.float64)
_FLANGE_D = 0.107

# effective joint inertias and damping of the surrogate's torque -> acceleration map
_J_INERTIA = np.array([1.2, 1.2, 1.0, 1.0, 0.6, 0.4, 0.3], dtype=np.float32)
_J_DAMPING = np.array([2.0, 2.0, 1.5, 1.5, 1.0, 0.8, 0.6], dtype=np.float32)

# link masses (kg), COMs in the link frame (m), inertia tensors about the COM (kg m^2)
_PANDA_MASS = np.array([4.970684, 0.646926, 3.228604, 3.587895, 1.225946, 1.666555, 0.735522],
                       dtype=np.float64)
_PANDA_COM = np.array([
    [3.875e-03, 2.081e-03, -0.1750],
    [-3.141e-03, -2.872e-02, 3.495e-03],
    [2.7518e-02, 3.9252e-02, -6.6502e-02],
    [-5.317e-02, 1.04419e-01, 2.7454e-02],
    [-1.1953e-02, 4.1065e-02, -3.8437e-02],
    [6.0149e-02, -1.4117e-02, -1.0517e-02],
    [1.0517e-02, -4.252e-03, 6.1597e-02],
], dtype=np.float64)
_PANDA_INERTIA = np.array([
    [[7.0337e-01, -1.3900e-04, 6.7720e-03], [-1.3900e-04, 7.0661e-01, 1.9169e-02],
     [6.7720e-03, 1.9169e-02, 9.1170e-03]],
    [[7.9620e-03, -3.9250e-03, 1.0254e-02], [-3.9250e-03, 2.8110e-02, 7.0400e-04],
     [1.0254e-02, 7.0400e-04, 2.5995e-02]],
    [[3.7242e-02, -4.7610e-03, -1.1396e-02], [-4.7610e-03, 3.6155e-02, -1.2805e-02],
     [-1.1396e-02, -1.2805e-02, 1.0830e-02]],
    [[2.5853e-02, 7.7960e-03, -1.3320e-03], [7.7960e-03, 1.9552e-02, 8.6410e-03],
     [-1.3320e-03, 8.6410e-03, 2.8323e-02]],
    [[3.5549e-02, -2.1170e-03, -4.0370e-03], [-2.1170e-03, 2.9474e-02, 2.2900e-04],
     [-4.0370e-03, 2.2900e-04, 8.6270e-03]],
    [[1.9640e-03, 1.0900e-04, -1.1580e-03], [1.0900e-04, 4.3540e-03, 3.4100e-04],
     [-1.1580e-03, 3.4100e-04, 5.4330e-03]],
    [[1.2516e-02, -4.2800e-04, -1.1960e-03], [-4.2800e-04, 1.0027e-02, -7.4100e-04],
     [-1.1960e-03, -7.4100e-04, 4.8150e-03]],
], dtype=np.float64)
# viscous joint friction (N m s / rad)
_PANDA_VISCOUS = np.array([0.5, 0.5, 0.4, 0.4, 0.3, 0.25, 0.2], dtype=np.float64)
_GRAVITY = 9.81

# the Franka "ready" pose: elbow bent, gravity torques strongly nonzero
PANDA_READY_POSE = np.array([0.0, -np.pi / 4, 0.0, -3 * np.pi / 4, 0.0, np.pi / 2, np.pi / 4],
                            dtype=np.float64)

# per-link float32 constants of the link transform: a, cos(alpha), sin(alpha), -d sin(alpha),
# d cos(alpha), each computed in float64 and rounded once, as JAX rounds its numpy scalars
_A = _PANDA_DH[:, 0]
_CA, _SA = np.cos(_PANDA_DH[:, 2]), np.sin(_PANDA_DH[:, 2])
_LINK = np.stack([_A, _CA, _SA, -_PANDA_DH[:, 1] * _SA, _PANDA_DH[:, 1] * _CA],
                 axis=1).astype(np.float32)  # (7, 5)


def fk_device_consts() -> np.ndarray:
    """The FK's float32 table as the episode kernel reads it after q_ref
    (``plants.cuh``, ``PandaContext``): per link a, cos(alpha), sin(alpha),
    -d sin(alpha), d cos(alpha), then the flange's d."""
    return np.concatenate([_LINK.reshape(-1), np.float32([_FLANGE_D])]).astype(np.float32)


def panda_device_consts(q_ref: np.ndarray = PANDA_READY_POSE) -> np.ndarray:
    """``PandaRbd``'s float32 table after dt (``plants.cuh``): the link
    table (7 x 5, ``fk_device_consts``' order), the masses (7), the COMs (7 x
    3), the inertia tensors (7 x 3 x 3, row-major), the viscous gains (7)
    and q_ref (7)."""
    return np.concatenate([_LINK.reshape(-1), _PANDA_MASS, _PANDA_COM.reshape(-1),
                           _PANDA_INERTIA.reshape(-1), _PANDA_VISCOUS,
                           np.asarray(q_ref, np.float64)]).astype(np.float32)


_TABLES = {}


def _tables(device, q_ref=None) -> dict:
    """The float32 tables on ``device`` (and ``q_ref`` there under
    "q_ref"), copied there once: a step runs many times, and a copy per call
    would cost the card a transfer and the host a wait each."""
    key = (str(device), None if q_ref is None else tuple(np.asarray(q_ref, np.float32).tolist()))
    if key not in _TABLES:
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        flange = np.eye(4, dtype=np.float32)
        flange[2, 3] = _FLANGE_D
        _TABLES[key] = {"mass": f(_PANDA_MASS), "com": f(_PANDA_COM),
                        "inertia": f(_PANDA_INERTIA), "viscous": f(_PANDA_VISCOUS),
                        "j_inertia": f(_J_INERTIA), "j_damping": f(_J_DAMPING),
                        "z": f([0.0, 0.0, 1.0]), "bottom": f([0.0, 0.0, 0.0, 1.0]),
                        "flange": f(flange), "eye4": f(np.eye(4)),
                        "q_ref": None if q_ref is None else f(q_ref)}
    return _TABLES[key]


def _link_rot_pos(q_i: torch.Tensor, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(^{i-1}R_i (..., 3, 3), ^{i-1}P_i (..., 3)) of link i at joint angle
    q_i (...): the modified-DH screw X(a, alpha) then Z(d, q)."""
    a, ca, sa, dsa, dca = (float(v) for v in _LINK[i])
    cq, sq = torch.cos(q_i), torch.sin(q_i)
    z, o = torch.zeros_like(cq), torch.ones_like(cq)
    r = torch.stack([torch.stack([cq, -sq, z], -1),
                     torch.stack([sq * ca, cq * ca, z - sa], -1),
                     torch.stack([sq * sa, cq * sa, z + ca], -1)], -2)
    p = torch.stack([o * a, o * dsa, o * dca], -1)
    return r, p


def panda_fk(q: torch.Tensor) -> torch.Tensor:
    """End-effector position (..., 3) from joint angles q (..., 7): the 4 x 4
    homogeneous transforms of the seven links and the flange, multiplied in
    chain order."""
    tab = _tables(q.device)
    t = tab["eye4"].expand(*q.shape[:-1], 4, 4)
    for i in range(7):
        r, p = _link_rot_pos(q[..., i], i)
        ti = torch.cat([torch.cat([r, p[..., None]], -1),
                        tab["bottom"].expand(*q.shape[:-1], 1, 4)], -2)
        t = t @ ti
    return (t @ tab["flange"])[..., :3, 3]


def panda_ee_velocity(q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """End-effector linear velocity J(q) qd (..., 3): the FK's directional
    derivative along qd (forward mode). One state (7,) runs as a batch of
    one: torch's forward mode gives a 0-dim product with a Python float a
    float64 tangent."""
    if q.dim() == 1:
        return panda_ee_velocity(q[None], qd[None])[0]
    return torch.func.jvp(panda_fk, (q,), (qd,))[1]


def panda_context(x: torch.Tensor) -> torch.Tensor:
    """State (..., 14) -> the 20-dim condition (q | qd | ee position | ee
    velocity)."""
    q, qd = x[..., :7], x[..., 7:]
    return torch.cat([q, qd, panda_fk(q), panda_ee_velocity(q, qd)], -1)


class PandaContext:
    """``x (..., 14) -> panda_context(q = x[:7] + q_ref, qd = x[7:])``, the
    context map of the shifted-coordinate ``panda_rbd`` plant (the JAX
    package's ``make_panda_context``). ``kind`` names the episode kernel's
    device map (``ops/csrc/plants.cuh``, ``PandaContext``) and
    ``device_consts`` are what it reads: q_ref (7), then the FK's table
    (``fk_device_consts``)."""

    kind = "panda_context"

    def __init__(self, q_ref=PANDA_READY_POSE):
        q_ref = q_ref if torch.is_tensor(q_ref) else torch.from_numpy(np.asarray(q_ref, np.float32))
        self.q_ref = q_ref.to(torch.float32).reshape(7)
        self._on = {self.q_ref.device: self.q_ref}  # q_ref on each device it was asked on

    @property
    def device_consts(self) -> Tuple[float, ...]:
        return tuple(float(v) for v in np.concatenate([self.q_ref.detach().cpu().numpy(),
                                                        fk_device_consts()]))

    def to(self, device) -> "PandaContext":
        return PandaContext(self.q_ref.to(device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device not in self._on:
            self._on[x.device] = self.q_ref.to(x.device)
        q = x[..., :7] + self._on[x.device]
        qd = x[..., 7:]
        return torch.cat([q, qd, panda_fk(q), panda_ee_velocity(q, qd)], -1)


def make_panda_context(q_ref: np.ndarray = PANDA_READY_POSE) -> PandaContext:
    """The context map of the shifted-coordinate ``panda_rbd`` plant: the
    20-dim condition from the true joint angles q = x[:7] + q_ref."""
    return PandaContext(q_ref)


def panda_surrogate(dt: float = 0.01) -> Plant:
    """Inertia-scaled double integrators with viscous damping."""

    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        tab = _tables(x.device)
        q, qd = x[..., :7], x[..., 7:]
        qdd = (u - tab["j_damping"] * qd) / tab["j_inertia"]
        return torch.cat([q + qd * dt, qd + qdd * dt], -1)

    return Plant(name="panda_surrogate", state_dim=14, control_dim=7, dt=dt, step=step)


def panda_cost() -> QuadraticCost:
    """Joint-space regulation cost (q -> 0 posture, damped)."""
    return QuadraticCost(
        q_diag=torch.cat([torch.full((7,), 1.0), torch.full((7,), 0.1)]),
        r=torch.full((7,), 0.01),
        p_diag=torch.cat([torch.full((7,), 10.0), torch.full((7,), 1.0)]))


def panda_link_transforms(q: torch.Tensor):
    """Base-frame (R (..., 3, 3), p (..., 3)) of every link frame, a list of 7."""
    r_acc = torch.eye(3, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 3, 3)
    p_acc = torch.zeros((*q.shape[:-1], 3), dtype=q.dtype, device=q.device)
    out = []
    for i in range(7):
        r_i, p_i = _link_rot_pos(q[..., i], i)
        p_acc = p_acc + (r_acc @ p_i[..., None])[..., 0]
        r_acc = r_acc @ r_i
        out.append((r_acc, p_acc))
    return out


def _mv(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (r @ v[..., None])[..., 0]


def _mtv(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (r.transpose(-1, -2) @ v[..., None])[..., 0]


def panda_inverse_dynamics(q: torch.Tensor, qd: torch.Tensor, qdd: torch.Tensor,
                           gravity: float = _GRAVITY) -> torch.Tensor:
    """Joint torques (..., 7) of a motion by recursive Newton-Euler (Craig
    ch. 6, modified DH); gravity enters as the base acceleration +g z, and
    friction is left out. The JAX package's two scans, as Python loops over
    the links."""
    tab = _tables(q.device)
    z = tab["z"]
    lead = q.shape[:-1]
    omega = torch.zeros((*lead, 3), dtype=q.dtype, device=q.device)
    omegad = torch.zeros_like(omega)
    vd = (z * gravity).expand(*lead, 3)
    rs, ps, fs, ns = [], [], [], []
    for i in range(7):
        r_i, p_i = _link_rot_pos(q[..., i], i)
        c, inertia, mass = tab["com"][i], tab["inertia"][i], tab["mass"][i]
        vd = _mtv(r_i, vd + torch.linalg.cross(omegad, p_i)
                  + torch.linalg.cross(omega, torch.linalg.cross(omega, p_i)))
        omega_r = _mtv(r_i, omega)
        omegad = (_mtv(r_i, omegad) + torch.linalg.cross(omega_r, qd[..., i, None] * z)
                  + qdd[..., i, None] * z)
        omega = omega_r + qd[..., i, None] * z
        vd_c = vd + torch.linalg.cross(omegad, c.expand_as(vd)) + torch.linalg.cross(
            omega, torch.linalg.cross(omega, c.expand_as(vd)))
        fs.append(mass * vd_c)
        ns.append(_mv(inertia, omegad) + torch.linalg.cross(omega, _mv(inertia, omega)))
        rs.append(r_i)
        ps.append(p_i)
    f_next = torch.zeros_like(omega)
    n_next = torch.zeros_like(omega)
    taus = [None] * 7
    for i in reversed(range(7)):
        if i < 6:  # the last link's child is the identity with no offset
            f_from_child = _mv(rs[i + 1], f_next)
            n_from_child = _mv(rs[i + 1], n_next) + torch.linalg.cross(ps[i + 1], f_from_child)
        else:
            f_from_child = n_from_child = torch.zeros_like(omega)
        c = tab["com"][i].expand_as(omega)
        f_i = f_from_child + fs[i]
        n_i = ns[i] + n_from_child + torch.linalg.cross(c, fs[i])
        f_next, n_next = f_i, n_i
        taus[i] = n_i[..., 2]
    return torch.stack(taus, -1)


def panda_mass_matrix(q: torch.Tensor) -> torch.Tensor:
    """M(q) (..., 7, 7) by the RNE column trick, M[:, j] = RNE(q, 0, e_j, g = 0),
    the 7 unit accelerations a batch axis; symmetrised, 0.5 (M + M^T)."""
    eye = torch.eye(7, dtype=q.dtype, device=q.device)
    qb = q[..., None, :].expand(*q.shape[:-1], 7, 7)
    cols = panda_inverse_dynamics(qb, torch.zeros_like(qb), eye.expand_as(qb), gravity=0.0)
    m = cols.transpose(-1, -2)  # cols[..., j, :] = M[:, j]
    return 0.5 * (m + m.transpose(-1, -2))


def panda_rbd(dt: float = 0.01, q_ref: np.ndarray = PANDA_READY_POSE) -> Plant:
    """The full articulated-body Panda: state x = (q - q_ref (7), qd (7)),
    controls the joint torques (7); M(q) qdd = u - bias(q, qd) - viscous qd
    by ``torch.linalg.solve``, then semi-implicit Euler (qd first)."""
    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        tab = _tables(x.device, q_ref)
        q = x[..., :7] + tab["q_ref"]
        qd = x[..., 7:]
        bias = panda_inverse_dynamics(q, qd, torch.zeros_like(qd))
        m = panda_mass_matrix(q)
        rhs = u - bias - tab["viscous"] * qd
        qdd = torch.linalg.solve(m, rhs)
        qd_next = qd + qdd * dt
        return torch.cat([x[..., :7] + qd_next * dt, qd_next], -1)

    return Plant(name="panda_rbd", state_dim=14, control_dim=7, dt=dt, step=step,
                 device_consts=tuple(float(v) for v in panda_device_consts(q_ref)))


# --------------------------------------------------------------------------- #
# The kernel's forms: the JAX package's Mosaic-lowerable variants
# --------------------------------------------------------------------------- #


def _cross(a, b):
    """a x b of two lists of three (...) tensors, component by component."""
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


def _matvec(r, v):
    """r @ v, r a (3, 3) nested list, v a list of three, left to right."""
    return [r[i][0] * v[0] + r[i][1] * v[1] + r[i][2] * v[2] for i in range(3)]


def _matvec_t(r, v):
    """r^T @ v without the transpose."""
    return [r[0][j] * v[0] + r[1][j] * v[1] + r[2][j] * v[2] for j in range(3)]


def _add(a, b):
    return [x + y for x, y in zip(a, b)]


def _link_unrolled(q_i, i):
    """``_link_rot_pos`` as nested lists of (...) tensors and floats."""
    a, ca, sa, dsa, dca = (float(v) for v in _LINK[i])
    cq, sq = torch.cos(q_i), torch.sin(q_i)
    z = torch.zeros_like(cq)
    r = [[cq, -sq, z], [sq * ca, cq * ca, z - sa], [sq * sa, cq * sa, z + ca]]
    return r, [z + a, z + dsa, z + dca]


def panda_inverse_dynamics_unrolled(q: torch.Tensor, qd: torch.Tensor, qdd: torch.Tensor,
                                    gravity: float = _GRAVITY, links=None) -> torch.Tensor:
    """``panda_inverse_dynamics`` with component-formula cross products and
    explicit 3-vector products, as the JAX package's unrolled form computes
    it and the kernel's ``PandaRbd`` does (only the z components of qd_i z
    and qdd_i z are nonzero). ``links`` are the seven ``_link_unrolled`` of
    q where already computed: they depend on q only."""
    tab = _tables(q.device)
    coms, inertias, masses = tab["com"], tab["inertia"], tab["mass"]
    zero = torch.zeros_like(q[..., 0])
    links = links or [_link_unrolled(q[..., i], i) for i in range(7)]
    omega, omegad = [zero] * 3, [zero] * 3
    vd = [zero, zero, zero + np.float32(gravity)]
    fs, ns = [], []
    for i in range(7):
        r_i, p_i = links[i]
        c = [coms[i, j] for j in range(3)]
        inertia = [[inertias[i, j, k] for k in range(3)] for j in range(3)]
        vd = _matvec_t(r_i, _add(_add(vd, _cross(omegad, p_i)),
                                 _cross(omega, _cross(omega, p_i))))
        omega_r = _matvec_t(r_i, omega)
        qd_z = [zero, zero, qd[..., i]]
        qdd_z = [zero, zero, qdd[..., i]]
        omegad = _add(_add(_matvec_t(r_i, omegad), _cross(omega_r, qd_z)), qdd_z)
        omega = _add(omega_r, qd_z)
        vd_c = _add(_add(vd, _cross(omegad, c)), _cross(omega, _cross(omega, c)))
        fs.append([masses[i] * v for v in vd_c])
        ns.append(_add(_matvec(inertia, omegad), _cross(omega, _matvec(inertia, omega))))
    f_next, n_next = [zero] * 3, [zero] * 3
    taus = [None] * 7
    for i in reversed(range(7)):
        if i < 6:
            r_nx, p_nx = links[i + 1]
            f_from_child = _matvec(r_nx, f_next)
            n_from_child = _add(_matvec(r_nx, n_next), _cross(p_nx, f_from_child))
        else:
            f_from_child = n_from_child = [zero] * 3
        c = [coms[i, j] for j in range(3)]
        f_i = _add(f_from_child, fs[i])
        n_i = _add(_add(ns[i], n_from_child), _cross(c, fs[i]))
        f_next, n_next = f_i, n_i
        taus[i] = n_i[2]
    return torch.stack(taus, -1)


def solve_spd_unrolled(m: torch.Tensor, b: torch.Tensor, n: int = 7) -> torch.Tensor:
    """x (..., n) with m x = b for SPD m (..., n, n): the scalar Cholesky
    factorisation and the two triangular solves, unrolled, no pivoting."""
    lo = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = m[..., i, j]
            for k in range(j):
                s = s - lo[i][k] * lo[j][k]
            lo[i][j] = torch.sqrt(s) if i == j else s / lo[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - lo[i][k] * y[k]
        y[i] = s / lo[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - lo[k][i] * x[k]
        x[i] = s / lo[i][i]
    return torch.stack(x, -1)


def panda_rbd_unrolled(dt: float = 0.01, q_ref: np.ndarray = PANDA_READY_POSE) -> Plant:
    """``panda_rbd`` in the kernel's form: the unrolled RNE for the bias, the
    7 mass columns by the unrolled RNE at the unit accelerations, the
    symmetrisation, the unrolled Cholesky solve and the semi-implicit Euler
    step, in the JAX package's order; ``device_consts`` the kernel's table
    (``panda_device_consts``). The episode's plain version steps it."""
    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        tab = _tables(x.device, q_ref)
        q = x[..., :7] + tab["q_ref"]
        qd = x[..., 7:]
        links = [_link_unrolled(q[..., i], i) for i in range(7)]
        zeros = torch.zeros_like(qd)
        bias = panda_inverse_dynamics_unrolled(q, qd, zeros, links=links)
        eye = torch.eye(7, dtype=x.dtype, device=x.device)
        cols = [panda_inverse_dynamics_unrolled(q, zeros, eye[j].expand_as(qd), gravity=0.0,
                                                links=links) for j in range(7)]
        m = torch.stack(cols, -1)
        m = 0.5 * (m + m.transpose(-1, -2))
        rhs = u - bias - tab["viscous"] * qd
        qdd = solve_spd_unrolled(m, rhs)
        qd_next = qd + qdd * dt
        return torch.cat([x[..., :7] + qd_next * dt, qd_next], -1)

    return Plant(name="panda_rbd", state_dim=14, control_dim=7, dt=dt, step=step,
                 device_consts=tuple(float(v) for v in panda_device_consts(q_ref)))
