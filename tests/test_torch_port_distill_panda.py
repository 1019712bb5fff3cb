"""The panda arm's distillation recipe (``scripts/distill_panda.py``) in the
port against the JAX package on the CPU: the distill step at the panda's
shapes (7 channels, context 20) on a narrow U-Net, the distilled student's
closed loop on staged draws, and the script's ``--rounds 0`` report at a toy
size; and the JAX side of ``data/distilled_panda_yardstick.py`` and its
paired literals (marked ``slow``: about 50 s).

Tolerances. The distill steps in float32 against JAX's: the losses within
1e-4 relative and the weights within 1e-4 of their largest, at a learning
rate small enough that a flipped sign of a tiny gradient in Adam stays below
that. The closed loop at the committed student's full width in float32
against JAX's (TOL, controls in normalized units), as
tests/test_torch_port_panda.py holds the 1-eval student's.
"""
from __future__ import annotations

import collections
import contextlib
import json
import pickle
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu import train as jt
from mpc_via_diffusion_model_tpu.control import make_closed_loop as jax_closed_loop
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.datasets import ControlSequenceDataset as JaxDataset
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.diffusion import distillation as jdist
from mpc_via_diffusion_model_tpu.dynamics import arm as jarm
from mpc_via_diffusion_model_tpu.dynamics import get_plant as jax_get_plant
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu_torch import train as pt
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import distilled_panda_yardstick as dpy
from mpc_via_diffusion_model_tpu_torch.data import panda_stats as ps
from mpc_via_diffusion_model_tpu_torch.diffusion import distillation as dist
from mpc_via_diffusion_model_tpu_torch.models import (PANDA_STUDENT_CONFIG, TemporalUnet,
                                                      from_flax_params, init_like_flax,
                                                      load_panda_student, to_flax_params)
from mpc_via_diffusion_model_tpu_torch.scripts import distill_panda

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
# one level: the step is the distillation's at the panda's shapes whatever the U-Net's depth
# (tests/test_torch_port_distill_train.py runs three levels), and JAX compiles it in ~11 s, not ~20
NARROW = dict(state_dim=7, n_support_points=16, unet_input_dim=8, dim_mults=(1,),
              context_dim=20)


def _jax_stats():
    return (JaxStats("limits", jnp.asarray(ps.INPUTS_MINS, jnp.float32),
                     jnp.asarray(ps.INPUTS_MAXS, jnp.float32)),
            JaxStats("limits", jnp.asarray(ps.CONDITION_MINS, jnp.float32),
                     jnp.asarray(ps.CONDITION_MAXS, jnp.float32)))


def _jax_student():
    with open(dpy.STUDENT, "rb") as f:
        params = pickle.load(f)
    return JaxUnet(conditioning_type="default", cfg_indicator=True, **PANDA_STUDENT_CONFIG), params


def _jax_loop(n_steps: int):
    """The JAX script's ``eval_student`` loop of the committed 3-eval student, jitted."""
    jm, params = _jax_student()
    jsched = jax_make_schedule("exponential", dpy.T)
    sampler = jdist.make_student_ddim_sampler(jsched, jm.apply, dpy.TIMES)
    plant, cost = jax_get_plant("panda")
    loop = jax_closed_loop(JaxDiffusion(schedule=jsched), jm.apply, *_jax_stats(), plant, cost,
                           horizon=dpy.H, n_steps=n_steps,
                           sample_override=lambda ctx, k: sampler(params, ctx, k, (1, dpy.H, 7)),
                           state_to_condition=jarm.make_panda_context())
    return jax.jit(lambda x0, k: loop(params, x0, k))


class _StagedKeys:
    """Substitutes for ``jax.random.split``, ``randint`` and ``normal`` while
    the JAX distill step is traced: its key is the pair (j, noise) of staged
    draws (tests/test_torch_port_distill_train.py's)."""

    def __init__(self):
        self.calls = collections.Counter()

    def split(self, key, num=2):
        self.calls["split"] += 1
        return key, key

    def randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        self.calls["randint"] += 1
        return key[0].astype(dtype)

    def normal(self, key, shape=(), dtype=jnp.float32):
        self.calls["normal"] += 1
        return key[1].astype(dtype)

    @contextlib.contextmanager
    def patched(self):
        with mock.patch.multiple(jax.random, split=self.split, randint=self.randint,
                                 normal=self.normal):
            yield


def jax_yardstick() -> dict:
    """(a) and (b) of data/distilled_panda_yardstick.py with the JAX package on the CPU."""
    keys = jax.random.split(jax.random.PRNGKey(dpy.KEY_SEED), dpy.N_SEEDS)
    loop = _jax_loop(dpy.N_STEPS)
    x0 = jnp.asarray(dpy.x0())
    stages = [np.asarray(loop(x0, keys[i]).stage_costs, np.float32) for i in range(dpy.N_SEEDS)]
    out = {"COSTS": tuple(float(s.astype(np.float64).sum()) for s in stages),
           "PREFIX_COSTS": tuple(float(s[:dpy.PREFIX_STEPS].astype(np.float64).sum())
                                 for s in stages)}
    ds = JaxDataset.load(str(dpy.DATASET))
    with open(dpy.TEACHER, "rb") as f:
        teacher = jax.tree_util.tree_map(jnp.asarray, pickle.load(f)["ema_params"])
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **PANDA_STUDENT_CONFIG)
    opt = jt.make_optimizer(dpy.LR)
    staged = _StagedKeys()
    draws = dpy.staged_draws(ds.inputs_normalized.shape[0])
    with staged.patched():
        step_fn, _ = jdist.make_distill_step(jax_make_schedule("exponential", dpy.T), jm.apply,
                                             opt, teacher, dpy.TEACHER_TIMES, w=dpy.W,
                                             teacher_cfg=True)
        step = jax.jit(step_fn)
        state = jt.TrainState(teacher, jax.tree_util.tree_map(jnp.copy, teacher),
                              opt.init(teacher), jnp.int32(0))
        losses = []
        for n in range(dpy.N_DISTILL_STEPS):
            idx = draws["idx"][n]
            key = (jnp.asarray(draws["j"][n].astype(np.int32)), jnp.asarray(draws["noise"][n]))
            state, met = step(state, ds.inputs_normalized[idx], ds.condition_normalized[idx], key)
            losses.append(float(met["loss"]))
    assert staged.calls == {"split": 1, "randint": 1, "normal": 1}, staged.calls
    out["LOSSES"] = tuple(losses)
    return out


def _narrow(seed: int):
    """(port model, flax params) of the narrow model at the panda's shapes from RandomState(seed)."""
    tm = init_like_flax(TemporalUnet(**NARROW, cfg_indicator=True), np.random.RandomState(seed))
    return tm, jax.tree_util.tree_map(jnp.asarray, to_flax_params(tm))


def test_distill_steps_at_the_panda_shapes_match_jax():
    """Two steps of round 0 (the CFG teacher, w = 0.01, the 24-step teacher grid) at 7 channels
    and context 20 on a narrow one-level U-Net, student and teacher from RandomState(2) and
    (1)'s weights, the same batch and JAX's draws from its keys, float32: each loss within 1e-4
    relative and
    the params after both steps within 1e-4 of their largest (lr 1e-5: Adam moves a weight by
    about lr whatever its gradient, so a tiny gradient's flipped sign stays below that)."""
    tm, jparams = _narrow(2)
    teacher_model, jteacher = _narrow(1)
    teacher = {n: q.detach() for n, q in teacher_model.named_parameters()}
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (6, NARROW["n_support_points"], 7)).astype(np.float32)
    c = rs.uniform(-1, 1, (6, 20)).astype(np.float32)
    grid = dist.ddim_time_grid(25, t_start=23)
    jm = JaxUnet(**NARROW, conditioning_type="default", cfg_indicator=True)
    jopt = jt.make_optimizer(1e-5)
    jstep, _ = jdist.make_distill_step(jax_make_schedule("exponential", 25), jm.apply, jopt,
                                       jteacher, grid, w=0.01, teacher_cfg=True)
    jstep = jax.jit(jstep)
    jstate = jt.TrainState(jparams, jax.tree_util.tree_map(jnp.copy, jparams),
                           jopt.init(jparams), jnp.int32(0))
    opt = pt.make_optimizer(1e-5)
    step, _ = dist.make_distill_step(make_schedule("exponential", 25), tm, opt, teacher, grid,
                                     w=0.01, teacher_cfg=True)
    layout = pt.ParamLayout.of(tm)
    params = layout.flatten(dict(tm.named_parameters()))
    state = pt.TrainState(params, params.clone(), opt.init(params),
                          torch.zeros((), dtype=torch.int32), layout)
    n_pairs = len(dist.halve_times(grid))
    for key in jax.random.split(jax.random.PRNGKey(9), 2):
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(c), key)
        k_j, k_noise = jax.random.split(key)
        draws = {"j": torch.from_numpy(np.asarray(jax.random.randint(k_j, (6,), 0, n_pairs))
                                       .astype(np.int64)),
                 "noise": torch.from_numpy(np.array(jax.random.normal(k_noise, x.shape)))}
        state, met = step(state, torch.from_numpy(x), torch.from_numpy(c), draws)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-4)
    want = layout.flatten(from_flax_params(jax.tree_util.tree_map(np.asarray, jstate.params)))
    assert float((state.params - want).abs().max() / want.abs().max()) < 1e-4


def test_student_closed_loop_matches_jax():
    """The committed 3-eval student at full width through the port's chain split
    (``distill_panda.chain_loop``, the DDIM chain's plain version on the CPU, the arm
    ``panda_rbd``) against the JAX script's ``eval_student`` loop on JAX's draws, 2 replans:
    TOL, the controls in normalized units."""
    n_steps = 2
    key = jax.random.PRNGKey(12)
    want = _jax_loop(n_steps)(jnp.asarray(dpy.x0()), key)
    noise = np.stack([np.array(jax.random.normal(k, (1, dpy.H, 7), jnp.float32))
                      for k in jax.random.split(key, n_steps)])
    ins, cond = ps.panda_stats()
    loop, chain = distill_panda.chain_loop(load_panda_student(dpy.STUDENT, device="cpu"),
                                           dpy.TIMES, 1, n_steps, dpy.H, torch.device("cpu"),
                                           ins, cond)
    got = loop(torch.from_numpy(dpy.x0()), torch.from_numpy(noise))
    assert (chain.launches, chain.plain_calls) == (0, n_steps)
    u_unit = 0.5 * (np.asarray(ps.INPUTS_MAXS) - np.asarray(ps.INPUTS_MINS))
    for name in ("x_track", "u_track", "stage_costs"):
        g, w_ = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name == "u_track":
            g, w_ = g / u_unit, w_ / u_unit
        np.testing.assert_allclose(g, w_, rtol=TOL, atol=TOL, err_msg=name)


def test_distill_panda_script_at_toy_size(tmp_path):
    """The recipe on the CPU at horizon 8: a toy teacher (the panda's architecture,
    init_like_flax from RandomState(5)) with an 8-row dataset; one round of 2 steps from the
    teacher, its student saved in the flax layout and evaluated through the chain split's plain
    version over one replan, then the fused-chain rows fp32 and bf16; report.json has the JAX script's keys and
    each route. A second run on the saved student with ``--rounds 0`` gives the serving rows
    only; ``--out`` under artifacts/ is refused."""
    teacher_dir, out = tmp_path / "teacher", tmp_path / "out"
    teacher_dir.mkdir()
    cfg = dict(PANDA_STUDENT_CONFIG, n_support_points=8)
    tm = init_like_flax(TemporalUnet(**cfg, cfg_indicator=True), np.random.RandomState(5))
    with open(teacher_dir / "ema_params.pkl", "wb") as f:
        pickle.dump({"ema_params": to_flax_params(tm), "step": 0, "cfg_indicator": True}, f)
    (teacher_dir / "report.json").write_text(json.dumps(
        {"closed_loop_cost_nmpc": 236.6, "closed_loop_cost_diffusion_mean10": 244.0}))
    rs = np.random.RandomState(6)
    np.savez(teacher_dir / "dataset.npz", inputs=rs.uniform(-20, 20, (8, 8, 7)).astype(np.float32),
             condition=rs.uniform(-1, 1, (8, 20)).astype(np.float32))
    common = ["--teacher", str(teacher_dir), "--horizon", "8", "--steps", "1",
              "--eval-seeds", "2", "--rate-batches", "1", "--device", "cpu"]
    report = distill_panda.main([*common, "--out", str(out), "--steps-per-round", "2",
                                 "--chunk", "1", "--batch-size", "4", "--rounds", "1"])
    jax_keys = {"teacher", "expert_closed_loop_cost", "teacher_closed_loop_cost_mean10", "w",
                "rounds", "fused_chain_hz_fp32", "fused_chain_cost_ratio_fp32",
                "fused_chain_hz_bf16", "fused_chain_cost_ratio_bf16"}
    assert jax_keys <= set(report) and report["card"] == "cpu"
    (rec,) = report["rounds"]
    assert {"n_evals", "times", "train_seconds", "final_loss", "cost_ratio_vs_expert",
            "cost_ratio_vs_teacher", "closed_loop_cost_mean", "closed_loop_cost_std",
            "all_finite"} <= set(rec)
    assert rec["n_evals"] == 12 and rec["teacher_cfg"] and rec["all_finite"]
    assert (rec["kernel"], rec["launches"], rec["plain_calls"]) == ("ddim_chain", 0, 1)
    assert [report[f"fused_chain_{t}"]["kernel"] for t in ("fp32", "bf16")] == [
        "ddim_chain", "ddim_chain_bf16"]
    assert all(np.isfinite(report[f"fused_chain_cost_ratio_{t}"]) for t in ("fp32", "bf16"))
    with open(out / "student_12eval.pkl", "rb") as f:
        student = pickle.load(f)
    assert set(student) == {"params"}
    times = ",".join(str(t) for t in rec["times"])
    serve = distill_panda.main([*common, "--out", str(tmp_path / "serve"), "--init-student",
                                str(out / "student_12eval.pkl"), "--init-times", times,
                                "--rounds", "0"])
    assert serve["rounds"] == [] and serve["init_student"] == str(out / "student_12eval.pkl")
    assert jax_keys <= set(serve)
    with pytest.raises(SystemExit):
        distill_panda.main(["--out", str(ROOT / "artifacts" / "distilled_port"), "--device", "cpu"])


@pytest.mark.slow
def test_yardstick_regenerates():
    """The JAX package recomputes (a) and (b) of data/distilled_panda_yardstick.py on the CPU
    (the losses to 1e-6 relative: XLA's CPU code)."""
    got = jax_yardstick()
    assert got["COSTS"] == dpy.COSTS and got["PREFIX_COSTS"] == dpy.PREFIX_COSTS
    np.testing.assert_allclose(got["LOSSES"], dpy.LOSSES, rtol=1e-6)


@pytest.mark.slow
def test_paired_prefix_regenerates():
    """(d)'s PAIRED_PREFIX: the port's plain chain split on the CPU over the paired seeds, to
    a tenth of PAIRED_BOUND (the literals were taken at 3 threads; the thread count moves the
    sums' order: 3.6e-7 at one thread)."""
    assert max(dpy.paired_gaps(dpy.paired_prefix_costs(torch.device("cpu")))) <= (
        dpy.PAIRED_BOUND / 10)
