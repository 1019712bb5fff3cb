"""The PyTorch port and chip_smoke.py import neither jax, flax, optax, yaml
nor the JAX package, so they run on a machine that has none of them."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mpc_via_diffusion_model_tpu_torch"

_GUARDED = """
import importlib, pkgutil, sys
# an entry of None makes any import of that name raise ImportError
for name in ('jax', 'flax', 'optax', 'yaml', 'mpc_via_diffusion_model_tpu'):
    sys.modules[name] = None
import mpc_via_diffusion_model_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
for name in ('ops.fused_unet', 'ops.fused_episode', 'ops.fused_denoise', 'ops._build',
             'dynamics.base', 'control.runtime', 'diffusion.distillation', 'data.teacher_stats',
             'ops.fused_conv', 'eval.timing', 'control.metrics', 'data.flagship_stats',
             'scripts.bench_kernels', 'scripts.flagship_parity', 'scripts.episode_recut',
             'scripts.episode_profile', 'bench', 'models.bf16', 'solvers.lqr',
             'data.generation', 'data.lmpc_stats', 'scripts.lmpc_parity', 'core.losses',
             'data.datasets', 'data.lmpc_train_yardstick', 'train.trainer', 'utils.misc',
             'scripts.flagship_lmpc', 'scripts.train_divergence', 'scripts.train_profile',
             'solvers.ilqr', 'data.flagship_expert_yardstick', 'scripts.flagship_run',
             'scripts.ilqr_divergence', 'scripts.ilqr_profile', 'models.ampc',
             'train.regression', 'data.distill_yardstick', 'scripts.distill_flagship',
             'scripts.distill_divergence', 'scripts.train_ampc', 'dynamics.quadrotor',
             'scripts.quadrotor_task', 'data.quadrotor_stats', 'data.quadrotor_yardstick',
             'ops.philox', 'scripts.quadrotor_divergence', 'scripts.bench_quadrotor_student',
             'control.conditions', 'data.scene_stats', 'data.scene_yardstick',
             'scripts.scene_divergence', 'scripts.bench_scene_student', 'data.guided_yardstick',
             'scripts.flagship_quadrotor', 'scripts.scene_conditioned_quadrotor',
             'scripts.guided_divergence', 'scripts.guided_profile', 'scripts.onpolicy_scene',
             'data.scene_making_yardstick', 'data.onpolicy_scene_yardstick',
             'scripts.scene_making_divergence', 'dynamics.arm', 'data.panda_stats',
             'data.panda_yardstick', 'scripts.panda_divergence', 'scripts.bench_panda_student',
             'scripts.plan_timing', 'data.panda_teacher_yardstick',
             'scripts.panda_teacher_divergence', 'scripts.bench_highdim',
             'data.distilled_panda_yardstick', 'scripts.distill_panda',
             'scripts.distill_panda_divergence'):
    assert pkg.__name__ + '.' + name in names, name
import chip_smoke  # as a module: main() does not run
loaded = [k for k, v in sys.modules.items() if v is not None
          and (k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'yaml',
                                   'mpc_via_diffusion_model_tpu'))]
assert not loaded, loaded
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", _GUARDED], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 67  # every module of the port


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|yaml|mpc_via_diffusion_model_tpu)\b(?!_torch)",
        re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert {"fused_unet.py", "fused_episode.py", "distillation.py", "teacher_stats.py",
            "fused_conv.py", "timing.py", "metrics.py", "flagship_stats.py", "bench_kernels.py",
            "flagship_parity.py", "episode_recut.py", "episode_profile.py", "bench.py",
            "bf16.py", "lqr.py", "generation.py", "lmpc_stats.py",
            "lmpc_parity.py", "losses.py", "datasets.py", "lmpc_train_yardstick.py",
            "trainer.py", "misc.py", "flagship_lmpc.py", "ilqr.py", "flagship_expert_yardstick.py",
            "flagship_run.py", "ilqr_divergence.py", "ilqr_profile.py", "ampc.py", "regression.py",
            "distill_yardstick.py", "distill_flagship.py", "distill_divergence.py",
            "train_ampc.py", "quadrotor.py", "quadrotor_task.py", "quadrotor_stats.py",
            "quadrotor_yardstick.py", "philox.py", "quadrotor_divergence.py",
            "bench_quadrotor_student.py", "conditions.py", "scene_stats.py",
            "scene_yardstick.py", "scene_divergence.py", "bench_scene_student.py",
            "guided_yardstick.py", "flagship_quadrotor.py", "scene_conditioned_quadrotor.py",
            "guided_divergence.py", "guided_profile.py", "onpolicy_scene.py",
            "scene_making_yardstick.py", "onpolicy_scene_yardstick.py",
            "scene_making_divergence.py", "arm.py", "panda_stats.py", "panda_yardstick.py",
            "panda_divergence.py", "bench_panda_student.py", "plan_timing.py",
            "panda_teacher_yardstick.py", "panda_teacher_divergence.py", "bench_highdim.py",
            "distilled_panda_yardstick.py", "distill_panda.py", "distill_panda_divergence.py"} <= {
                f.name for f in files}
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert not offenders
