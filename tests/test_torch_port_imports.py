"""The PyTorch port and chip_smoke.py import neither jax, flax nor the JAX
package, so they run on a machine that has none of them."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mpc_via_diffusion_model_tpu_torch"

_GUARDED = """
import importlib, pkgutil, sys
# an entry of None makes any import of that name raise ImportError
sys.modules['jax'] = sys.modules['flax'] = sys.modules['mpc_via_diffusion_model_tpu'] = None
import mpc_via_diffusion_model_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
for name in ('ops.fused_unet', 'ops.fused_episode', 'ops.fused_denoise', 'ops._build',
             'dynamics.base', 'control.runtime', 'diffusion.distillation', 'data.teacher_stats',
             'ops.fused_conv', 'eval.timing', 'control.metrics', 'data.flagship_stats',
             'scripts.bench_kernels', 'scripts.flagship_parity', 'scripts.episode_recut',
             'scripts.episode_profile', 'bench', 'models.bf16', 'solvers.lqr',
             'data.generation', 'data.lmpc_stats', 'scripts.lmpc_parity'):
    assert pkg.__name__ + '.' + name in names, name
import chip_smoke  # as a module: main() does not run
loaded = [k for k, v in sys.modules.items() if v is not None
          and (k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mpc_via_diffusion_model_tpu'))]
assert not loaded, loaded
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", _GUARDED], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 35  # every module of the port


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|mpc_via_diffusion_model_tpu)\b(?!_torch)",
                         re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert {"fused_unet.py", "fused_episode.py", "distillation.py", "teacher_stats.py",
            "fused_conv.py", "timing.py", "metrics.py", "flagship_stats.py", "bench_kernels.py",
            "flagship_parity.py", "episode_recut.py", "episode_profile.py", "bench.py",
            "bf16.py", "lqr.py", "generation.py", "lmpc_stats.py",
            "lmpc_parity.py"} <= {f.name for f in files}
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert not offenders
