"""The port's kernel build (ops/_build.py): which sources it builds, and
that a library's name changes with its source, with any header of
``csrc/`` and with the flags, so an edited header is never served by a
stale library. Nothing is compiled here."""
import shutil

import pytest

from mpc_via_diffusion_model_tpu_torch.ops import _build


def test_every_kernel_source_is_built():
    assert sorted(_build.KERNELS) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert {"unet_body.cuh", "plants.cuh", "episode.cuh"} <= {p.name for p in _build.CSRC.glob("*.cuh")}
    assert {"ddim_chain", "ddim_episode"} <= set(_build.KERNELS)


@pytest.mark.parametrize("edit", ["unet_body.cuh", "plants.cuh", "episode.cuh", "cfg_chain.cu",
                                  "ddim_chain.cu", "ddim_episode.cu", "flags"])
def test_library_name_follows_sources_headers_and_flags(tmp_path, monkeypatch, edit):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build._target(name) for name in _build.KERNELS}
    assert before == {name: _build._target(name) for name in _build.KERNELS}  # deterministic
    if edit == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    else:
        (csrc / edit).write_text((csrc / edit).read_text() + "\n// edited\n")
    after = {name: _build._target(name) for name in _build.KERNELS}
    changed = {name for name in _build.KERNELS if after[name] != before[name]}
    # a header may be included by any source: every library is rebuilt
    assert changed == ({edit[:-len(".cu")]} if edit.endswith(".cu") else set(_build.KERNELS))
