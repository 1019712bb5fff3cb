"""The port's kernel build (ops/_build.py): which sources it builds, and
that a library's name changes with its source, with any header of
``csrc/`` and with the flags, so an edited header is never served by a
stale library. Nothing is compiled here."""
import shutil

import pytest

from mpc_via_diffusion_model_tpu_torch.ops import _build


def test_every_kernel_source_is_built():
    assert sorted(_build.KERNELS) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert {"unet_body.cuh", "plants.cuh", "episode.cuh",
            "unet_body_cluster.cuh"} <= {p.name for p in _build.CSRC.glob("*.cuh")}
    assert {"ddim_chain", "ddim_episode", "fused_conv"} <= set(_build.KERNELS)


@pytest.mark.parametrize("edit", ["unet_body.cuh", "plants.cuh", "episode.cuh",
                                  "unet_body_cluster.cuh", "cfg_chain.cu",
                                  "ddim_chain.cu", "ddim_episode.cu", "fused_conv.cu", "flags"])
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


def test_sass_diff_parses_and_pairs_kernels_by_base_name():
    """``scripts/sass_diff.py`` (run on the card) reads ``cuobjdump -sass``
    output kernel by kernel and pairs each instantiation of a template with
    the other checkout's kernel of the same base name."""
    from mpc_via_diffusion_model_tpu_torch.scripts import sass_diff

    dump = lambda name, ops: "\n".join(
        [f"\t\tFunction : {name}", "\t.headerflags @\"EF_CUDA_SM90\""]
        + [f"        /*{16 * i:04x}*/                   {op} ;   /* 0x000fe2000 */"
           for i, op in enumerate(ops)]) + "\n"
    ours = sass_diff.parse_sass(
        dump("_Z16cfg_chain_kernelIfEvPKf", ["MOV R1, c[0x0][0x28]", "EXIT"])
        + dump("_Z16cfg_chain_kernelI13__nv_bfloat16EvPKf", ["MOV R1, c[0x0][0x28]", "NOP", "EXIT"]))
    theirs = sass_diff.parse_sass(dump("_Z16cfg_chain_kernelPKfPKi", ["MOV R1, c[0x0][0x28]", "EXIT"]))
    assert ours["_Z16cfg_chain_kernelIfEvPKf"] == ["MOV R1, c[0x0][0x28]", "EXIT"]
    assert sass_diff.base_name("_Z16cfg_chain_kernelI13__nv_bfloat16EvPKf") == "cfg_chain_kernel"
    rows = {r["kernel"]: r for r in sass_diff.compare(ours, theirs)}
    assert rows["_Z16cfg_chain_kernelIfEvPKf"]["identical"] is True
    bf16 = rows["_Z16cfg_chain_kernelI13__nv_bfloat16EvPKf"]
    assert (bf16["identical"], bf16["differ_in_place"], bf16["other_instructions"]) == (False, 1, 2)
    # an instantiation the other checkout has too is paired with its own
    theirs_t = sass_diff.parse_sass(
        dump("_Z16cfg_chain_kernelIfEvPKf", ["MOV R1, c[0x0][0x28]", "NOP", "NOP", "EXIT"])
        + dump("_Z16cfg_chain_kernelI13__nv_bfloat16EvPKf", ["MOV R1, c[0x0][0x28]", "NOP", "EXIT"]))
    rows = {r["kernel"]: r for r in sass_diff.compare(ours, theirs_t)}
    assert rows["_Z16cfg_chain_kernelI13__nv_bfloat16EvPKf"]["identical"] is True
    assert rows["_Z16cfg_chain_kernelIfEvPKf"]["other_instructions"] == 4


def test_shared_memory_records_are_private_to_each_library():
    """Each launcher's record of the shared-memory attribute it set
    (``reserve_smem``'s ``set``) has internal linkage: a template's static
    member of external linkage is unified across every library the process
    loads, so one library's record would stop another from raising its own
    kernel's limit (the CFG chain, the CFG episode and its linear cart-pole
    entry all instantiate ``SmemSet<float>``)."""
    import re

    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for record in re.finditer(r"^(static int smem_set|struct SmemSet|  static int smem_set)",
                                  text, flags=re.M):
            before = text[:record.start()]
            private = (record.group(1).lstrip().startswith("static int")
                       or before.rfind("namespace {") > before.rfind("}  // namespace"))
            assert private, f"{src.name}: {record.group(1)} has external linkage"
